"""Train → export → run backend-free: the deployment path
(≙ examples/convert_policy.py).

≙ the reference's convert_policy + pendulum_std pair
(examples/gym/convert_policy/src/main.rs:1-235 converts a trained tch SAC
policy to the dependency-free Mat/Mlp bincode format;
examples/gym/pendulum_std/src/main.rs:115-173 runs it with zero DL
backend).  Here: SAC trains briefly on Pendulum, ``export_policy`` writes
policy.npz + policy.json (the JAX package's artifact), ``NumpyMLPPolicy``
reloads them, and the episode rollout runs **numpy-only inference against
the native C++ envpool** — no torch anywhere in the deployed loop.
"""

import argparse
import os

import numpy as np

from border_tpu_torch.agents import SAC, SACConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import (NumpyMLPPolicy, enable_compilation_cache,
                                    export_policy)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=20_000)
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_convert"))
    p.add_argument("--episodes", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    env = make("Pendulum-v1")
    return {
        "env": env,
        "agent": SAC(SACConfig(actor_hidden=(64, 64), critic_hidden=(64, 64),
                               ent_coef_mode="auto")),
        "buffer": ReplayBuffer(65_536, device=args.device),
        "config": TrainerConfig(max_opts=args.max_opts, warmup_period=1_000,
                                opt_interval=16, batch_size=128, num_envs=128,
                                steps_per_chunk=32, eval_interval=2_000,
                                seed=args.seed),
        "evaluator": Evaluator(env, 5, 200, device=args.device),
    }


def run(args, objs):
    """Returns the deployed episodes' returns (None without the native
    envpool)."""
    # 1. train (≙ the tch SAC pendulum training the reference converts)
    agent = objs["agent"]
    res = Trainer(objs["env"], agent, objs["buffer"], objs["config"],
                  evaluator=objs["evaluator"], device=args.device).train()
    print(f"trained: best eval return {res.best_score:.1f}")

    # 2. convert (≙ convert_policy main.rs: varstore → Mat/Mlp → bincode)
    path = export_policy(agent, res.agent_state, args.out)
    print("exported:", sorted(os.listdir(path)))

    # 3. deploy: numpy-only inference on the native C++ envs
    #    (≙ pendulum_std main.rs:115-173 — zero DL backend in the loop)
    policy = NumpyMLPPolicy(path)
    from border_tpu_torch.envs.native import NativeVecEnv, native_available

    if not native_available():
        print("native envpool unavailable; skipping deployment rollout")
        return None
    native = NativeVecEnv("Pendulum-v1", args.episodes, seed=args.seed)
    n_bins = native.num_actions
    obs = native.reset()
    returns = np.zeros(args.episodes)
    running = np.ones(args.episodes, bool)
    for _ in range(200):
        u = policy(obs)  # numpy forward, [N, 1] torque in [-2, 2]
        bins = np.clip(
            np.round((u[:, 0] + 2.0) / 4.0 * (n_bins - 1)), 0, n_bins - 1
        ).astype(np.int32)
        obs, rew, term, trunc = native.step(bins)
        returns += rew * running
        running &= ~(term | trunc)
    native.close()
    print(f"numpy-only deployment on C++ envs: mean return "
          f"{returns.mean():.1f} over {args.episodes} episodes "
          f"(binned torque, {n_bins} levels)")
    return returns


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
