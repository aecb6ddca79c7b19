"""SAC on the dict-observation goal-reaching env — the FetchReach parity
config (≙ examples/sac_reacher.py).

≙ examples/gym/sac_fetch_reach: a robotics-style env whose observations
are a Dict {observation, achieved_goal, desired_goal}
(border-py-gym-env's candle dict-obs converters, src/candle/*): here the
batched on-device Reacher exposes the same dict space and
FlattenDictWrapper concatenates it for the MLP actor/critics (≙ the
converter's flattening).
"""

import argparse

from border_tpu_torch.agents import SAC, SACConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=20_000)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_reacher"))
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    env = make("ReacherFlat-v0")  # Dict obs flattened for the MLP nets
    return {
        "env": env,
        "agent": SAC(SACConfig(actor_hidden=(128, 128), critic_hidden=(128, 128),
                               n_critics=2, ent_coef_mode="auto")),
        "buffer": ReplayBuffer(65_536, device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts, warmup_period=1_000, opt_interval=16,
            batch_size=128, num_envs=args.num_envs, steps_per_chunk=32,
            eval_interval=2_000, seed=args.seed,
        ),
        "recorder": BufferedRecorder(model_dir=args.out),
        "evaluator": Evaluator(env, n_episodes=10, max_steps=100,
                               device=args.device),
    }


def run(args, objs):
    res = Trainer(objs["env"], objs["agent"], objs["buffer"], objs["config"],
                  objs["recorder"], objs["evaluator"],
                  device=args.device).train()
    print(f"best eval return={res.best_score:.2f}  "
          f"samples/s={res.samples_per_sec:,.0f}")
    for step, score in res.eval_history:
        print(f"  opt {step:>6d}: eval return {score:+.2f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
