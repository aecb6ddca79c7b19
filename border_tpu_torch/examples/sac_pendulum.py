"""SAC on Pendulum-v1 — continuous-control parity config
(≙ examples/sac_pendulum.py).

≙ examples/gym/sac_pendulum: squashed Gaussian actor, 2-critic min-Q,
automatic entropy tuning.
"""

import argparse

from border_tpu_torch.agents import SAC, SACConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.record import BufferedRecorder, TensorboardRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=20_000)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--opt-interval", type=int, default=16)
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_sac"))
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    env = make("Pendulum-v1")
    return {
        "env": env,
        "agent": SAC(
            SACConfig(
                actor_hidden=(128, 128),
                critic_hidden=(128, 128),
                n_critics=2,
                actor_lr=3e-4,
                critic_lr=3e-4,
                ent_coef_mode="auto",
            )
        ),
        "buffer": ReplayBuffer(capacity=65_536, device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts,
            warmup_period=1_000,
            opt_interval=args.opt_interval,
            batch_size=128,
            num_envs=args.num_envs,
            steps_per_chunk=32,
            eval_interval=2_000,
            eval_episodes=5,
            seed=args.seed,
        ),
        "recorder": (
            TensorboardRecorder(args.out)
            if args.tensorboard
            else BufferedRecorder(model_dir=args.out)
        ),
        "evaluator": Evaluator(env, n_episodes=5, max_steps=200,
                               device=args.device),
    }


def run(args, objs):
    result = Trainer(objs["env"], objs["agent"], objs["buffer"],
                     objs["config"], objs["recorder"], objs["evaluator"],
                     device=args.device).train()
    objs["recorder"].close()
    print(f"best eval return={result.best_score:.1f}  "
          f"samples/s={result.samples_per_sec:,.0f}")
    for step, score in result.eval_history:
        print(f"  opt {step:>6d}: eval return {score:+.1f}")
    return result


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
