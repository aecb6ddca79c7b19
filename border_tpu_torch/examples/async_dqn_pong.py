"""Decoupled actor-learner DQN on Pong — Border's async semantics
(≙ examples/async_dqn_pong.py).

≙ examples/atari/dqn_atari_async_tch via border-async-trainer: actors
sample with *stale* policy params refreshed every ``--sync-interval``
optimizer steps (SyncModel, border-async-trainer/src/sync_model.rs:1-13),
letting the update:sample ratio float — unlike the synchronous Trainer
(``dqn_pong``) which pins it.  Here the actor phase acts on its own copy
of the policy and the learner burst updates the online networks, both on
the card.
"""

import argparse

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import AsyncTrainer, Evaluator, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=50_000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--opt-interval", type=int, default=64)
    p.add_argument("--sync-interval", type=int, default=512,
                   help="actor param refresh cadence in opt steps "
                        "(≙ AsyncTrainerConfig::sync_interval)")
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_async_pong"))
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    return {
        "env": make("Pong-v0"),
        "agent": DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n), lr=1e-4,
                               double_dqn=True, soft_update_interval=2_000,
                               tau=1.0, eps_final_step=2_000_000)),
        "buffer": FrameReplayBuffer(capacity=512, num_envs=args.num_envs,
                                    device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts, warmup_period=50_000,
            opt_interval=args.opt_interval, batch_size=args.batch_size,
            num_envs=args.num_envs, steps_per_chunk=32,
            eval_interval=2_000, sync_interval=args.sync_interval,
            seed=args.seed,
        ),
        "recorder": BufferedRecorder(model_dir=args.out),
        "evaluator": Evaluator(make("Pong-v0", train=False), n_episodes=5,
                               max_steps=3_000, device=args.device),
    }


def run(args, objs):
    res = AsyncTrainer(objs["env"], objs["agent"], objs["buffer"],
                       objs["config"], objs["recorder"], objs["evaluator"],
                       device=args.device).train()
    print(f"best eval return={res.best_score:+.1f}  "
          f"samples/s={res.samples_per_sec:,.0f}  "
          f"opt/s={res.opt_per_sec:,.1f}")
    for step, score in res.eval_history:
        print(f"  opt {step:>8d}: eval return {score:+.1f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
