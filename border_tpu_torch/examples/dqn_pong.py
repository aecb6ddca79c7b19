"""DQN on the pixel games — the flagship pixel-env config
(≙ examples/dqn_pong.py).

≙ examples/atari/dqn_atari_tch (sync) /dqn_atari_async_tch (async) in the
reference: DQN-paper CNN, frame-skip-4 + max-pool + 84×84 gray + stack-4 +
sign reward clip (border-atari-env/src/env.rs:126-199), double DQN, hard
target swap every 10k updates (τ=1.0, dqn_atari_async_tch/src/config.rs:59-119)
— rebuilt as the chunked vectorized trainer, every replay sample read
through the CUDA frame-gather kernel.  ``--env`` selects any of the five
on-device games (Pong/Breakout/Seaquest/Freeway/SpaceInvaders).

Usage:
  python -m border_tpu_torch.examples.dqn_pong --max-opts 100000 --num-envs 1024
  python -m border_tpu_torch.examples.dqn_pong --env SpaceInvaders-v0 --n-step 3
"""

import argparse
import json
import time

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.record import BufferedRecorder, TensorboardRecorder
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache

# the learning gate's Pong target (benchmarks/learning.py); the other games'
# curves carry no target
PONG_TARGET = 18.0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=100_000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--opt-interval", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eps-final-step", type=int, default=2_000_000)
    p.add_argument("--capacity-per-env", type=int, default=256)
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_pong"))
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--eval-interval", type=int, default=5_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--env",
        type=str,
        default="Pong-v0",
        choices=["Pong-v0", "Breakout-v0", "Seaquest-v0", "Freeway-v0",
                 "SpaceInvaders-v0"],
        help="any of the five on-device pixel games (≙ the reference's "
             "single dqn_atari binary × ROM name, examples/atari/dqn_atari)",
    )
    p.add_argument(
        "--n-step", type=int, default=1,
        help="n-step backups (sparse-reward games: Freeway/SpaceInvaders "
             "train with 3)",
    )
    p.add_argument(
        "--curve-out",
        type=str,
        default="",
        help="path of a JSON learning-curve artifact, rewritten after every eval",
    )
    add_device(p)
    return p


def build(args) -> dict:
    agent = DQN(
        DQNConfig(
            model=lambda n: AtariCNN(out_dim=n),
            lr=args.lr,
            double_dqn=True,
            loss="smooth_l1",
            eps_start=1.0,
            eps_final=0.02,
            eps_final_step=args.eps_final_step,
            soft_update_interval=2_000,
            tau=1.0,  # hard swap (≙ async config soft_update_interval 10k, τ=1)
        )
    )
    config = TrainerConfig(
        max_opts=args.max_opts,
        warmup_period=50_000,
        opt_interval=args.opt_interval,
        batch_size=args.batch_size,
        num_envs=args.num_envs,
        steps_per_chunk=32,
        eval_interval=args.eval_interval,
        eval_episodes=10,
        flush_record_interval=1_000,
        seed=args.seed,
    )
    buffer = FrameReplayBuffer(capacity=args.capacity_per_env,
                               num_envs=args.num_envs, n_step=args.n_step,
                               device=args.device)
    if args.tensorboard:
        recorder = TensorboardRecorder(args.out)
    else:
        recorder = BufferedRecorder(model_dir=args.out)
    return {
        "env": make(args.env),  # train mode: sign reward clip
        "agent": agent,
        "buffer": buffer,
        "config": config,
        "recorder": recorder,
        # raw scores for eval
        "evaluator": Evaluator(make(args.env, train=False), n_episodes=10,
                               max_steps=3_000, device=args.device),
    }


def curve_json(args, curve) -> dict:
    """The ``--curve-out`` document: the game this run trained on, and the
    gate's target only where there is one (Pong)."""
    return {
        "env": args.env,
        "agent": "DQN+AtariCNN",
        "target": PONG_TARGET if args.env == "Pong-v0" else None,
        "seed": args.seed,
        "config": {
            "max_opts": args.max_opts,
            "num_envs": args.num_envs,
            "batch_size": args.batch_size,
            "opt_interval": args.opt_interval,
            "lr": args.lr,
            "eps_final_step": args.eps_final_step,
        },
        "curve": curve,
    }


def run(args, objs):
    curve = []
    t_start = time.time()

    def on_eval(opt_steps, env_steps, score, best_score):
        curve.append(
            {
                "opt_steps": int(opt_steps),
                "env_steps": int(env_steps),
                "eval_return": float(score),
                "best": float(best_score),
                "wall_sec": round(time.time() - t_start, 1),
            }
        )
        print(
            f"[eval] opt {opt_steps:>8d} env {env_steps:>10d} "
            f"return {score:+.1f} best {best_score:+.1f}",
            flush=True,
        )
        if args.curve_out:
            with open(args.curve_out, "w") as f:
                json.dump(curve_json(args, curve), f, indent=1)

    trainer = Trainer(
        objs["env"], objs["agent"], objs["buffer"], objs["config"],
        recorder=objs["recorder"], evaluator=objs["evaluator"],
        eval_callback=on_eval, device=args.device,
    )

    result = trainer.train()
    objs["recorder"].close()
    print("=== done ===")
    print(f"opt_steps={result.opt_steps} env_steps={result.env_steps}")
    print(f"samples/s={result.samples_per_sec:,.0f} opt/s={result.opt_per_sec:,.1f}")
    print(f"best eval return={result.best_score:.1f}")
    for step, score in result.eval_history:
        print(f"  opt {step:>8d}: eval return {score:+.1f}")
    return result


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
