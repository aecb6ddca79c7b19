"""IQN on Seaquest — the reference's distributional-RL parity config
(≙ examples/iqn_seaquest.py).

≙ the IQN Atari setup (border-tch-agent/src/iqn/config.rs:56-60): Uniform8
pred/tgt τ-samples, Const32 for acting, quantile Huber loss, CNN ψ feature
extractor (AtariCNN skip_linear ≙ cnn/base.rs skip_linear variant).
"""

import argparse
import functools

from border_tpu_torch.agents import IQN, IQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--env", type=str, default="Seaquest-v0")
    p.add_argument("--max-opts", type=int, default=100_000)
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--opt-interval", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_iqn"))
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    agent = IQN(
        IQNConfig(
            psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True),
            feature_dim=512,
            n_cos=64,
            hidden=(512,),
            sample_percents_pred="uniform8",
            sample_percents_tgt="uniform8",
            sample_percents_act="const32",
            lr=args.lr,
            soft_update_interval=2_000,
            tau=1.0,
            eps_final_step=2_000_000,
        )
    )
    return {
        "env": make(args.env),
        "agent": agent,
        "buffer": FrameReplayBuffer(capacity=512, num_envs=args.num_envs,
                                    device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts,
            warmup_period=50_000,
            opt_interval=args.opt_interval,
            batch_size=args.batch_size,
            num_envs=args.num_envs,
            steps_per_chunk=32,
            eval_interval=5_000,
            eval_episodes=10,
            seed=args.seed,
        ),
        "recorder": BufferedRecorder(model_dir=args.out),
        "evaluator": Evaluator(make(args.env, train=False), n_episodes=10,
                               max_steps=3_000, device=args.device),
    }


def run(args, objs):
    result = Trainer(objs["env"], objs["agent"], objs["buffer"],
                     objs["config"], objs["recorder"], objs["evaluator"],
                     device=args.device).train()
    print("=== done ===")
    print(f"opt_steps={result.opt_steps} samples/s={result.samples_per_sec:,.0f}")
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
