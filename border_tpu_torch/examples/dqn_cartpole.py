"""DQN on CartPole-v1 — the reference's first parity config
(≙ examples/dqn_cartpole.py).

≙ examples/gym/dqn_cartpole (main.rs:38-53): 10k opt steps, batch 64,
lr 1e-3, γ 0.99, τ 0.01, replay 10k, warmup 100, eval every 1k (5 episodes).

``--agent-config agent.yaml`` builds the agent from YAML
(≙ Configurable::build_from_path); ``--mlflow URI`` tracks the run and logs
the whole config tree as params (≙ main.rs:122-125).  ``--resume`` restores
the latest full-state checkpoint from ``--out`` and continues bit-exactly.
"""

import argparse
import os

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.record import BufferedRecorder, TensorboardRecorder
from border_tpu_torch.replay import PerConfig, ReplayBuffer
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=10_000)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--opt-interval", type=int, default=16)
    p.add_argument("--per", action="store_true")
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_cartpole"))
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--mlflow", type=str, default="", help="MLflow tracking URI")
    p.add_argument("--agent-config", type=str, default="", help="agent YAML")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint under --out")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="full-state checkpoint cadence in opt steps")
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def default_agent() -> DQN:
    return DQN(
        DQNConfig(
            hidden=(64, 64),
            lr=1e-3,
            gamma=0.99,
            tau=0.01,
            soft_update_interval=1,
            double_dqn=True,
            eps_final_step=50_000,
        )
    )


def build(args) -> dict:
    env = make("CartPole-v1")
    if args.agent_config:
        from border_tpu_torch.utils import build_agent_from_path

        agent = build_agent_from_path(args.agent_config)
    else:
        agent = default_agent()
    config = TrainerConfig(
        max_opts=args.max_opts,
        warmup_period=1_000,
        opt_interval=args.opt_interval,
        batch_size=64,
        num_envs=args.num_envs,
        steps_per_chunk=32,
        eval_interval=1_000,
        eval_episodes=5,
        seed=args.seed,
    )
    buffer = ReplayBuffer(capacity=16_384, per=PerConfig() if args.per else None,
                          device=args.device)
    if args.mlflow:
        from border_tpu_torch.record.mlflow import MlflowClient, MlflowRecorder

        recorder = MlflowRecorder(
            MlflowClient(args.mlflow), "border_tpu", run_name="dqn_cartpole"
        )
        # whole config tree → MLflow params (≙ main.rs:122-125)
        recorder.log_params(
            {"trainer": config, "agent": agent.config, "env": "CartPole-v1"}
        )
    elif args.tensorboard:
        recorder = TensorboardRecorder(args.out)
    else:
        recorder = BufferedRecorder(model_dir=args.out)
    ckpt = None
    if args.resume or args.checkpoint_interval:
        from border_tpu_torch.utils import CheckpointManager

        ckpt = CheckpointManager(os.path.join(args.out, "ckpt"),
                                 device=args.device)
    return {
        "env": env,
        "agent": agent,
        "buffer": buffer,
        "config": config,
        "recorder": recorder,
        "evaluator": Evaluator(env, n_episodes=5, max_steps=500,
                               device=args.device),
        "checkpoint_manager": ckpt,
    }


def run(args, objs):
    ckpt = objs["checkpoint_manager"]
    trainer = Trainer(
        objs["env"], objs["agent"], objs["buffer"], objs["config"],
        objs["recorder"], objs["evaluator"],
        checkpoint_manager=ckpt, checkpoint_interval=args.checkpoint_interval,
        device=args.device,
    )
    result = trainer.train(resume_from=ckpt if args.resume else None)
    objs["recorder"].close()
    print(f"best eval return={result.best_score:.1f}  "
          f"samples/s={result.samples_per_sec:,.0f}")
    for step, score in result.eval_history:
        print(f"  opt {step:>6d}: eval return {score:.1f}")
    return result


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
