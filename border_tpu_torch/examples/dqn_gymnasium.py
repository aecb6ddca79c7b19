"""DQN trained on REAL external Gymnasium environments (PyVecEnv)
(≙ examples/dqn_gymnasium.py).

≙ the reference's border-py-gym-env training path
(border-py-gym-env/src/base.rs:268-340; examples/gym/dqn_cartpole): the
reference drives Gymnasium through embedded CPython from its actor
threads; here N ``gymnasium.make`` envs run behind
:class:`border_tpu_torch.envs.PyVecEnv` on the host-env interface, feeding
the learner on the card through :class:`HostEnvTrainer`'s pipeline.
Works with any Gymnasium env whose spaces map to Box/Discrete.

    python -m border_tpu_torch.examples.dqn_gymnasium --env CartPole-v1 --max-opts 2000
"""

import argparse

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import PyVecEnv
from border_tpu_torch.examples import add_device
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="CartPole-v1")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--max-opts", type=int, default=2_000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    return {
        # the buffer first: without the device no host env is started
        "buffer": ReplayBuffer(50_000, device=args.device),
        "env": PyVecEnv.gym(args.env, args.num_envs, seed=args.seed),
        "agent": DQN(DQNConfig(hidden=(64, 64), lr=args.lr, double_dqn=True,
                               eps_final_step=8 * args.max_opts)),
        "config": TrainerConfig(
            max_opts=args.max_opts, warmup_period=500, opt_interval=8,
            batch_size=args.batch_size, num_envs=args.num_envs,
            steps_per_chunk=16, eval_interval=max(args.max_opts // 5, 1),
            seed=args.seed,
        ),
        "recorder": BufferedRecorder(),
        "evaluator": HostEvaluator(
            lambda n, seed: PyVecEnv.gym(args.env, n, seed=seed),
            n_episodes=5, max_steps=1_000,
        ),
    }


def run(args, objs):
    trainer = HostEnvTrainer(
        objs["env"], objs["agent"], objs["buffer"], objs["config"],
        recorder=objs["recorder"], evaluator=objs["evaluator"],
        device=args.device,
    )
    res = trainer.train()
    trainer.env.close()
    print(f"best eval return {res.best_score:.1f}  "
          f"samples/s {res.samples_per_sec:,.0f}  "
          f"opt/s {res.opt_per_sec:.1f}")
    for opt, score in res.eval_history:
        print(f"  opt {opt:>8d}: {score:+.1f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
