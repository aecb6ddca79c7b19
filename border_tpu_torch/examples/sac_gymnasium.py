"""SAC (continuous control) trained on REAL external Gymnasium envs
(≙ examples/sac_gymnasium.py).

≙ the reference's sac_pendulum example end to end
(examples/gym/sac_pendulum/src/main.rs + the GymEnv training path,
border-py-gym-env/src/base.rs:268-340): float actions flow host-ward
through :class:`border_tpu_torch.envs.PyVecEnv`, external envs step in
host threads behind :class:`HostEnvTrainer`'s pipeline, and the card runs
the SAC update bursts.  Dict-obs envs (robotics style) are flattened
built-in by PyVecEnv.

    python -m border_tpu_torch.examples.sac_gymnasium --env Pendulum-v1 --max-opts 20000
"""

import argparse

from border_tpu_torch.agents import SAC, SACConfig
from border_tpu_torch.envs import PyVecEnv
from border_tpu_torch.examples import add_device
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="Pendulum-v1")
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--max-opts", type=int, default=20_000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--max-episode-steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    add_device(p)
    return p


def build(args) -> dict:
    if args.cpu:
        args.device = "cpu"
    return {
        # the buffer first: without the device no host env is started
        "buffer": ReplayBuffer(65_536, device=args.device),
        "env": PyVecEnv.gym(args.env, args.num_envs, seed=args.seed),
        "agent": SAC(SACConfig(actor_hidden=(128, 128), critic_hidden=(128, 128),
                               n_critics=2, actor_lr=args.lr, critic_lr=args.lr,
                               ent_coef_mode="auto")),
        "config": TrainerConfig(
            max_opts=args.max_opts, warmup_period=1_000, opt_interval=8,
            batch_size=args.batch_size, num_envs=args.num_envs,
            steps_per_chunk=32, eval_interval=max(args.max_opts // 10, 1),
            seed=args.seed,
        ),
        "recorder": BufferedRecorder(),
        "evaluator": HostEvaluator(
            lambda n, seed: PyVecEnv.gym(args.env, n, seed=seed),
            n_episodes=10, max_steps=args.max_episode_steps,
        ),
    }


def run(args, objs):
    trainer = HostEnvTrainer(objs["env"], objs["agent"], objs["buffer"],
                             objs["config"], recorder=objs["recorder"],
                             evaluator=objs["evaluator"], device=args.device)
    res = trainer.train()
    trainer.env.close()
    print(f"best eval return: {res.best_score:+.1f}  "
          f"({res.env_steps:,} env steps, {res.opt_steps:,} updates, "
          f"{res.samples_per_sec:,.0f} samples/s)")
    for step, score in res.eval_history:
        print(f"  opt {step:>8d}: {score:+.1f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
