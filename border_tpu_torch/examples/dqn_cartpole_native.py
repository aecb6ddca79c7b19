"""DQN on the native C++ envpool CartPole — the host-env architecture
(≙ examples/dqn_cartpole_native.py).

≙ the reference's Atari path: C++ envs on host threads feeding a device
learner (border-atari-env/src/atari_env/ale.rs:62-100 + actor threads,
border-async-trainer/src/actor/base.rs:120-178).  The C++ pool steps
``--num-envs`` CartPole instances in worker threads while the card runs the
update burst; ``host_wait_frac`` in the records shows how much host env
time the pipeline actually hides.
"""

import argparse

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--max-opts", type=int, default=5_000)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--opt-interval", type=int, default=16)
    p.add_argument("--n-threads", type=int, default=0, help="0 = auto")
    p.add_argument("--out", type=str, default=tmp_path("border_tpu_native"))
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    return {
        "agent": DQN(DQNConfig(hidden=(64, 64), lr=1e-3, tau=0.01,
                               soft_update_interval=1, double_dqn=True,
                               eps_final_step=50_000)),
        "buffer": ReplayBuffer(16_384, device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts, warmup_period=1_000,
            opt_interval=args.opt_interval, batch_size=64,
            num_envs=args.num_envs, steps_per_chunk=16,
            eval_interval=1_000, seed=args.seed,
        ),
        "recorder": BufferedRecorder(model_dir=args.out),
        "evaluator": HostEvaluator("CartPole-v1", n_episodes=5, max_steps=500),
    }


def run(args, objs):
    recorder = objs["recorder"]
    trainer = HostEnvTrainer(
        "CartPole-v1", objs["agent"], objs["buffer"], objs["config"],
        recorder=recorder, evaluator=objs["evaluator"],
        n_threads=args.n_threads or None, device=args.device,
    )
    res = trainer.train()
    print(f"best eval return={res.best_score:.1f}  "
          f"samples/s={res.samples_per_sec:,.0f}")
    waits = [
        r.get_scalar(k)
        for r in recorder.records
        for k, _ in r
        if k.startswith("host_wait_frac_mean")
    ]
    if waits:
        print(f"host env wait fraction (mean of means): "
              f"{sum(waits)/len(waits):.3f}")
    for step, score in res.eval_history:
        print(f"  opt {step:>6d}: eval return {score:+.1f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
