"""DQN-Pong on the host-native C++ pixel envpool — the reference's actual
Atari architecture at pixel scale (≙ examples/dqn_pong_host.py).

≙ border-atari-env's C++ ALE behind actor threads feeding the learner
(ale.rs:62-100 + actor/base.rs:120-178): ``--num-envs`` 84×84 uint8
PixelPong instances step in C++ worker threads; only the newest frame of
each env crosses host→device per step (7 KB/env), the device maintains the
stack ring, and the frame-dedup replay stores each frame once (sampled
through the CUDA frame-gather kernel).  ``host_wait_frac`` in the output
shows how much of the host env time the pipeline hides.

    python -m border_tpu_torch.examples.dqn_pong_host --num-envs 256 --max-opts 40000
"""

import argparse

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.examples import add_device
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--max-opts", type=int, default=40_000)
    p.add_argument("--capacity", type=int, default=1_024,
                   help="per-env replay slots (256×1024 = the reference's "
                        "262,144-transition Atari replay)")
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    return {
        "agent": DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n), lr=1e-4,
                               double_dqn=True, soft_update_interval=2_000,
                               tau=1.0, eps_final_step=1_000_000)),
        "buffer": FrameReplayBuffer(capacity=args.capacity,
                                    num_envs=args.num_envs, device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts, warmup_period=50_000, opt_interval=64,
            batch_size=512, num_envs=args.num_envs, steps_per_chunk=32,
            eval_interval=2_000, seed=args.seed,
        ),
        "recorder": BufferedRecorder(),
        "evaluator": HostEvaluator("Pong-v0", n_episodes=5, max_steps=3_000),
    }


def run(args, objs):
    rec = objs["recorder"]
    trainer = HostEnvTrainer("Pong-v0", objs["agent"], objs["buffer"],
                             objs["config"], recorder=rec,
                             evaluator=objs["evaluator"], device=args.device)
    res = trainer.train()
    waits = [v for r in rec.records for k, v in r if k == "host_wait_frac"]
    print(f"best eval return {res.best_score:+.1f}  "
          f"samples/s {res.samples_per_sec:,.0f}  "
          f"host_wait_frac {sum(waits)/max(len(waits),1):.3f}")
    for opt, score in res.eval_history:
        print(f"  opt {opt:>8d}: {score:+.1f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
