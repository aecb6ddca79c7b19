"""Offline RL (BC / AWAC / IQL) on a collected Pendulum corpus
(≙ examples/offline_pendulum.py).

≙ examples/d4rl/{bc,awac,iql}_pen: dataset → replay buffer → train_offline →
normalized-score evaluation (border-minari/src/evaluator.rs:26-63).  The
corpus is synthesized locally (a mediocre SAC policy's rollouts);
``--dataset`` loads any .npz corpus instead, or names where the
synthesized one is written.
"""

import argparse
import os

from border_tpu_torch.agents import AWAC, AWACConfig, BC, BCConfig, IQL, IQLConfig, SAC, SACConfig
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.data import (NormalizedEvaluator, OfflineDataset,
                                   collect_dataset, normalized_score)
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device, tmp_path
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import OfflineTrainer, Trainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache

# Pendulum score range for normalized-score reporting (D4RL convention):
REF_MIN, REF_MAX = -1600.0, -150.0


def corpus_config(seed: int) -> TrainerConfig:
    """The behavior policy's training run."""
    return TrainerConfig(
        max_opts=3_000, warmup_period=1_000, opt_interval=16, batch_size=128,
        num_envs=64, steps_per_chunk=32, eval_interval=10**9, seed=seed,
    )


def build_corpus(path: str, n_steps: int, seed: int, device,
                 config: TrainerConfig = None) -> OfflineDataset:
    """Train a quick SAC behavior policy (``config``, default
    :func:`corpus_config`), then record its rollouts."""
    env = make("Pendulum-v1")
    agent = SAC(SACConfig(actor_hidden=(64, 64), critic_hidden=(64, 64)))
    tr = Trainer(env, agent, ReplayBuffer(capacity=65_536, device=device),
                 config or corpus_config(seed), device=device)
    res = tr.train()
    ds = collect_dataset(env, agent, res.agent_state, n_steps=n_steps,
                         num_envs=64, seed=seed, device=device)
    ds.save_npz(path)
    return ds


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", choices=["bc", "awac", "iql"], default="iql")
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--corpus-steps", type=int, default=200_000)
    p.add_argument("--max-opts", type=int, default=30_000)
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    env = make("Pendulum-v1")
    vec = VecEnv(env, 1, device=args.device)
    if args.dataset and os.path.exists(args.dataset):
        ds = OfflineDataset.from_npz(args.dataset)
    else:
        path = args.dataset or tmp_path("pendulum_corpus.npz")
        print(f"building behavior corpus → {path}")
        ds = build_corpus(path, args.corpus_steps, args.seed, args.device)
    print(f"dataset: {len(ds)} transitions")

    buffer = ReplayBuffer(capacity=max(262_144, 1 << (len(ds) - 1).bit_length()),
                          device=args.device)
    if args.algo == "bc":
        agent = BC(BCConfig(hidden=(256, 256)))
    elif args.algo == "awac":
        agent = AWAC(AWACConfig())
    else:
        agent = IQL(IQLConfig())
    return {
        "buffer": buffer,
        "buffer_state": ds.to_replay_buffer(buffer),
        "agent": agent,
        "agent_state": agent.init(args.seed, vec.observation_space,
                                  vec.action_space, device=args.device),
        "config": TrainerConfig(max_opts=args.max_opts, batch_size=256,
                                eval_interval=5_000, seed=args.seed),
        "evaluator": NormalizedEvaluator(
            env, n_episodes=10, max_steps=200, ref_min=REF_MIN,
            ref_max=REF_MAX, device=args.device),
    }


def run(args, objs):
    tr = OfflineTrainer(objs["agent"], objs["buffer"], objs["config"],
                        recorder=BufferedRecorder(),
                        evaluator=objs["evaluator"], updates_per_chunk=500)
    res = tr.train(objs["agent_state"], objs["buffer_state"])
    print(f"{args.algo}: best eval return={res.best_score:.1f}  "
          f"opt/s={res.opt_per_sec:,.0f}")
    for step, score in res.eval_history:
        print(f"  opt {step:>6d}: return {score:+.1f}  "
              f"normalized {normalized_score(score, REF_MIN, REF_MAX):.1f}")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
