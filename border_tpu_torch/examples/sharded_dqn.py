"""Multi-GPU actor-learner DQN — the async-trainer parity config
(≙ examples/sharded_dqn.py).

≙ examples/atari/dqn_atari_async_tch (train_async with N actors + 1
learner): here the actor fleet is the ranks of the process group, each
stepping its env shard and averaging gradients over the group.  Run
without a launcher it is a world of one rank; under ``torchrun`` it joins
the launcher's group (one rank per GPU over NCCL, or ``--device cpu`` over
gloo):

  python -m border_tpu_torch.examples.sharded_dqn --env CartPole-v1
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m border_tpu_torch.examples.sharded_dqn --device cpu
"""

import argparse

import torch.distributed as dist

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device
from border_tpu_torch.parallel import ShardedTrainer, init_distributed, make_mesh
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Evaluator, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--env", type=str, default="CartPole-v1")
    p.add_argument("--max-opts", type=int, default=5_000)
    p.add_argument("--envs-per-device", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    """Joins the process group first (a world of one without a launcher;
    ``objs["own_group"]``: this call made it)."""
    own_group = not dist.is_initialized()
    if own_group:
        init_distributed(device=args.device)
    n = dist.get_world_size()
    env = make(args.env)
    return {
        "env": env,
        "agent": DQN(DQNConfig(double_dqn=True, lr=1e-3, tau=0.01,
                               eps_final_step=50_000)),
        "buffer": ReplayBuffer(capacity=16_384, device=args.device),
        "config": TrainerConfig(
            max_opts=args.max_opts,
            warmup_period=1_000,
            opt_interval=16,
            batch_size=64 * n,
            num_envs=args.envs_per_device * n,
            steps_per_chunk=32,
            eval_interval=1_000,
            seed=args.seed,
        ),
        "recorder": BufferedRecorder(),
        "evaluator": Evaluator(env, n_episodes=5, max_steps=500,
                               device=args.device),
        "mesh": make_mesh(("actors",)),
        "own_group": own_group,
    }


def run(args, objs):
    try:
        res = ShardedTrainer(objs["env"], objs["agent"], objs["buffer"],
                             objs["config"], recorder=objs["recorder"],
                             evaluator=objs["evaluator"], mesh=objs["mesh"],
                             device=args.device).train()
        if dist.get_rank() == 0:
            print(f"devices={dist.get_world_size()}  "
                  f"samples/s={res.samples_per_sec:,.0f}  "
                  f"opt/s={res.opt_per_sec:,.1f}  best={res.best_score:.1f}")
            for step, score in res.eval_history:
                print(f"  opt {step:>6d}: eval return {score:.1f}")
        return res
    finally:
        if objs["own_group"]:
            dist.destroy_process_group()


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
