"""BC / AWAC / IQL on the goal-dict fetch-reacher corpus
(≙ examples/offline_fetch_reacher.py).

≙ the reference's D4RL robotics examples (examples/d4rl/{bc,awac,iql}_pen
+ the dict-obs converter stack, border-minari/src/d4rl/**): load a
goal-dict Minari dataset through `GoalDictConverter`, train offline, and
report the D4RL-normalized score against the behavior policy
(border-minari/src/evaluator.rs:26-63).

The default `--dataset fetch-reacher-medium-h5-v0` exercises the
package-free Minari-format HDF5 loader on the committed full-size dict-obs
file (it needs `h5py`); `--dataset fetch-reacher-medium-v0` reads the
committed `.npz` collection instead.  Point `MINARI_DATASETS_PATH` at any
downloaded Minari dataset dir to load external data the same way.

The full goal layout (observation ++ desired_goal ++ achieved_goal) is
used on BOTH the dataset and the live eval env.  BC's cosine learning-rate
horizon is the run's `--max-opts` (12,000 by default, the JAX example's
fixed horizon).
"""

import argparse

from border_tpu_torch.agents import AWAC, AWACConfig, BC, BCConfig, IQL, IQLConfig
from border_tpu_torch.agents.common import cosine_decay_schedule
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.data import GoalDictConverter, MinariDataset, normalized_score
from border_tpu_torch.data.datasets import NormalizedEvaluator
from border_tpu_torch.envs import make
from border_tpu_torch.envs.reacher import FlattenDictWrapper
from border_tpu_torch.examples import add_device
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import OfflineTrainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache

KEYS = ("observation", "desired_goal", "achieved_goal")


def build_agent(name: str, max_opts: int = 12_000):
    if name == "bc":
        return BC(BCConfig(hidden=(256, 256),
                           lr=cosine_decay_schedule(1e-3, max_opts)))
    if name == "awac":
        return AWAC(AWACConfig(actor_hidden=(256, 256),
                               critic_hidden=(256, 256), lambda_=10.0))
    if name == "iql":
        return IQL(IQLConfig())
    raise KeyError(name)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--agent", choices=["bc", "awac", "iql"], default="iql")
    p.add_argument("--dataset", default="fetch-reacher-medium-h5-v0")
    p.add_argument("--max-opts", type=int, default=12_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    add_device(p)
    return p


def build(args) -> dict:
    if args.cpu:
        args.device = "cpu"
    md = MinariDataset.load(args.dataset,
                            converter=GoalDictConverter(keys=KEYS))
    print(f"dataset {md.dataset_id}: {md.get_num_transitions()} transitions "
          f"(obs dim {md.data.obs.shape[1]}); behavior normalized "
          f"{md.behavior_normalized_score():.1f}")
    buffer = ReplayBuffer(capacity=md.get_num_transitions(), device=args.device)
    eval_env = FlattenDictWrapper(make("Reacher-v0"), keys=KEYS)
    vec = VecEnv(eval_env, 1, device=args.device)
    agent = build_agent(args.agent, args.max_opts)
    return {
        "dataset": md,
        "buffer": buffer,
        "buffer_state": md.create_replay_buffer(buffer),
        "agent": agent,
        "agent_state": agent.init(args.seed, vec.observation_space,
                                  vec.action_space, device=args.device),
        "evaluator": NormalizedEvaluator(eval_env, n_episodes=200, max_steps=50,
                                         ref_min=md.ref_min, ref_max=md.ref_max,
                                         device=args.device),
        "config": TrainerConfig(max_opts=args.max_opts, batch_size=args.batch_size,
                                eval_interval=2_000, flush_record_interval=10**9,
                                seed=args.seed),
    }


def run(args, objs):
    md = objs["dataset"]
    res = OfflineTrainer(objs["agent"], objs["buffer"], objs["config"],
                         evaluator=objs["evaluator"],
                         updates_per_chunk=250).train(
        objs["agent_state"], objs["buffer_state"], seed=1000 + args.seed)
    learned = normalized_score(res.best_score, md.ref_min, md.ref_max)
    print(f"{args.agent}: best normalized {learned:.1f} "
          f"(behavior {md.behavior_normalized_score():.1f})")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
