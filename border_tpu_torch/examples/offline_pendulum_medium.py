"""BC / AWAC / IQL on the committed pendulum-medium corpus
(≙ examples/offline_pendulum_medium.py).

≙ the reference's D4RL example trio (examples/d4rl/{bc,awac,iql}_pen):
load a Minari-style dataset, train offline, report the D4RL-normalized
score against the behavior policy's (border-minari/src/evaluator.rs:26-63).
Dataset resolution goes through border_tpu_torch.data.MinariDataset — the
real minari package when installed, else the committed local corpus.
"""

import argparse

from border_tpu_torch.agents import AWAC, AWACConfig, BC, BCConfig, IQL, IQLConfig
from border_tpu_torch.data import MinariDataset, normalized_score
from border_tpu_torch.examples import add_device
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import OfflineTrainer, TrainerConfig
from border_tpu_torch.utils import enable_compilation_cache


def build_agent(name: str):
    if name == "bc":
        return BC(BCConfig(hidden=(128, 128), action_mode="continuous"))
    if name == "awac":
        return AWAC(AWACConfig(actor_hidden=(128, 128),
                               critic_hidden=(128, 128)))
    if name == "iql":
        return IQL(IQLConfig(actor_hidden=(128, 128),
                             critic_hidden=(128, 128),
                             value_hidden=(128, 128)))
    raise KeyError(name)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--agent", choices=["bc", "awac", "iql"], default="iql")
    p.add_argument("--dataset", default="pendulum-medium-v0")
    p.add_argument("--max-opts", type=int, default=10_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def build(args) -> dict:
    md = MinariDataset.load(args.dataset)
    print(f"dataset {md.dataset_id}: {md.get_num_transitions()} transitions "
          f"on {md.env_name}; behavior normalized score "
          f"{md.behavior_normalized_score():.1f}")
    buffer = ReplayBuffer(capacity=md.get_num_transitions(), device=args.device)
    agent = build_agent(args.agent)
    env = md.recover_environment()
    obs_space = env.observation_space(env.default_params)
    act_space = env.action_space(env.default_params)
    return {
        "dataset": md,
        "buffer": buffer,
        "buffer_state": md.create_replay_buffer(buffer),
        "agent": agent,
        "agent_state": agent.init(args.seed, obs_space, act_space,
                                  device=args.device),
        "config": TrainerConfig(max_opts=args.max_opts,
                                batch_size=args.batch_size,
                                eval_interval=1_000, seed=args.seed),
        "evaluator": md.make_evaluator(n_episodes=10, max_steps=200,
                                       device=args.device),
    }


def run(args, objs):
    md = objs["dataset"]
    res = OfflineTrainer(objs["agent"], objs["buffer"], objs["config"],
                         evaluator=objs["evaluator"],
                         updates_per_chunk=500).train(objs["agent_state"],
                                                      objs["buffer_state"])
    learned = normalized_score(res.best_score, md.ref_min, md.ref_max)
    print(f"{args.agent}: eval return {res.best_score:.1f} "
          f"(normalized {learned:.1f} vs behavior "
          f"{md.behavior_normalized_score():.1f})")
    for step, score in res.eval_history:
        print(f"  opt {step:>6d}: {score:+.1f} "
              f"(normalized {normalized_score(score, md.ref_min, md.ref_max):.1f})")
    return res


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
