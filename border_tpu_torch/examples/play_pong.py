"""Play a trained Pong policy with live terminal rendering / GIF capture
(≙ examples/play_pong.py).

≙ the reference's eval binaries with the display window enabled
(border-atari-env/src/env/window.rs:1-67 + eval mode in
examples/atari/dqn_atari): loads a DQN checkpoint and rolls greedy
episodes, drawing frames as ANSI half-blocks and/or writing an animated
GIF.  ``--model`` is either a model the port saved (``Agent.save``:
``dqn.npz``) or one the JAX package saved (``dqn.npz`` beside
``dqn.treedef.txt``, read by :func:`border_tpu_torch.convert.load_jax_policy`);
the default is the committed JAX-trained policy, artifacts/pong_model/best.
"""

import argparse
import os
from pathlib import Path

import torch

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.convert import load_jax_policy
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.envs import make
from border_tpu_torch.examples import add_device
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.utils import (FrameRecorder, TerminalWindow,
                                    enable_compilation_cache)

DEFAULT_MODEL = str(Path(__file__).resolve().parents[2]
                    / "artifacts" / "pong_model" / "best")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=DEFAULT_MODEL)
    p.add_argument("--steps", type=int, default=3_000)
    p.add_argument("--gif", default="", help="write an animated GIF here")
    p.add_argument("--no-render", action="store_true")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p


def load_model(agent, path: str, obs_space, act_space, seed: int, device):
    """A state of ``agent`` from ``path``: a JAX-saved agent when its
    treedef file is there, else one the port saved."""
    if os.path.exists(os.path.join(path, f"{agent.name}.treedef.txt")):
        return load_jax_policy(agent, path, obs_space, act_space, device=device)
    state = agent.init(seed, obs_space, act_space, device=device)
    return agent.load(state, path)


def build(args) -> dict:
    vec = VecEnv(make("Pong-v0", train=False), 1, device=args.device)
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n)))
    state = load_model(agent, args.model, vec.observation_space,
                       vec.action_space, args.seed, args.device)
    return {"vec": vec, "agent": agent, "state": state}


def run(args, objs):
    """Returns the finished episodes' returns."""
    vec, agent, state = objs["vec"], objs["agent"], objs["state"]
    window = None if args.no_render else TerminalWindow(fps=args.fps)
    recorder = FrameRecorder() if args.gif else None

    vec_state = vec.reset(args.seed)
    ep_return, returns = 0.0, []
    for t in range(args.steps):
        action = agent.select_action_eval(state, vec_state.obs)
        ts, vec_state = vec.step(vec_state, action)
        frame = vec_state.obs[0].cpu()
        if window is not None:
            window.show(frame)
        if recorder is not None:
            recorder.add(frame)
        reward, done = torch.stack(
            [ts.reward[0], (ts.terminated[0] | ts.truncated[0]).float()]).tolist()
        ep_return += reward
        if done:
            returns.append(ep_return)
            print(f"episode {len(returns)}: return {ep_return:+.0f}")
            ep_return = 0.0
            if recorder is not None:
                break
    if recorder is not None and len(recorder):
        print("gif:", recorder.save_gif(args.gif, fps=args.fps))
    return returns


def main(argv=None):
    enable_compilation_cache()
    args = parser().parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    main()
