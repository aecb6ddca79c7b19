"""A compile-and-train check of the flagship forward and of one chunk of
each sharded trainer, on tiny shapes (≙ __graft_entry__.py).

- :func:`entry`: the flagship model's forward (DQN's Atari CNN over
  84×84×4 stacked frames) and example arguments;
- :func:`assert_trained`: a chunk's metrics must show training, not only
  placement;
- :func:`dryrun_multichip`: ``n`` ranks of :mod:`border_tpu_torch.parallel`
  over gloo each run one chunk of ``ShardedTrainer`` (CartPole with PER,
  then Pong over frame shards), of ``GSPMDTrainer`` dp×tp (flat and pixel,
  when ``n`` is even) and of ``ShardedAsyncTrainer``, and print a line each.

The JAX check runs one program over ``n`` devices of one process; here a
rank is a process (spawned, with a ``FileStore`` in a temporary directory,
no ports).  On the card the ranks share it over gloo, as NCCL takes one
rank per GPU.

    python -m border_tpu_torch.dryrun [--ranks N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from typing import List, NamedTuple

import torch

from border_tpu_torch.utils.device import DeviceLike, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 600


def entry(dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None):
    """``(forward, (params, obs))``: the flagship forward step as a function
    of its parameters (``torch.func.functional_call`` of the port's
    ``AtariCNN(6)``) and example arguments, ``[8, 84, 84, 4]`` uint8
    zeros."""
    from border_tpu_torch.models import AtariCNN

    device = resolve_device(device)
    net = AtariCNN(out_dim=6, dtype=dtype)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.to(device)
    obs = torch.zeros((8, 84, 84, 4), dtype=torch.uint8, device=device)
    params = {k: v.detach() for k, v in net.state_dict().items()}

    def forward(params, obs):
        return torch.func.functional_call(net, params, (obs,))

    return forward, (params, obs)


def assert_trained(tag: str, metrics) -> dict:
    """The metrics as floats, after checking they show training: every one
    finite, and not a zero loss together with a zero ``q_mean`` (the update
    then sampled unwritten, all-zero replay slots: a chunk too short for
    the frame ring's sampleable window trains on zeros)."""
    m = {k: float(v) for k, v in metrics.items()}
    for k, v in m.items():
        if not math.isfinite(v):
            raise AssertionError(f"{tag}: non-finite metric {k}={v}")
    if abs(m.get("loss", 0.0)) < 1e-12 and abs(m.get("q_mean", 0.0)) < 1e-12:
        raise AssertionError(
            f"{tag}: loss and q_mean are both zero: the update trained on "
            f"unwritten replay slots ({m})")
    return m


# -- a rank ------------------------------------------------------------------------
def _chunk(tr, do_update: bool = True):
    """One chunk of ``tr`` from fresh states (seed 0): the metrics."""
    agent_state, vec_state, buf_state = tr.init_states(0, 0)
    gen = tr._loop_generator(0)
    return tr._chunk(agent_state, vec_state, buf_state, gen, do_update)


def _rank_chunks(n: int, device: torch.device) -> None:
    """Every chunk of the check on this rank; rank 0 prints the lines."""
    import torch.distributed as dist

    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.parallel import (
        GSPMDTrainer,
        ShardedAsyncTrainer,
        ShardedTrainer,
        make_dp_tp_mesh,
        make_mesh,
    )
    from border_tpu_torch.parallel.gspmd import ActorShardedFrames
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig, ReplayBuffer
    from border_tpu_torch.train import TrainerConfig

    def say(line):
        if dist.get_rank() == 0:
            print(line, flush=True)

    mesh = make_mesh(("actors",))
    env = make("CartPole-v1")
    cfg = TrainerConfig(num_envs=2 * n, steps_per_chunk=4, batch_size=4 * n,
                        opt_interval=8, warmup_period=0)
    tr = ShardedTrainer(env, DQN(DQNConfig(double_dqn=True, hidden=(32, 32))),
                        ReplayBuffer(capacity=256, per=PerConfig(), device=device),
                        cfg, mesh=mesh, device=device)
    out = _chunk(tr)
    say(f"dryrun_multichip OK: {n} ranks, metrics={assert_trained('dp', out[3])}")

    # the flagship pixel config, tiny shapes: a whole training step over the ranks
    cfg_px = TrainerConfig(num_envs=2 * n, steps_per_chunk=8, batch_size=2 * n,
                           opt_interval=8, warmup_period=0)
    tr = ShardedTrainer(
        make("Pong-v0"), DQN(DQNConfig(model=lambda a: AtariCNN(out_dim=a), lr=1e-4)),
        FrameReplayBuffer(capacity=32, num_envs=cfg_px.num_envs, device=device),
        cfg_px, mesh=mesh, device=device)
    out = _chunk(tr)
    say(f"dryrun_multichip pixel OK: {n} ranks, "
        f"metrics={assert_trained('pixel', out[3])}")

    # dp×tp: weights column-sharded over 'model', env rows over 'actors'
    if n % 2 == 0:
        mesh2 = make_dp_tp_mesh(n // 2, 2)
        shape = dict(zip(mesh2.mesh_dim_names, mesh2.mesh.shape))
        cfg_tp = TrainerConfig(num_envs=n, steps_per_chunk=4, batch_size=4 * n,
                               opt_interval=8, warmup_period=0)
        tr = GSPMDTrainer(make("CartPole-v1"), DQN(DQNConfig(hidden=(32, 32))),
                          ReplayBuffer(capacity=256, device=device), cfg_tp,
                          mesh=mesh2, device=device)
        out = _chunk(tr)
        say(f"dryrun_multichip dp×tp OK: mesh {shape}, "
            f"metrics={assert_trained('dp_tp', out[3])}")

        # dp×tp at pixel scale: the frame ring's env axis over 'actors';
        # steps_per_chunk exceeds stack + n_step, so the ring's sampleable
        # window holds written transitions
        cfg_px2 = TrainerConfig(num_envs=n, steps_per_chunk=8, batch_size=n,
                                opt_interval=8, warmup_period=0)
        tr = GSPMDTrainer(
            make("Pong-v0"), DQN(DQNConfig(model=lambda a: AtariCNN(out_dim=a),
                                           lr=1e-4)),
            FrameReplayBuffer(capacity=16, num_envs=cfg_px2.num_envs, device=device),
            cfg_px2, mesh=mesh2, device=device)
        agent_state, vec_state, buf_state = tr.init_states(0, 0)
        ring_envs = buf_state.frames.shape[0]
        if ring_envs != n // tr.dp or (tr.dp > 1) != isinstance(tr.buffer,
                                                               ActorShardedFrames):
            raise AssertionError(f"pixel_dp_tp: the rank's ring holds {ring_envs} "
                                 f"of {n} envs at dp={tr.dp}")
        out = tr._chunk(agent_state, vec_state, buf_state, tr._loop_generator(0), True)
        say(f"dryrun_multichip pixel dp×tp OK: frame ring over {tr.dp} actors "
            f"rank(s), {ring_envs} envs a rank, "
            f"metrics={assert_trained('pixel_dp_tp', out[3])}")

    # the decoupled actor-learner over the ranks: the actor phase steps every
    # rank's env shard with stale parameters, the learner averages gradients
    cfg_as = TrainerConfig(num_envs=2 * n, steps_per_chunk=8, batch_size=4 * n,
                           opt_interval=8, warmup_period=0, sync_interval=1)
    tr = ShardedAsyncTrainer(env, DQN(DQNConfig(double_dqn=True, hidden=(32, 32))),
                             ReplayBuffer(capacity=256, device=device), cfg_as,
                             mesh=mesh, device=device)
    agent_state, vec_state, buf_state = tr.init_states(0, 0)
    gen = tr._loop_generator(0)
    # the first dispatch fills the replay shards (actor phase only), the
    # second runs the stale actor and the learner's updates
    agent_state, vec_state, buf_state, _, _, _ = tr._dispatch(
        agent_state, vec_state, buf_state, gen, False)
    out = tr._dispatch(agent_state, vec_state, buf_state, gen, True)
    if not int(out[0].n_opts) > 0:
        raise AssertionError("sharded_async: the learner phase ran no updates")
    say(f"dryrun_multichip sharded-async OK: {n} ranks, "
        f"metrics={assert_trained('sharded_async', out[3])}")


def _rank_main(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.parallel import init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    device = resolve_device(spec["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"file://{spec['store']}", spec["world"], rank,
                     backend="gloo", device=device)
    try:
        _rank_chunks(spec["world"], device)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.json"), "w") as f:
        json.dump({"gather_launches": frame_gather.gather_frames.launches}, f)


class DryrunResult(NamedTuple):
    """Rank 0's lines, and the frame-gather kernel's launches summed over
    the ranks (0 on the CPU, where the gather is its plain version)."""

    lines: List[str]
    gather_launches: int


# -- the ranks' parent -------------------------------------------------------------
def dryrun_multichip(n: int, device: DeviceLike = None) -> DryrunResult:
    """One chunk of each sharded trainer on ``n`` gloo ranks of this module,
    spawned as processes on ``device`` (the card, unless the CPU is asked
    for); rank 0's lines are printed.  Raises with the ranks' errors when
    one fails or they outlast ``RANK_TIMEOUT_S``."""
    device = resolve_device(device)
    work = tempfile.mkdtemp(prefix="border_dryrun_")
    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as f:
        json.dump({"world": n, "store": os.path.join(work, "store"),
                   "device": str(device)}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "border_tpu_torch.dryrun", "--rank-of", spec, str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(n)]
    outs, errors, launches = [], [], 0
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
        if not errors:
            for r in range(n):
                with open(os.path.join(work, f"rank{r}.json")) as f:
                    launches += json.load(f)["gather_launches"]
    except subprocess.TimeoutExpired:
        errors.append(f"the ranks outlasted {RANK_TIMEOUT_S} s")
    finally:  # a failed rank leaves none behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    if errors:
        raise RuntimeError("dryrun_multichip: " + "\n".join(errors))
    lines = outs[0].splitlines()
    for line in lines:
        print(line, flush=True)
    return DryrunResult(lines, launches)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m border_tpu_torch.dryrun",
        description="Compile-and-train check of the flagship forward and of "
                    "one chunk of each sharded trainer.")
    p.add_argument("--ranks", type=int, default=2,
                   help="gloo ranks of the sharded chunks (default 2: every "
                        "trainer, dp×tp included)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward and the ranks (cuda, or cpu)")
    p.add_argument("--rank-of", nargs=2, metavar=("SPEC", "RANK"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_of:
        _rank_main(args.rank_of[0], int(args.rank_of[1]))
        return
    fn, fn_args = entry(device=args.device)
    with torch.no_grad():
        print("entry:", tuple(fn(*fn_args).shape), flush=True)
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
