#!/usr/bin/env python3
"""Chip smoke of border_tpu_torch on one NVIDIA GPU (built for the H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):

1. the card's name and power limit, as nvidia-smi gives them;
2. the CUDA kernel border_tpu_torch/csrc/frame_gather.cu is built with
   nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card, bitwise: the
   frame gather at the main-path shape (a 1024·256-frame 84×84 uint8 ring,
   512×5 indices) and at odd shapes, some of them on the byte path
   (frame size or base address not a multiple of 16 bytes);
4. the kernel, its plain version and one PyTorch call for the same function
   timed with CUDA events (median over launches, fresh indices each launch
   so the gathered frames come from device memory, not the L2), beside the
   least time the card could take (bytes moved over 3.35 TB/s);
5. the port against its own CPU path on small inputs (env steps bitwise, a
   float32 DQN update to 1e-4);
6. the main path: Trainer.train() on Pong at the bench.py config (1024
   envs, 32 steps a chunk, batch 512, 8 gradient samples per transition,
   bf16 AtariCNN), until several update chunks of 512 updates have run;
   the gather's launch count must equal the number of updates.
7. where a chunk's time goes: its env and update phases timed apart in
   this run, and a few env steps and updates traced with torch.profiler
   (device busy time, idle share, launches, the kernels that take most).

Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet

# main-path shapes (bench.py's Pong config)
NUM_ENVS, CAPACITY, FRAME_HW, STACK = 1024, 256, (84, 84), 4
BATCH, STEPS_PER_CHUNK, OPT_INTERVAL = 512, 32, 64
UPDATE_CHUNKS = 3
TIMED_LAUNCHES = 60


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        import border_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"border_tpu_torch is not importable next to chip_smoke.py: {e}")

    from border_tpu_torch.ops import _build, frame_gather
    from border_tpu_torch.ops.frame_gather import gather_frames, gather_frames_ref

    dev = torch.device("cuda")

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("frame_gather")
    print(f"build: frame_gather.cu with nvcc for sm_90a and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. kernel vs plain version, bitwise --------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    m = NUM_ENVS * CAPACITY
    frames = torch.randint(0, 256, (m, *FRAME_HW), generator=g, device=dev,
                           dtype=torch.uint8)
    max_abs_err = 0.0
    # (shape, B, S, dtype, offset of the base in elements); frames whose
    # size or base is not 16-byte aligned take the kernel's byte path
    cases = [((m, *FRAME_HW), BATCH, STACK + 1, torch.uint8, 0),
             ((37, 84, 84), 9, 4, torch.uint8, 0),
             ((16, 12, 20), 7, 5, torch.uint8, 0),
             ((16, 12, 20), 7, 5, torch.float32, 0),
             ((1031, 84, 84), 513, 5, torch.uint8, 0),  # B·S not a block multiple
             ((64, 84, 84), 33, 5, torch.float32, 0),
             ((16, 7, 9), 7, 5, torch.uint8, 0),  # 63 B frames
             ((40, 84, 84), 9, 5, torch.uint8, 1),  # base 1 B past alignment
             ((16, 12, 20), 7, 5, torch.float32, 1)]  # base 4 B past
    for shape, b, s, dtype, offset in cases:
        if shape[0] == m:
            src = frames
        else:
            n = math.prod(shape)
            src = (torch.randint(0, 256, (offset + n,), generator=g, device=dev)
                   .to(dtype)[offset:].view(shape))
        idx = torch.randint(0, shape[0], (b, s), generator=g, device=dev,
                            dtype=torch.int32)
        out = gather_frames(src, idx)
        ref = gather_frames_ref(src, idx)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"gather_frames shape/dtype {tuple(out.shape)} {out.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        if not torch.equal(out, ref):
            fail(f"gather_frames disagrees with frames[idx] at {shape} "
                 f"{b}x{s} {dtype} offset {offset}: max abs err {err}")
    print(f"kernel check: frame_gather bitwise equal to frames[idx] at "
          f"{len(cases)} shapes, max_abs_err {max_abs_err}", flush=True)

    # -- 4. timing -------------------------------------------------------------
    idxs = torch.randint(0, m, (TIMED_LAUNCHES + 5, BATCH, STACK + 1),
                         generator=g, device=dev, dtype=torch.int32)

    def time_ms(fn) -> float:
        for i in range(5):  # warm-up
            fn(idxs[TIMED_LAUNCHES + i])
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_LAUNCHES + 1)]
        # the card waits while the host queues every launch, so the gaps
        # between events are device time, not host launch time
        torch.cuda._sleep(50_000_000)
        ev[0].record()
        for i in range(TIMED_LAUNCHES):
            fn(idxs[i])
            ev[i + 1].record()
        torch.cuda.synchronize()
        return statistics.median(
            ev[i].elapsed_time(ev[i + 1]) for i in range(TIMED_LAUNCHES))

    frame_bytes = FRAME_HW[0] * FRAME_HW[1]
    gather_bytes = (2 * BATCH * (STACK + 1) * frame_bytes
                    + BATCH * (STACK + 1) * 4)
    launches0 = frame_gather.gather_frames.launches
    timing = {
        "ms": time_ms(lambda i: gather_frames(frames, i)),
        "plain_ms": time_ms(lambda i: gather_frames_ref(frames, i)),
        "library_ms": time_ms(lambda i: frames[i]),
    }
    frame_gather.gather_frames.launches = launches0
    bound_ms = 1e3 * gather_bytes / HBM_BYTES_PER_S
    print("timing frame_gather [262144,84,84] uint8 x [512,5]: "
          + json.dumps({k: round(v, 5) for k, v in timing.items()})
          + f" bound_ms {bound_ms:.5f} ({gather_bytes} B over 3.35 TB/s)",
          flush=True)
    del frames, idxs
    torch.cuda.empty_cache()

    # -- 5. the port against its CPU path on small inputs ------------------
    reference_checks(torch, dev)

    # -- 6. the main path ---------------------------------------------------
    launches, tr, r = main_path(torch, dev)

    # -- 7. where a chunk's time goes ----------------------------------------
    breakdown(torch, tr, r)

    kernels = [{
        "name": "frame_gather",
        "route": "cuda",
        "source": "border_tpu_torch/csrc/frame_gather.cu",
        "replaces": "border_tpu/ops/frame_gather.py:71",
        "launches": launches,
        "match": True,
        "max_abs_err": max_abs_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def reference_checks(torch, dev) -> None:
    """Small inputs through the card and through the port's CPU path (the
    path the CPU tests hold against the JAX package)."""
    from border_tpu_torch import convert  # noqa: F401  (imports the port)
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import TransitionBatch

    cpu = torch.device("cpu")
    # env: 8 steps from a fresh reset (no point can be scored yet), same
    # actions, bitwise: float32 elementwise arithmetic rounds the same
    env = make("Pong-v0")
    vg, vc = VecEnv(env, 64, device=dev), VecEnv(env, 64, device=cpu)
    sg = vg.reset(0)
    sc = to_device(sg, cpu, torch)
    rng = torch.Generator().manual_seed(1)
    for _ in range(8):
        a = torch.randint(0, 6, (64,), generator=rng, dtype=torch.int32)
        tg, sg = vg.step(sg, a.to(dev))
        tc, sc = vc.step(sc, a)
    torch.cuda.synchronize()
    if not torch.equal(sg.obs.cpu(), sc.obs):
        fail("Pong/PixelEnv on the card differs from the CPU path")
    if not torch.equal(tg.reward.cpu(), tc.reward):
        fail("env rewards on the card differ from the CPU path")

    # one float32 DQN update on the card (cuDNN without TF32) and on the CPU
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                              lr=1e-4, double_dqn=True))
        obs_space, act_space = env.observation_space(None), env.action_space(None)
        stg = agent.init(0, obs_space, act_space, device=dev)
        stc = agent.init(0, obs_space, act_space, device=cpu)
        bg = torch.Generator().manual_seed(2)
        b = 16
        batch = dict(
            obs=torch.randint(0, 256, (b, 84, 84, 4), generator=bg, dtype=torch.uint8),
            act=torch.randint(0, 6, (b,), generator=bg, dtype=torch.int32),
            next_obs=torch.randint(0, 256, (b, 84, 84, 4), generator=bg,
                                   dtype=torch.uint8),
            reward=torch.randint(-1, 2, (b,), generator=bg).float(),
            terminated=torch.rand(b, generator=bg) < 0.25,
            truncated=torch.zeros(b, dtype=torch.bool),
        )
        _, mg, tdg = agent.update(stg, TransitionBatch(
            **{k: v.to(dev) for k, v in batch.items()}))
        _, mc, tdc = agent.update(stc, TransitionBatch(**batch))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if not torch.allclose(tdg.cpu(), tdc, rtol=1e-4, atol=1e-5):
        fail(f"DQN td errors differ: {(tdg.cpu() - tdc).abs().max().item()}")
    if not math.isclose(mg["loss"].item(), mc["loss"].item(), rel_tol=1e-4):
        fail(f"DQN loss differs: {mg['loss'].item()} vs {mc['loss'].item()}")
    print(f"reference check: 8 Pong steps x 64 envs bitwise equal to the CPU "
          f"path; float32 DQN update loss {mg['loss'].item():.6g} vs "
          f"{mc['loss'].item():.6g} on the CPU (rtol 1e-4)", flush=True)


def to_device(x, device, torch):
    """A copy of a (nested) dataclass of tensors on ``device``; a CUDA
    generator becomes a CPU one (its draws are not compared)."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_device(getattr(x, f.name), device, torch)
                          for f in dataclasses.fields(x)})
    if isinstance(x, torch.Generator):
        return torch.Generator(device=device).manual_seed(0)
    return x.to(device)


def main_path(torch, dev):
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.record import NullRecorder
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    class ChunkRecorder(NullRecorder):
        """Keeps the record the trainer stores for every chunk."""

        def __init__(self):
            super().__init__()
            self.chunks = []

        def store(self, record):
            self.chunks.append(record)

    env = make("Pong-v0")
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(n), lr=1e-4,
                          double_dqn=True, soft_update_interval=2_000, tau=1.0))
    updates_per_chunk = STEPS_PER_CHUNK * NUM_ENVS // OPT_INTERVAL
    cfg = TrainerConfig(
        num_envs=NUM_ENVS, steps_per_chunk=STEPS_PER_CHUNK, batch_size=BATCH,
        opt_interval=OPT_INTERVAL, warmup_period=0,
        max_opts=UPDATE_CHUNKS * updates_per_chunk,
    )
    buf = FrameReplayBuffer(capacity=CAPACITY, num_envs=NUM_ENVS)
    rec = ChunkRecorder()
    tr = Trainer(env, agent, buf, cfg, recorder=rec)
    if tr.updates_per_chunk != updates_per_chunk:
        fail(f"updates_per_chunk {tr.updates_per_chunk} != {updates_per_chunk}")
    # train() draws its initial parameters from seed 0 on the CPU, as here
    before = [p.detach().clone() for p in agent.init(
        0, tr.vec.observation_space, tr.vec.action_space).params.parameters()]

    # the counts are set to 0 just before the main path and read just after
    frame_gather.gather_frames.launches = 0
    r = tr.train(seed=0)
    torch.cuda.synchronize()
    launches = frame_gather.gather_frames.launches

    chunks = [c for c in rec.chunks if "opt_steps_per_sec" in c]
    losses = [c["loss"] for c in chunks]
    if len(chunks) != UPDATE_CHUNKS or not all(map(math.isfinite, losses)):
        fail(f"update chunks {len(chunks)}, losses {losses}")
    if r.opt_steps != UPDATE_CHUNKS * updates_per_chunk:
        fail(f"ran {r.opt_steps} updates")
    after = list(r.agent_state.params.parameters())
    if all(torch.equal(a, p.detach()) for a, p in zip(before, after)):
        fail("the parameters did not change")
    if not all(torch.isfinite(p).all() for p in after):
        fail("non-finite parameters")
    if launches != r.opt_steps:
        fail(f"frame_gather launched {launches} times for {r.opt_steps} updates")
    if r.buffer_state.total != (UPDATE_CHUNKS + 1) * STEPS_PER_CHUNK:
        fail(f"buffer holds {r.buffer_state.total} pushes")
    obs = r.buffer_state.frames[:4, 0, :, :, None].expand(-1, -1, -1, 4)
    q = r.agent_state.params(obs)
    if q.shape != (4, 6) or not torch.isfinite(q).all():
        fail(f"Q values of shape {tuple(q.shape)} not finite")

    # per update chunk (32 env steps, then 512 updates): env-steps/s and
    # updates/s over the chunk's wall time, which ends in a device sync
    eps = [c["samples_per_sec"] for c in chunks]
    ups = [c["opt_steps_per_sec"] for c in chunks]
    result = {
        "env_steps": r.env_steps, "updates": r.opt_steps,
        "update_chunks": UPDATE_CHUNKS, "gather_launches": launches,
        "final_loss": losses[-1],
        "env_steps_per_s_chunks": eps, "updates_per_s_chunks": ups,
        "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"main path: Trainer.train() Pong, {NUM_ENVS} envs, batch {BATCH}, "
          f"{r.opt_steps} updates in {UPDATE_CHUNKS} update chunks; "
          f"env-steps/s {eps[-1]:.1f}, updates/s {ups[-1]:.2f} (last chunk); "
          f"final loss {losses[-1]:.6g}; frame_gather launches {launches} "
          f"= updates {r.opt_steps}", flush=True)
    print("main path numbers: " + json.dumps(result), flush=True)
    return launches, tr, r


def breakdown(torch, tr, r) -> None:
    """The env and update phases of a main-path chunk timed apart (host
    clock, each ending in a device sync), then a shorter stretch of each
    traced with torch.profiler: device busy time, idle share of the traced
    wall (the profiler's own host cost is in that wall), launches and the
    kernels with the most device time.  Starts from the main path's final
    agent and replay state."""
    from torch.profiler import ProfilerActivity, profile

    from border_tpu_torch.train import Trainer, TrainerConfig

    gen = torch.Generator(device=tr.device).manual_seed(3)
    ag, vec, buf = r.agent_state, tr.vec.reset(1), r.buffer_state

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    env_s, upd_s = [], []
    for _ in range(2):
        (ag, vec, buf, _, _), t = timed(
            lambda: tr._env_scan(ag, vec, buf, gen, explore=True))
        env_s.append(t)
        (ag, buf, _), t = timed(lambda: tr._update_scan(ag, buf, gen))
        upd_s.append(t)
    out = {"env_phase_s": env_s, "update_phase_s": upd_s,
           "env_share_of_chunk": [e / (e + u) for e, u in zip(env_s, upd_s)],
           "ms_per_env_step": [1e3 * e / STEPS_PER_CHUNK for e in env_s],
           "ms_per_update": [1e3 * u / tr.updates_per_chunk for u in upd_s]}

    # a trainer built for the trace lengths: 2 env steps, 32 updates
    trace_steps = 2
    tt = Trainer(tr.env, tr.agent, tr.buffer, TrainerConfig(
        num_envs=NUM_ENVS, steps_per_chunk=trace_steps, batch_size=BATCH,
        opt_interval=OPT_INTERVAL, warmup_period=0))
    for phase, n in (("env", trace_steps), ("update", tt.updates_per_chunk)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if phase == "env":
                (ag, vec, buf, _, _), wall = timed(
                    lambda: tt._env_scan(ag, vec, buf, gen, explore=True))
            else:
                (ag, buf, _), wall = timed(lambda: tt._update_scan(ag, buf, gen))
        # kernel rows only: an operator's row repeats its kernels' time
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy_s = sum(e.self_device_time_total for e in rows) / 1e6
        rows.sort(key=lambda e: -e.self_device_time_total)
        out[f"{phase}_trace"] = {
            "per": n, "wall_ms_each": 1e3 * wall / n,
            "device_busy_ms_each": 1e3 * busy_s / n,
            "device_idle_share": 1.0 - busy_s / wall,
            "launches_each": sum(e.count for e in rows) / n,
            "top_ms_each": [[e.key[:80], e.count / n,
                             e.self_device_time_total / 1e3 / n]
                            for e in rows[:8]],
        }
    if not out["update_trace"]["device_busy_ms_each"] > 0:
        fail("the profiler saw no device time in the update trace")
    print("breakdown: " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
