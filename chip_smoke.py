#!/usr/bin/env python3
"""Chip smoke of border_tpu_torch on one NVIDIA GPU (built for the H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each (any failure exits non-zero with no result line):

1. the card's name and power limit, as nvidia-smi gives them;
2. the CUDA kernels border_tpu_torch/csrc/frame_gather.cu, sum_tree.cu and
   adam.cu are built with nvcc for sm_90a and, at the same time, the C++ host envs
   cpp/envpool.cpp with the host compiler (g++, or $CXX) and
   cpp/Makefile's flags;
3. each kernel against its plain PyTorch version on the card, bitwise: the
   frame gather at the main-path shape (a 1024·256-frame 84×84 uint8 ring,
   512×5 indices), at 512×4 indices (separate mode and n-step), at 256×5
   (the Seaquest path's batch), at the
   slice mode's runs of consecutive indices, at odd shapes, some of
   them on the byte path (frame size or base address not a multiple of 16
   bytes), and on the two other rings phases 8 and 9 hand it: the
   prioritized path's 1024·512 frames (3.70 GB, half of the indices past
   byte offset 2^31) and the slice mode's 1024·(256+5) frames (env stride
   261) with the indices the buffer's own slice sample makes;
4. the kernel, its plain version and one PyTorch call for the same function
   timed with CUDA events at 512×5, 512×4 and 256×5 indices (median over
   launches, fresh indices each launch so the gathered frames come from
   device memory, not the L2), beside the least time the card could take
   (bytes moved over 3.35 TB/s);
5. the port against its own CPU path on small inputs (env steps bitwise, a
   float32 DQN update and a float32 IQN update with the same quantile
   fractions to 1e-4; Reacher steps to 1e-6; float32 SAC, AWAC and IQL
   updates at their gate widths with the same injected normal draws to
   1e-4), and the sum tree at 2^19 leaves: the same
   update batches (duplicate indices among them) and the same injected
   uniforms on the card and on the CPU give the same sampled leaves and,
   to 1e-6 relative, the same totals and weights; then the sum tree's two
   kernels against their plain loops on the card, bitwise, at the
   prioritized cell's shapes (2^20 leaves: a push of 1024 envs x 5 slots,
   a priority write of 512 with duplicate indices, a descent of 512), and
   each of the four timed as a CUDA graph of SUM_TREE_REPS calls (the
   trainer replays them so), beside a descent of one lane (the chain of
   20 dependent levels alone) and the bytes over 3.35 TB/s; then the Adam
   kernel (csrc/adam.cu) against torch's capturable Adam, bitwise, over
   DQN's, IQN's and SAC's parameter lists (three eager steps, three graph
   replays), each timed as a CUDA graph of ADAM_REPS steps beside the
   bytes over 3.35 TB/s and torch's step timed the same way;
6. the uniform path: Trainer.train() on Pong at the bench.py config (1024
   envs, 32 steps a chunk, batch 512, 8 gradient samples per transition,
   bf16 AtariCNN), until two update chunks of 512 updates have run, the
   chunk's env steps and updates as replays of captured CUDA graphs; the
   gather's and the Adam kernel's launch counts (one a replay) must each
   equal the number of updates;
   then the same run with the eager chunk (cuda_graphs=False), which must
   end bitwise equal (agent state, replay state, every chunk's loss);
7. where a chunk's time goes, for the graphed chunk and the eager one in
   turns (graphed, then eager): their env and update phases
   timed apart in this run, the graphed phases' device time with CUDA
   events while the host has queued them ahead of the card, and a few env
   steps and updates of each traced with torch.profiler (device busy time,
   idle share, launches, host operator calls, the kernels that take
   most); the graphed chunk must make fewer host operator calls an env
   step and an update than the eager one.  Every path's phase 7 below
   does the same, and each offline phase times a chunk of both;
8. the prioritized path at the pong_per gate config's width (1024 envs,
   batch 512, a 1024 × 512-frame ring of 3.70 GB, a sum tree of 2^19
   leaves) with an Evaluator (10 episodes, 200 steps) and a full-state
   checkpoint after every update chunk: one warmup chunk and two update
   chunks.  The gather's launch count must equal the number of updates,
   the tree's total stay finite and positive, every sampled leaf have
   priority, the evaluator's record hold its five keys, and a second
   Trainer resumed from the first checkpoint must end bitwise equal
   (agent state and replay state) to the uninterrupted run.  On the final
   tree the JAX tree's descent, which lacks the port's test for a dead
   right subtree, is counted for the dead leaves it returns.  Then phase 7
   for this path;
9. one update chunk each of sample_mode="slice" and of n_step=3 at the
   same width (1 and 2 gather launches a sample);
10. IQN on Seaquest at the width of the seaquest learning-gate config (512
    envs, batch 256, a 512 x 512-frame ring, psi = the Atari CNN's 512
    features, 64 cosines, uniform8 / uniform8 / const32 quantile draws):
    one warmup chunk, one update chunk of 256 updates (two before phases
    23-25 were added) and one evaluation (10 episodes, 200 steps), then
    phase 7 for this path;
11. one warmup chunk and one update chunk of DQN on Breakout, Freeway and
    Space Invaders at their gate configs' width (512 envs, batch 512; the
    last two with n_step=3), each with its kernel launches per env step;
12. DQN on CartPole through the flat replay buffer at the width of
    bench.py's fused config (4096 envs, 64 steps a chunk, batch 512, 1024
    updates a chunk): one warmup chunk and one update chunk (two before
    phases 23-25 were added), then phase 7;
13. the whole cartpole learning-gate config (128 envs, n-step 3, an
    evaluation of 20 episodes every 500 updates, 12,000 updates), seed 0,
    through border_tpu_torch.learning.run into a temporary directory: its
    artifact must hold five finite fresh evaluations of the best
    checkpoint, and the run fails under a best evaluation score of 100;
14. SAC on Pendulum at the pendulum gate config's width (128 envs, 256
    updates a chunk, batch 128, actor and two critics 128x128, auto
    entropy coefficient): one warmup chunk, two update chunks and one
    evaluation (10 episodes, 200 steps), then phase 7 for this path;
15. the whole bc_offline learning-gate config (BC 256x256, cosine learning
    rate over the run's 12,000 updates, batch 256) over the committed
    fetch-reacher-medium-v0 corpus (25,000 transitions, dict observations
    flattened), a normalized evaluation of 200 episodes x 50 steps every
    2,000 updates, seed 0, through border_tpu_torch.learning.run: its
    artifact must hold ten finite fresh evaluations of the best
    checkpoint, and the run fails under a best normalized score of 50
    (the gate's target is 76);
16, 17. the awac_offline and iql_offline configs at full width (IQL over
    its gate corpus, the Minari-format HDF5 file converted to
    artifacts/datasets/torch/), cut to 1,000 updates with their first
    evaluation moved there (the gate's is at 2,000, where these phases
    stopped before phases 23-25 were added).
    Each offline phase ends with chunks of 250 updates of the graphed
    OfflineTrainer and its eager twin timed in turns and 32 updates of each
    traced;
18. the pong_host config through HostEnvTrainer at its width (256 C++
    envpool Pong envs, batch 512, a 256 x 1024-frame ring, 4 updates an
    iteration): the gate's warmup of 50,000 env steps, 512 updates,
    evaluations at 256 and 512 updates (5 episodes cut to 200 of the
    gate's 3,000 steps) and a full-state checkpoint at the end; a second
    trainer resumed from it must restore the ring and the agent bitwise
    and go on (counters, replay, evaluation index) for 128 updates (1,024
    and 256 before phases 23-25 were added).  The
    gather's launches must equal the updates.  The trainer and its
    HostEvaluator are graphed (the iteration's device step and update burst,
    the evaluation's select, as CUDA-graph replays); the same run with
    cuda_graphs=False from the same seeds must end bitwise equal (agent
    state, ring, evaluations, launches).  Then the iteration's parts timed
    apart and 8 pipelined iterations traced for the graphed trainer and
    its eager twin in turns: the graphed one must make fewer host operator
    calls an iteration;
19. the breakout_host config the same way: warmup and 256 updates, the
    eager twin and the breakdown;
20. the pendulum_host config (SAC 128x128, auto entropy coefficient, 32
    envs, batch 128, 4 updates an iteration) over PyVecEnv and the
    package's NumpyPendulum, Gymnasium's equations in numpy (the card's
    machine has no gymnasium): the 1,000-step warmup, 512 updates and one
    evaluation of the gate's 10 x 200 steps, the eager twin and the
    breakdown;
21. native CartPole through HostEnvTrainer at the JAX package's host-path
    learning test's config (DQN 64x64, 32 envs, 1,500 updates, evaluations
    of 5 x 500 steps every 500), graphed: fails under a best score of 100;
    its eager twin must end bitwise equal;
22. AsyncTrainer on Pong at bench.py's config with sync_interval 100,
    graphed (the actor's env steps and the learner's updates): a warmup
    chunk and two update chunks with a checkpoint after each; the actor's
    parameters at every chunk's start must equal the learner's at the last
    sync, bitwise; its eager twin and a trainer resumed from the first
    checkpoint must end bitwise equal (actor parameters included); then
    the fused Trainer and both AsyncTrainers timed in turns and a dispatch
    of each AsyncTrainer traced: the graphed one must make fewer host
    operator calls;
23. the utilities on the card: export_policy of a DQN-AtariCNN state at
    the main path's width and of an IQN state at the Seaquest path's,
    each run by NumpyMLPPolicy on 64 observations of its game: the numpy
    actions must equal the port's float32 select_action_eval (TF32 off)
    wherever the top-2 margin exceeds 1e-4 of the values' scale;
    profile_trace must write a trace with CUDA kernel events; run_elastic
    over a short CartPole Trainer with one injected crash must end bitwise
    equal (agent and replay state, counters) to the run without it;
24. the committed JAX-trained Pong policy (artifacts/pong_model/best)
    loaded by convert.load_jax_policy into the port's bf16 AtariCNN and
    evaluated by the dqn_pong example's evaluator (10 episodes, 3,000
    steps): fails under a mean return of 18.0, the gate's Pong target;
    the evaluation runs graphed (an env step replayed in blocks of 8) and
    eagerly, with the same record, bitwise, and both times printed; a
    16-step evaluation of each traced: the graphed one must make fewer host
    operator calls a step;
25. thirteen examples through main(argv) at their default width, with no
    --device (the default, cuda), cut in depth only through their own
    options: dqn_pong (--tensorboard, the 50,000-step warmup and one
    update chunk), dqn_cartpole (an agent from a YAML config, --mlflow
    against a stub server on 127.0.0.1, --checkpoint-interval, then
    --resume), convert_policy (512 SAC updates, export, numpy-only
    deployment on the C++ Pendulum pool), offline_fetch_reacher --dataset
    fetch-reacher-medium-v0 (250 IQL updates), async_dqn_pong (2,048
    updates after its warmup, one evaluation, the best model), iqn_seaquest
    and dqn_pong_host (256 updates after their warmups, the latter on the
    C++ envpool), dqn_cartpole_native (1,000 updates on the C++ envpool),
    sac_pendulum and sac_reacher (2,048 updates; each of these three ends
    in an evaluation and saves its best model), offline_pendulum (its
    behavior corpus built with --corpus-steps 20,480, then 500 IQL
    updates), offline_pendulum_medium with each of --agent bc, awac and
    iql (1,000 updates and an evaluation over the committed
    pendulum-medium-v0) and play_pong (the committed JAX-trained policy,
    512 steps into a GIF, --no-render).  Each must return, its networks
    on the card and finite, what it wrote read back (event file, saved
    model loaded into a state on the card, corpus, GIF), its printed
    summary parse to finite numbers, and the pixel examples' gather
    launches equal their updates; one line each with its seconds;
26. the multi-GPU paths (border_tpu_torch.parallel): (a) ShardedTrainer in
    a world of one rank over NCCL (a FileStore in a temporary directory) at
    the uniform path's config, one env chunk and one update chunk of 512
    updates from the plain Trainer's states and generator state: agent
    state, ring and loss must equal the plain Trainer's (whose chunk is
    graphed) bitwise, for the sharded trainer graphed (its gradient
    all-reduce captured in the update's graph) and for its eager twin
    (cuda_graphs=False), whose all-reduces must count the same; 16 updates
    of each twin traced: the graphed one must make fewer host operator
    calls an update; the sharded update chunk timed once more; then one
    chunk of ShardedAsyncTrainer (graphed); (b) two ranks of this script on
    the one card over gloo (NCCL takes one rank per GPU; gloo collectives
    cannot be captured, so these run eagerly), the same global config
    (512 envs and batch 256 a rank): one env chunk and 512 updates, the
    parameters bitwise equal across the ranks, the loss finite, the gather
    launched on both ranks; (c) GSPMDTrainer at dp=1, tp=2 on those two
    ranks, the bf16 AtariCNN's five weights column-sharded: after the first
    update from the plain Trainer's ring and generator state, every element
    within 2·lr of the plain Trainer's and at most 5% of them beyond
    1e-3·lr (Adam's first step is lr·sign(g), and a bf16 gradient near 0
    may flip its sign under another summation order), then a chunk cut to
    6 env steps and 8 updates with a finite loss; (d) GSPMDTrainer at
    dp=2, tp=1 on those two ranks: 512 envs and half the ring's env
    columns (0.92 GB) a rank (ActorShardedFrames), the env step dp-fold;
    6 env steps from the plain Trainer's states and generator state must
    give the rank's env rows and ring columns bitwise, the first update
    the measure of (c), then a chunk of 6 env steps and 8 updates with a
    finite loss and the replicated parameters equal across the ranks;
    (e) the sharded_dqn example through main(argv), a world of one over
    NCCL, its defaults' width, --max-opts 1,000.  The ranks' gather
    launches count in the kernels line;
27. evaluation resets: for every registered env id at indices 0, 1 and
    10,007, VecEnv.reset_with_index on the card is bitwise the CPU's (obs
    and state: an index's reset is drawn on the CPU on every device); a
    fixed AWAC policy (seed 0's parameters) evaluated at awac_offline's
    config (200 episodes x 50 steps, Reacher with the goal-dict layout)
    from index 0 on the card and on the CPU: the same lengths, returns to
    rtol 1e-4 / atol 1e-3 (cuBLAS sums in another order; TF32 off);
28. border_tpu_torch.bench at full width, cut to 2 timed chunks and 20
    timed steps: the gather must launch once an update of the fused Pong
    bench (inside the captured update) and of its per-step twin, and the
    line hold bench.py's keys plus device, every rate finite and above 0;
29. border_tpu_torch.dryrun: entry()'s forward on the card, then
    dryrun_multichip(2), two gloo ranks on the one card (ShardedTrainer on
    CartPole with PER and on Pong, GSPMDTrainer dp=1 tp=2 flat and pixel,
    ShardedAsyncTrainer), its five lines; the ranks' gather launches count
    in the kernels line.

Then a ``{"kernels": [...]}`` line (the adam_step entry's ``launches``: the
Adam kernel launches of phases 6-29 in this process, each phase's counted
across its run), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet

# main-path shapes (bench.py's Pong config)
NUM_ENVS, CAPACITY, FRAME_HW, STACK = 1024, 256, (84, 84), 4
BATCH, STEPS_PER_CHUNK, OPT_INTERVAL = 512, 32, 64
UPDATE_CHUNKS = 2
TIMED_LAUNCHES = 60
SUM_TREE_LEAVES, SUM_TREE_REPS = 2**20, 20  # the dqn-pong.per cell's tree
# the Adam kernel's timing: a captured graph of ADAM_REPS steps that cycle
# over ADAM_COPIES copies of a state (DQN's and IQN's copies, 4 x 47-63 MB,
# so each step reads its state from device memory, not the 50 MB L2)
ADAM_REPS, ADAM_COPIES = 20, 4
# the prioritized path (the pong_per learning-gate config)
PER_CAPACITY, EVAL_EPISODES, EVAL_MAX_STEPS = 512, 10, 200
SLICE_GROUP = 64  # the JAX buffer's default
# the other pixel games (the seaquest, breakout, freeway and spaceinvaders
# learning-gate configs): 512 envs, a 512 x 512-frame ring
GAME_ENVS, GAME_CAPACITY, SEAQUEST_BATCH = 512, 512, 256
# the flat-buffer path (bench.py's fused CartPole config)
CART_ENVS, CART_STEPS, CART_OPT_INTERVAL, CART_CAPACITY = 4096, 64, 256, 65_536
# the learning-gate configs are border_tpu_torch/learning.py's (its tables
# CART_GATE, PEND_GATE, OFFLINE_GATE_OPTS, HOST_GATE, HOST_CAPACITY,
# HOST_EVAL and its builders); the whole cartpole run (phase 13) fails under
# CART_MIN_SCORE
CART_MIN_SCORE = 100.0
EVAL_KEYS = {"Episode return", "Episode return min", "Episode return max",
             "Episode length", "Episodes truncated"}
# the pendulum gate config (SAC, Gaussian actor, two critics) is cut to
# PEND_UPDATE_CHUNKS chunks of 256 updates
PEND_UPDATE_CHUNKS = 2
# awac_offline and iql_offline are cut to OFFLINE_CUT updates, their first
# evaluation moved there (the gate's first is at 2,000), to keep the
# script within its time
OFFLINE_CUT = 1_000
# bc_offline runs whole and fails under BC_MIN_SCORE (normalized)
BC_MIN_SCORE = 50.0
# the host-env gate configs, pendulum_host over NumpyPendulum (the card's
# machine has no gymnasium).  The card's runs: updates after the gate's
# warmup; pong_host's evaluations are cut to 200 of the gate's 3,000 steps
# and its resumed run goes on for HOST_RESUME_UPDATES more (both cut in half
# to keep the script within its time)
HOST_UPDATES = {"pong_host": 512, "breakout_host": 256, "pendulum_host": 512}
PONG_HOST_EVAL_STEPS, HOST_RESUME_UPDATES = 200, 128
# native CartPole through HostEnvTrainer, the JAX package's own host-path
# learning test (tests/test_host_trainer.py:40-72); fails under its 100
HOST_CART = dict(max_opts=1_500, warmup_period=500, opt_interval=16,
                 batch_size=64, num_envs=32, steps_per_chunk=8, eval_interval=500)
HOST_CART_MIN_SCORE = 100.0
# phase 26 (c): GSPMDTrainer's chunk at the uniform path's width is cut to
# GSPMD_ENV_STEPS env steps and GSPMD_UPDATES updates (each activation of the
# column-parallel layers crosses gloo through the host); after the first
# update at most GSPMD_MAX_FRAC of the elements may step differently from
# the plain Trainer's (bf16 gradients whose sign flips)
GSPMD_ENV_STEPS, GSPMD_UPDATES, GSPMD_MAX_FRAC = 6, 8, 0.05
# the JAX-trained Pong policy must reach the gate's Pong target on the card
PONG_TARGET = 18.0
# phase 25: the examples' depth, cut through their own --max-opts (each at
# its default width; the pixel ones after their 50,000-step warmups, the
# MLP ones to one evaluation at the end), offline_pendulum's corpus to
# EXAMPLE_CORPUS_STEPS transitions and play_pong to PLAY_STEPS steps
EXAMPLE_OPTS = {"async_dqn_pong": 2_048, "iqn_seaquest": 256, "dqn_pong_host": 256,
                "dqn_cartpole_native": 1_000, "sac_pendulum": 2_048,
                "sac_reacher": 2_048, "offline_pendulum": 500,
                "offline_pendulum_medium": 1_000}
EXAMPLE_CORPUS_STEPS, PLAY_STEPS = 20_480, 512
# phase 27: every registered env id's reset at these evaluation indices must
# be the CPU's bitwise; a fixed AWAC policy's evaluation at awac_offline's
# config (200 episodes of 50 steps) must give the CPU's returns to
# RESET_EVAL_RTOL / RESET_EVAL_ATOL (the MLP's sums run in another order in
# cuBLAS than on the CPU; TF32 is off)
RESET_INDICES, RESET_BASE_SEED = (0, 1, 10_007), 424242
RESET_EVAL_RTOL, RESET_EVAL_ATOL = 1e-4, 1e-3
# phase 28: the bench's fused benches cut to BENCH_CHUNKS timed chunks, its
# per-step benches to BENCH_STEPS timed steps; its line's keys
BENCH_CHUNKS, BENCH_STEPS = 2, 20
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_def",
              "vs_border_estimate", "border_estimate_band_env_steps_per_sec",
              "pong_updates_per_sec", "pong_ale_frames_per_sec",
              "pong_env_only_steps_per_sec", "baseline_env_steps_per_sec",
              "cartpole_env_steps_per_sec", "cartpole_vs_baseline", "device"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main(only=None) -> None:
    """``only``: phase numbers to run after phases 1-5 (a partial run, for
    working on a phase; it prints no result line)."""
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
    t_start = time.perf_counter()

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # -- 2. build: the kernel (nvcc) and the host envs (g++), started together --
    import concurrent.futures

    def timed_build(name):
        t = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t

    cxx = _build.cxx()
    cxx_version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout.splitlines()[0]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(timed_build, n)
                   for n in ("frame_gather", "sum_tree", "adam", "envpool")}
        built = {n: f.result() for n, f in futures.items()}
    print(f"build: frame_gather.cu with nvcc for sm_90a in "
          f"{built['frame_gather']:.2f} s, sum_tree.cu in "
          f"{built['sum_tree']:.2f} s, adam.cu in {built['adam']:.2f} s; "
          f"cpp/envpool.cpp with {cxx} "
          f"({cxx_version}) and cpp/Makefile's flags {' '.join(_build.CXX_FLAGS)} "
          f"in {built['envpool']:.2f} s, into {_build.library_path('envpool')}",
          flush=True)

    # -- 3. kernel vs plain version, bitwise --------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    m = NUM_ENVS * CAPACITY
    frames = torch.randint(0, 256, (m, *FRAME_HW), generator=g, device=dev,
                           dtype=torch.uint8)
    max_abs_err = 0.0
    # (shape, B, S, dtype, offset of the base in elements); frames whose
    # size or base is not 16-byte aligned take the kernel's byte path
    cases = [((m, *FRAME_HW), BATCH, STACK + 1, torch.uint8, 0),
             ((m, *FRAME_HW), BATCH, STACK, torch.uint8, 0),  # separate, n-step
             ((m, *FRAME_HW), SEAQUEST_BATCH, STACK + 1, torch.uint8, 0),
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
    # slice mode's indices: per sample one run of stack+1 consecutive
    # frames, its first c positions clamped to frame c (c = 0..stack-1)
    base = torch.randint(0, m - STACK - 1, (BATCH, 1), generator=g, device=dev)
    c = torch.randint(0, STACK, (BATCH, 1), generator=g, device=dev)
    runs = (base + torch.maximum(torch.arange(STACK + 1, device=dev)[None, :], c)
            ).to(torch.int32)
    if not torch.equal(gather_frames(frames, runs), gather_frames_ref(frames, runs)):
        fail("gather_frames disagrees with frames[idx] on runs of "
             "consecutive indices (slice mode)")
    print(f"kernel check: frame_gather bitwise equal to frames[idx] at "
          f"{len(cases)} shapes and on {BATCH} runs of {STACK + 1} consecutive "
          f"frames, max_abs_err {max_abs_err}", flush=True)
    other_ring_checks(torch, dev, g)

    # -- 4. timing -------------------------------------------------------------
    def time_ms(fn, idxs) -> float:
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
    launches0 = frame_gather.gather_frames.launches
    timings = {}
    for batch, width in ((BATCH, STACK + 1), (BATCH, STACK),
                         (SEAQUEST_BATCH, STACK + 1)):
        idxs = torch.randint(0, m, (TIMED_LAUNCHES + 5, batch, width),
                             generator=g, device=dev, dtype=torch.int32)
        gather_bytes = 2 * batch * width * frame_bytes + batch * width * 4
        t = {
            "ms": time_ms(lambda i: gather_frames(frames, i), idxs),
            "plain_ms": time_ms(lambda i: gather_frames_ref(frames, i), idxs),
            "library_ms": time_ms(lambda i: frames[i], idxs),
            "bound_ms": 1e3 * gather_bytes / HBM_BYTES_PER_S,
        }
        timings[batch, width] = t
        print(f"timing frame_gather [262144,84,84] uint8 x [{batch},{width}]: "
              + json.dumps({k: round(v, 5) for k, v in t.items()})
              + f" ({gather_bytes} B over 3.35 TB/s)", flush=True)
    frame_gather.gather_frames.launches = launches0
    timing = timings[BATCH, STACK + 1]
    bound_ms = timing["bound_ms"]
    del frames, idxs
    torch.cuda.empty_cache()

    # -- 5. the port against its CPU path on small inputs ------------------
    reference_checks(torch, dev)
    actor_critic_checks(torch, dev)
    sum_tree_check(torch, dev)
    tree_kernels = sum_tree_kernels(torch, dev)
    adam_entries = adam_kernels(torch, dev)
    from border_tpu_torch.ops import adam_step

    phase_s, adam_launches = {}, {}

    def timed(label, fn, *args, skipped=0, **kw):
        if only is not None and label.split()[0] not in only:
            return skipped
        t = time.perf_counter()
        n0 = adam_step.launches  # this process's Adam launches in the phase
        out = fn(*args, **kw)
        phase_s[label] = round(time.perf_counter() - t, 2)
        adam_launches[label] = adam_step.launches - n0
        return out

    # -- 6-14. the fused training paths --------------------------------------------
    launches = training_phases(torch, dev, timed)

    # -- 15-17. the offline family over the committed corpus ----------------------
    timed("15 bc_offline", offline_path, torch, dev, "bc_offline", None,
          min_score=BC_MIN_SCORE)
    timed("16 awac_offline", offline_path, torch, dev, "awac_offline", OFFLINE_CUT)
    timed("17 iql_offline", offline_path, torch, dev, "iql_offline", OFFLINE_CUT)

    # -- 18-21. the host-env paths: C++ envpool and Gymnasium-API envs ------------
    launches += timed("18 pong_host", pong_host_path, torch, dev)
    launches += timed("19 breakout_host", breakout_host_path, torch, dev)
    timed("20 pendulum_host", pendulum_host_path, torch, dev)
    timed("21 host cartpole", host_cartpole_learns, torch, dev)

    # -- 22. the decoupled actor-learner on Pong ----------------------------------
    launches += timed("22 async pong", async_pong_path, torch, dev)

    # -- 23-25. the utilities, the JAX-trained policy, the examples ---------------
    timed("23 utilities", utilities_on_card, torch, dev)
    timed("24 jax pong policy", jax_pong_policy, torch, dev)
    launches += timed("25 examples", examples_on_card, torch, dev)

    # -- 26. the multi-GPU paths: NCCL world of one, two ranks over gloo -------
    launches += timed("26 sharded", sharded_paths, torch, dev)

    # -- 27-29. evaluation resets, the bench, the dryrun ---------------------------
    timed("27 resets", reset_paths, torch, dev)
    launches += timed("28 bench", bench_path, torch, dev)
    launches += timed("29 dryrun", dryrun_path, torch, dev)

    kernels = [{
        "name": "frame_gather",
        "route": "cuda",
        "source": "border_tpu_torch/csrc/frame_gather.cu",
        "replaces": "border_tpu/ops/frame_gather.py:72",
        "launches": launches,
        "match": True,
        "max_abs_err": max_abs_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
        # the second shape the paths launch: [512, 4] indices
        "stack_width": {k: timings[BATCH, STACK][k] for k in
                        ("ms", "plain_ms", "bound_ms", "library_ms")},
        # the third: [256, 5] indices (the Seaquest path's batch)
        "batch_256": {k: timings[SEAQUEST_BATCH, STACK + 1][k] for k in
                      ("ms", "plain_ms", "bound_ms", "library_ms")},
    }, *tree_kernels, *adam_entries]
    adam_entries[0]["launches"] = sum(adam_launches.values())
    if only is None and adam_entries[0]["launches"] == 0:
        fail("no phase launched the Adam kernel")
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    if only is not None:
        print(f"partial run of phases 1-5 and {sorted(only)} passed in "
              f"{time.perf_counter() - t_start:.1f} s; no result line", flush=True)
        return
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def training_phases(torch, dev, timed) -> int:
    """Phases 6-14, each through ``timed(label, fn, *args, skipped=...)``
    (main's, which runs a phase or skips it, returning ``skipped``).
    Returns the gather launches."""
    # -- 6. the uniform path --------------------------------------------------
    launches, tr, r = timed("6 uniform", main_path, torch, dev,
                            skipped=(0, None, None))

    # -- 7. where a chunk's time goes ----------------------------------------
    if tr is not None:
        timed("7 uniform breakdown", breakdown, torch, tr, r, "uniform")
    del tr, r
    torch.cuda.empty_cache()

    # -- 8. the prioritized path, with evaluation, checkpoints and resume ---
    launches += timed("8 per", per_path, torch, dev)

    # -- 9. slice mode and n-step 3 -------------------------------------------
    launches += timed("9 modes", mode_paths, torch, dev)

    # -- 10. IQN on Seaquest ----------------------------------------------------
    launches += timed("10 seaquest", seaquest_path, torch, dev)

    # -- 11. Breakout, Freeway, Space Invaders -----------------------------------
    launches += timed("11 games", game_paths, torch, dev)

    # -- 12, 13. the flat-buffer path: CartPole fused, then a run that learns ----
    timed("12 cartpole fused", cartpole_fused_path, torch, dev)
    timed("13 cartpole learns", cartpole_learns, torch, dev)

    # -- 14. SAC on Pendulum --------------------------------------------------------
    timed("14 pendulum sac", pendulum_sac_path, torch, dev)
    return launches


def other_ring_checks(torch, dev, g) -> None:
    """The gather against its plain version, bitwise, on the rings of
    phases 8 and 9, filled with random bytes."""
    from border_tpu_torch.ops.frame_gather import gather_frames, gather_frames_ref
    from border_tpu_torch.replay import FrameReplayBuffer

    def rand_ring(*shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    # the prioritized path's ring: frames from `past` on lie wholly beyond
    # byte offset 2^31, and the second half of every batch reads there
    m = NUM_ENVS * PER_CAPACITY
    ring = rand_ring(m, *FRAME_HW)
    past = 2**31 // (FRAME_HW[0] * FRAME_HW[1]) + 1
    for width in (STACK + 1, STACK):
        idx = torch.randint(0, m, (BATCH, width), generator=g, device=dev,
                            dtype=torch.int32)
        idx[BATCH // 2:] = torch.randint(
            past, m, (BATCH - BATCH // 2, width), generator=g, device=dev,
            dtype=torch.int32)
        idx[-1, -1] = m - 1
        if not torch.equal(gather_frames(ring, idx), gather_frames_ref(ring, idx)):
            fail(f"gather_frames disagrees with frames[idx] on the "
                 f"prioritized path's ring [{m}, 84, 84] at {BATCH}x{width}")
    del ring
    torch.cuda.empty_cache()

    # the slice mode's ring through the buffer's own sample: the steps are
    # drawn over a wrapped ring, the ages make every clamp c = 0..stack-1
    buf = FrameReplayBuffer(capacity=CAPACITY, num_envs=NUM_ENVS,
                            sample_mode="slice", slice_group=SLICE_GROUP)
    st = buf.init()
    slots = CAPACITY + STACK + 1
    if tuple(st.frames.shape) != (NUM_ENVS, slots, *FRAME_HW):
        fail(f"slice ring of shape {tuple(st.frames.shape)}")
    st.frames = rand_ring(*st.frames.shape)
    st.age = torch.randint(0, 2 * STACK, st.age.shape, generator=g, device=dev,
                           dtype=torch.int32)
    st.total = 3 * CAPACITY + 17
    e, s = buf.draw(st, g, BATCH)
    batch = buf.sample_at(st, e, s)
    c = (STACK - 1 - st.age[e, s % CAPACITY].long()).clamp_min(0)
    js = torch.arange(STACK + 1, device=dev)
    idx = (e * slots + (s - (STACK - 1)) % CAPACITY)[:, None] + torch.maximum(
        js[None, :], c[:, None])
    flat = st.frames.view(-1, *FRAME_HW)
    ref = gather_frames_ref(flat, idx.to(torch.int32))
    if not (idx.max().item() < flat.shape[0] and len(c.unique()) == STACK
            and torch.equal(gather_frames(flat, idx.to(torch.int32)), ref)
            and torch.equal(batch.obs, ref[:, :STACK].permute(0, 2, 3, 1))
            and torch.equal(batch.next_obs, ref[:, 1:].permute(0, 2, 3, 1))):
        fail(f"gather_frames disagrees with frames[idx] on the slice mode's "
             f"ring [{flat.shape[0]}, 84, 84] at the buffer's own indices")
    print(f"kernel check: frame_gather bitwise equal to frames[idx] on the "
          f"prioritized path's ring [{m}, 84, 84] ({BATCH}x{STACK + 1} and "
          f"{BATCH}x{STACK} indices, half of them past byte offset 2^31) and on "
          f"the slice mode's ring [{flat.shape[0]}, 84, 84] (env stride {slots}, "
          f"the buffer's own {BATCH}x{STACK + 1} indices)", flush=True)
    del st, batch, flat, ref
    torch.cuda.empty_cache()


def reference_descent(torch, sum_tree, u):
    """The JAX tree's descent (border_tpu/replay/sum_tree.py:111-131) for
    the injected draws ``u``: no test for a dead right subtree."""
    b, cap = u.shape[0], sum_tree.shape[0] // 2
    mass = (torch.arange(b, dtype=torch.float32, device=u.device) + u) * (
        sum_tree[1] / b)
    nodes = torch.ones(b, dtype=torch.int64, device=u.device)
    for _ in range(cap.bit_length() - 1):
        left = 2 * nodes
        left_sum = sum_tree[left]
        go_right = mass >= left_sum
        nodes = left + go_right
        mass = torch.where(go_right, mass - left_sum, mass)
    return nodes - cap


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

    # one float32 IQN update (CNN psi) with the same quantile fractions
    import functools

    from border_tpu_torch.agents import IQN, IQNConfig

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        iqn = IQN(IQNConfig(
            psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True,
                                     dtype=torch.float32),
            feature_dim=64, n_cos=16, hidden=(64,), lr=1e-4))
        taus = (torch.rand((b, 8), generator=bg), torch.rand((b, 8), generator=bg),
                ((torch.arange(32.0) + 0.5) / 32).expand(b, 32))
        out = {}
        for d in (cpu, dev):
            st = iqn.init(0, obs_space, act_space, device=d)
            _, m, td = iqn.update(
                st, TransitionBatch(**{k: v.to(d) for k, v in batch.items()}),
                taus=tuple(t.to(d) for t in taus))
            out[d] = (m["loss"].item(), td.cpu())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if not (math.isclose(out[dev][0], out[cpu][0], rel_tol=1e-4)
            and torch.allclose(out[dev][1], out[cpu][1], rtol=1e-4, atol=1e-5)):
        fail(f"IQN update differs: loss {out[dev][0]} vs {out[cpu][0]}, td "
             f"errors by {(out[dev][1] - out[cpu][1]).abs().max().item()}")
    print(f"reference check: float32 IQN update (CNN psi, batch {b}, injected "
          f"quantile fractions) loss {out[dev][0]:.6g} vs {out[cpu][0]:.6g} on "
          f"the CPU, td errors within rtol 1e-4 / atol 1e-5", flush=True)


def sum_tree_check(torch, dev) -> None:
    """The sum tree at 2^19 leaves on the card against the port's CPU path:
    the same update batches (a push-sized one with dead leaves, then
    batch-sized ones whose duplicate indices carry different priorities)
    and the same injected uniforms."""
    from border_tpu_torch.replay import SumTree

    leaves = NUM_ENVS * PER_CAPACITY
    g = torch.Generator().manual_seed(4)
    trees = {d: SumTree(leaves, device=d) for d in ("cpu", dev)}
    states = {d: t.init() for d, t in trees.items()}
    batches = []
    idx = torch.randperm(leaves, generator=g)[: NUM_ENVS * (STACK + 1) * 40]
    pr = torch.rand(idx.shape, generator=g) * 2 + 0.01
    pr[torch.rand(idx.shape, generator=g) < 0.2] = 0.0
    batches.append((idx, pr))
    for _ in range(4):
        i = idx[torch.randint(0, len(idx), (BATCH,), generator=g)]
        i[BATCH // 2:] = i[: BATCH // 2]  # every index twice, two priorities
        batches.append((i, torch.rand(BATCH, generator=g) * 5 + 1e-3))
    for i, p in batches:
        for d, t in trees.items():
            t.update(states[d], i.to(d), p.to(d))
    u = torch.rand(BATCH, generator=g)
    got = {d: t.sample(states[d], BATCH, u=u.to(d)) for d, t in trees.items()}
    w = {d: t.weights(states[d], got[d], 500_000, 0.5) for d, t in trees.items()}
    torch.cuda.synchronize()
    if not torch.equal(got[dev].cpu(), got["cpu"]):
        fail("sum tree: the card samples other leaves than the CPU path")
    if not (states["cpu"].sum_tree[leaves + got["cpu"]] > 0).all():
        fail("sum tree: a sampled leaf has no priority")
    total_c, total_g = (trees[d].total(states[d]).item() for d in ("cpu", dev))
    close = dict(rtol=1e-6, atol=0.0)
    if not (math.isclose(total_c, total_g, rel_tol=1e-6)
            and torch.allclose(states[dev].sum_tree.cpu(), states["cpu"].sum_tree, **close)
            and torch.equal(states[dev].min_tree.cpu(), states["cpu"].min_tree)
            and torch.allclose(w[dev].cpu(), w["cpu"], **close)):
        fail(f"sum tree: totals {total_g} vs {total_c} or weights differ "
             f"by more than 1e-6 relative")
    print(f"sum tree check: {leaves} leaves, {len(batches)} update batches "
          f"with duplicate indices, {BATCH} injected uniforms: same leaves on "
          f"the card and the CPU, total {total_g:.6f} vs {total_c:.6f}, "
          f"weights within 1e-6 relative", flush=True)


def sum_tree_kernels(torch, dev) -> list:
    """The sum tree's update and descent kernels against their plain loops
    on the same card tensors, bitwise, at the prioritized cell's shapes;
    then each timed as a captured graph of SUM_TREE_REPS calls, as the
    trainer's graphs replay them.  Returns the result line's entries."""
    from border_tpu_torch.ops import (sum_tree_sample, sum_tree_sample_ref,
                                      sum_tree_update, sum_tree_update_ref)
    from border_tpu_torch.replay import SumTree

    cap, depth = SUM_TREE_LEAVES, SUM_TREE_LEAVES.bit_length() - 1
    g = torch.Generator(device=dev).manual_seed(5)
    kern = SumTree(cap, device=dev).init()
    idx = torch.randperm(cap, generator=g, device=dev)[: cap // 2]
    pr = torch.rand(idx.shape, generator=g, device=dev) * 2 + 0.01
    pr[torch.rand(idx.shape, generator=g, device=dev) < 0.2] = 0.0
    sum_tree_update_ref(kern.sum_tree, kern.min_tree, kern.max_priority, idx, pr)
    plain = type(kern)(*(x.clone() for x in (kern.sum_tree, kern.min_tree,
                                              kern.max_priority)))
    # FrameReplayBuffer._tree_push: 1024 envs x 5 slots, 4 zeroed and one
    # entering at the max priority
    envs, slots = 1024, cap // 1024
    push_idx = ((torch.arange(envs, device=dev) * slots)[:, None]
                + (17 + torch.arange(STACK + 1, device=dev))).reshape(-1)
    enters = torch.tensor([0.0] * STACK + [1.0], device=dev)

    def push_prio(st):
        return (enters * st.max_priority)[None, :].expand(envs, -1).reshape(-1)

    upd_idx = torch.randint(0, cap, (BATCH,), generator=g, device=dev)
    upd_idx[BATCH // 2:] = upd_idx[: BATCH // 2]  # two priorities each
    upd_pr = torch.rand(BATCH, generator=g, device=dev) * 3 + 1e-3
    u = torch.rand(BATCH, generator=g, device=dev)
    u[-1] = 1 - 2.0**-24
    leaves = []
    for st, update, sample in ((kern, sum_tree_update, sum_tree_sample),
                               (plain, sum_tree_update_ref, sum_tree_sample_ref)):
        update(st.sum_tree, st.min_tree, st.max_priority, push_idx, push_prio(st))
        update(st.sum_tree, st.min_tree, st.max_priority, upd_idx, upd_pr)
        leaves.append(sample(st.sum_tree, u))
    torch.cuda.synchronize()
    for name in ("sum_tree", "min_tree", "max_priority"):
        if not torch.equal(getattr(kern, name), getattr(plain, name)):
            fail(f"sum-tree kernels: {name} differs from the plain loop's")
    if not torch.equal(*leaves):
        fail("sum-tree kernels: the descent's leaves differ from the plain loop's")

    def graph_us(fn) -> float:
        """Device µs a call of ``fn`` inside a captured graph (median of
        five replays of SUM_TREE_REPS calls)."""
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()  # warm-up off the capture
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(SUM_TREE_REPS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda._sleep(50_000_000)
        ev[0].record()
        for e in ev[1:]:
            graph.replay()
            e.record()
        torch.cuda.synchronize()
        return 1e3 * statistics.median(
            a.elapsed_time(b) for a, b in zip(ev, ev[1:])) / SUM_TREE_REPS

    st, ps = kern, plain
    u1 = u[:1].clone()
    cases = {
        # (kernel, plain, bytes: each touched node's 4-byte sum and min read
        # twice, as both children, and written once, plus the inputs)
        "push": (lambda: sum_tree_update(st.sum_tree, st.min_tree, st.max_priority,
                                         push_idx, push_prio(st)),
                 lambda: sum_tree_update_ref(ps.sum_tree, ps.min_tree,
                                             ps.max_priority, push_idx,
                                             push_prio(ps)),
                 push_idx.numel() * (depth * 2 * 12 + 12)),
        "update": (lambda: sum_tree_update(st.sum_tree, st.min_tree,
                                           st.max_priority, upd_idx, upd_pr),
                   lambda: sum_tree_update_ref(ps.sum_tree, ps.min_tree,
                                               ps.max_priority, upd_idx, upd_pr),
                   BATCH * (depth * 2 * 12 + 12)),
        "descent": (lambda: sum_tree_sample(st.sum_tree, u),
                    lambda: sum_tree_sample_ref(ps.sum_tree, u),
                    BATCH * (depth * 8 + 12)),
        "descent_1": (lambda: sum_tree_sample(st.sum_tree, u1),
                      lambda: sum_tree_sample_ref(ps.sum_tree, u1),
                      depth * 8 + 12),
    }
    launches0 = (sum_tree_update.launches, sum_tree_sample.launches)
    times = {}
    for name, (kernel, ref, nbytes) in cases.items():
        times[name] = {"us": graph_us(kernel), "plain_us": graph_us(ref),
                       "bound_us": 1e6 * nbytes / HBM_BYTES_PER_S,
                       "bound_by": "bytes; the chain of %d levels" % depth}
        print(f"timing sum tree {name} at 2^{depth} leaves (graph of "
              f"{SUM_TREE_REPS} calls): " + json.dumps(
                  {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in times[name].items()}), flush=True)
    sum_tree_update.launches, sum_tree_sample.launches = launches0
    print(f"kernel check: the sum-tree update (push of {push_idx.numel()}, "
          f"write of {BATCH} with duplicates) and descent ({BATCH} lanes, "
          f"u = 1 - 2^-24 among them) bitwise equal to the plain loops at "
          f"2^{depth} leaves", flush=True)
    del kern, plain
    torch.cuda.empty_cache()
    return [{"name": "sum_tree_update", "route": "cuda",
             "source": "border_tpu_torch/csrc/sum_tree.cu", "replaces": None,
             "match": True, "push": times["push"], "update": times["update"]},
            {"name": "sum_tree_sample", "route": "cuda",
             "source": "border_tpu_torch/csrc/sum_tree.cu", "replaces": None,
             "match": True, "descent": times["descent"],
             "descent_1": times["descent_1"]}]


def _adam_lists(torch, dev, kind: str) -> list:
    """The optimizers' parameter lists of the benchmark's agents, one list
    an optimizer: DQN's (the Nature torso and head), IQN's, and SAC's
    critics, actor and one-element log alpha at 2 x 256."""
    import functools

    from border_tpu_torch.agents import DQN, IQN, SAC, DQNConfig, IQNConfig, SACConfig
    from border_tpu_torch.core import spaces
    from border_tpu_torch.models import AtariCNN

    pixels = spaces.Box(0, 255, (84, 84, 4), torch.uint8)
    if kind == "dqn":
        st = DQN(DQNConfig(model=lambda n: AtariCNN(n))).init(
            0, pixels, spaces.Discrete(6), device=dev)
        return [list(st.params.parameters())]
    if kind == "iqn":
        st = IQN(IQNConfig(psi_fn=functools.partial(AtariCNN, out_dim=0,
                                                    skip_linear=True),
                           feature_dim=512, n_cos=64, hidden=(512,))).init(
            0, pixels, spaces.Discrete(6), device=dev)
        return [list(st.params.parameters())]
    st = SAC(SACConfig(actor_hidden=(256, 256), critic_hidden=(256, 256))).init(
        0, spaces.Box(-1.0, 1.0, (3,), torch.float32),
        spaces.Box(-2.0, 2.0, (1,), torch.float32), device=dev)
    return [list(st.critic_params.parameters()),
            list(st.actor_params.parameters()), [st.log_alpha]]


def adam_kernels(torch, dev) -> list:
    """The Adam kernel's optimizer against torch's capturable Adam at
    DQN's, IQN's and SAC's parameter lists (SAC: its three optimizers, an
    update's three steps) on the same gradients: parameters, moments and
    step counts bitwise after three eager steps and three replays of a
    captured step.  Then each timed inside a captured graph of ADAM_REPS
    steps cycling over ADAM_COPIES copies, beside the least time its bytes
    take (28 B an element: p, g, m, v read, p, m, v written, over 3.35
    TB/s) and torch's capturable multi-tensor step timed the same way
    (library_ms).  SAC's three steps are bound by launch latency, not
    bytes.  Returns the result line's entry."""
    from border_tpu_torch.ops.adam import KernelAdam, adam_step

    g = torch.Generator(device=dev).manual_seed(9)

    def copies(lists, cls, n):
        out = []
        for _ in range(n):
            params = [[p.detach().clone().requires_grad_() for p in ps]
                      for ps in lists]
            for p in (p for ps in params for p in ps):
                p.grad = torch.zeros_like(p)
            out.append((params, [cls(ps, lr=torch.tensor(1e-4, device=dev),
                                     capturable=True) for ps in params]))
        return out

    def new_grads(sides):
        flat = [[p for ps in params for p in ps] for params, _ in sides]
        for ps in zip(*flat):
            x = torch.randn(ps[0].shape, generator=g, device=dev) * 10.0 ** (
                torch.randint(-9, 2, ps[0].shape, generator=g, device=dev))
            for p in ps:
                p.grad.copy_(x)

    def step(side):
        for opt in side[1]:
            opt.step()

    def graph_ms(sides) -> float:
        """Device ms a step (of every optimizer of a copy) inside a graph
        of ADAM_REPS steps over the copies (median of five replays)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for r in range(ADAM_REPS):
                step(sides[r % len(sides)])
        graph.replay()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda._sleep(50_000_000)
        ev[0].record()
        for e in ev[1:]:
            graph.replay()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(
            a.elapsed_time(b) for a, b in zip(ev, ev[1:])) / ADAM_REPS

    out = {}
    for kind in ("dqn", "iqn", "sac"):
        lists = _adam_lists(torch, dev, kind)
        elements = sum(p.numel() for ps in lists for p in ps)
        kern, ref = copies(lists, KernelAdam, 1)[0], copies(lists, torch.optim.Adam, 1)[0]
        n0 = adam_step.launches
        for i in range(3):
            new_grads([kern, ref])
            step(kern)
            step(ref)
        if adam_step.launches != n0 + 3 * len(lists):
            fail(f"adam {kind}: {adam_step.launches - n0} launches for "
                 f"{3 * len(lists)} steps")
        graphs = []
        for side in (kern, ref):
            graphs.append(torch.cuda.CUDAGraph())
            with torch.cuda.graph(graphs[-1]):
                step(side)
        for i in range(3):
            new_grads([kern, ref])
            for graph in graphs:
                graph.replay()
        torch.cuda.synchronize()
        for (ps_k, ps_r), (ok, orf) in zip(zip(kern[0], ref[0]), zip(kern[1], ref[1])):
            for pk, pr in zip(ps_k, ps_r):
                same = torch.equal(pk, pr) and all(
                    torch.equal(ok.state[pk][k], orf.state[pr][k])
                    for k in ("step", "exp_avg", "exp_avg_sq"))
                if not same:
                    fail(f"adam {kind}: the kernel's step differs from torch's "
                         f"capturable Adam at a {tuple(pk.shape)} parameter")
        del graphs, kern, ref
        timing = {}
        for label, cls in (("ms", KernelAdam), ("library_ms", torch.optim.Adam)):
            sides = copies(lists, cls, ADAM_COPIES)
            new_grads(sides)
            for side in sides:
                step(side)  # each copy's state made
            timing[label] = graph_ms(sides)
            del sides
        nbytes = 28 * elements
        timing["bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
        timing["bound_by"] = "bytes" if kind != "sac" else (
            "launch latency (bytes: %.5f ms)" % timing["bound_ms"])
        out[kind] = {"elements": elements, "steps": len(lists), **timing}
        print(f"timing adam {kind}, {len(lists)} step(s) over {elements} "
              f"elements (graph of {ADAM_REPS} over {ADAM_COPIES} copies): "
              + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in out[kind].items()})
              + f" ({nbytes} B over 3.35 TB/s)", flush=True)
        torch.cuda.empty_cache()
    print("kernel check: the Adam kernel bitwise equal to torch's capturable "
          "Adam over DQN's, IQN's and SAC's parameters (3 eager steps, 3 "
          "graph replays)", flush=True)
    return [{"name": "adam_step", "route": "cuda",
             "source": "border_tpu_torch/csrc/adam.cu", "replaces": None,
             "match": True, **out}]


def actor_critic_checks(torch, dev) -> None:
    """Reacher steps, and float32 SAC, AWAC and IQL updates at their gate
    configs' widths with the same injected draws, on the card and on the
    port's CPU path."""
    from border_tpu_torch.agents import AWAC, IQL, SAC, AWACConfig, IQLConfig, SACConfig
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import TransitionBatch

    cpu = torch.device("cpu")
    # 45 steps: short of the 50-step episode end, whose resets draw from
    # each device's own generator
    env = make("Reacher-v0")
    vg, vc = VecEnv(env, 256, device=dev), VecEnv(env, 256, device=cpu)
    sg = vg.reset(0)
    sc = to_device(sg, cpu, torch)
    rng = torch.Generator().manual_seed(5)
    worst = 0.0
    for _ in range(45):
        a = torch.rand((256, 2), generator=rng) * 2.4 - 1.2
        tg, sg = vg.step(sg, a.to(dev))
        tc, sc = vc.step(sc, a)
        for got, want in [(tg.reward, tc.reward)] + [
                (sg.obs[k], sc.obs[k]) for k in sc.obs]:
            worst = max(worst, (got.cpu() - want).abs().max().item())
            if not torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6):
                fail(f"Reacher on the card differs from the CPU path by {worst}")
    print(f"reference check: 45 Reacher steps x 256 envs within 1e-6 of the CPU "
          f"path (max abs diff {worst:.3g})", flush=True)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reacher = make("ReacherFlat-v0")
        pend = make("Pendulum-v1")
        cases = (
            ("SAC", SAC(SACConfig(actor_hidden=(128, 128), critic_hidden=(128, 128),
                                  n_critics=2)), pend, 128, True),
            ("AWAC", AWAC(AWACConfig(actor_hidden=(256, 256),
                                     critic_hidden=(256, 256), lambda_=10.0)),
             reacher, 256, True),
            ("IQL", IQL(IQLConfig()), reacher, 256, False))
        for label, agent, e, b, draws in cases:
            p = e.default_params
            obs_space, act_space = e.observation_space(p), e.action_space(p)
            od, ad = obs_space.flat_dim, act_space.flat_dim
            g = torch.Generator().manual_seed(6)
            batch = dict(
                obs=torch.randn((b, od), generator=g),
                act=torch.rand((b, ad), generator=g) * 2 - 1,
                next_obs=torch.randn((b, od), generator=g),
                reward=torch.randn(b, generator=g),
                terminated=torch.rand(b, generator=g) < 0.1,
                truncated=torch.zeros(b, dtype=torch.bool))
            noise = tuple(torch.randn((b, ad), generator=g) for _ in range(2))
            out = {}
            for d in (cpu, dev):
                st = agent.init(0, obs_space, act_space, device=d)
                kw = {"noise": tuple(z.to(d) for z in noise)} if draws else {}
                _, m, td = agent.update(
                    st, TransitionBatch(**{k: v.to(d) for k, v in batch.items()}), **kw)
                out[d] = ({k: float(v) for k, v in m.items()}, td.cpu())
            torch.cuda.synchronize()
            (mg, tdg), (mc, tdc) = out[dev], out[cpu]
            bad = [k for k in mc if not math.isclose(mg[k], mc[k], rel_tol=1e-4,
                                                      abs_tol=1e-6)]
            if bad or not torch.allclose(tdg, tdc, rtol=1e-4, atol=1e-5):
                fail(f"{label} update on the card differs from the CPU path: "
                     f"{bad} {mg} vs {mc}; td by {(tdg - tdc).abs().max().item()}")
            print(f"reference check: float32 {label} update (batch {b}"
                  f"{', injected normal draws' if draws else ''}) within rtol 1e-4 "
                  f"of the CPU path: " + json.dumps(mg), flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def to_device(x, device, torch):
    """A copy of a (nested) dataclass or dict of tensors on ``device``; a
    CUDA generator becomes a CPU one (its draws are not compared)."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_device(getattr(x, f.name), device, torch)
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: to_device(v, device, torch) for k, v in x.items()}
    if isinstance(x, torch.Generator):
        return torch.Generator(device=device).manual_seed(0)
    return x.to(device)


def main_path(torch, dev):
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.ops import adam_step, frame_gather
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

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
    rec = _chunk_recorder()
    tr = Trainer(env, agent, buf, cfg, recorder=rec)
    if tr.updates_per_chunk != updates_per_chunk:
        fail(f"updates_per_chunk {tr.updates_per_chunk} != {updates_per_chunk}")
    if not tr.cuda_graphs:
        fail("the Trainer on the card does not run its chunk as CUDA graphs")
    # train() draws its initial parameters from seed 0 on the CPU, as here
    before = [p.detach().clone() for p in agent.init(
        0, tr.vec.observation_space, tr.vec.action_space).params.parameters()]

    torch.cuda.reset_peak_memory_stats()
    # the counts are read just before the main path and just after
    frame_gather.gather_frames.launches = 0
    adam0 = adam_step.launches
    r = tr.train(seed=0)
    torch.cuda.synchronize()
    launches = frame_gather.gather_frames.launches
    adam_launches = adam_step.launches - adam0

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
    if adam_launches != r.opt_steps:  # one Adam step an update
        fail(f"the Adam kernel launched {adam_launches} times for "
             f"{r.opt_steps} updates")
    if r.buffer_state.total != (UPDATE_CHUNKS + 1) * STEPS_PER_CHUNK:
        fail(f"buffer holds {r.buffer_state.total} pushes")
    obs = r.buffer_state.frames[:4, 0, :, :, None].expand(-1, -1, -1, 4)
    with torch.no_grad():  # no autograd graph left holding the parameters
        q = r.agent_state.params(obs)
    if q.shape != (4, 6) or not torch.isfinite(q).all():
        fail(f"Q values of shape {tuple(q.shape)} not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same run with the eager chunk: the same states, bitwise
    rec_e = _chunk_recorder()
    tr_e = Trainer(env, agent, buf, cfg, recorder=rec_e, cuda_graphs=False)
    frame_gather.gather_frames.launches = 0
    adam0 = adam_step.launches
    r_e = tr_e.train(seed=0)
    torch.cuda.synchronize()
    launches_e = frame_gather.gather_frames.launches
    if adam_step.launches - adam0 != adam_launches:
        fail(f"the eager run launched the Adam kernel "
             f"{adam_step.launches - adam0} times, the graphed {adam_launches}")
    chunks_e = [c for c in rec_e.chunks if "opt_steps_per_sec" in c]
    diff = _state_diff(torch, {"agent": r.agent_state, "replay": r.buffer_state},
                       {"agent": r_e.agent_state, "replay": r_e.buffer_state})
    if diff or [c["loss"] for c in chunks_e] != losses or launches_e != launches:
        fail(f"the graphed and the eager runs differ: {diff[:8]}, losses "
             f"{losses} vs {[c['loss'] for c in chunks_e]}, launches "
             f"{launches} vs {launches_e}")

    # per update chunk (32 env steps, then 512 updates): env-steps/s and
    # updates/s over the chunk's wall time, which ends in a device sync
    eps = [c["samples_per_sec"] for c in chunks]
    ups = [c["opt_steps_per_sec"] for c in chunks]
    result = {
        "env_steps": r.env_steps, "updates": r.opt_steps,
        "update_chunks": UPDATE_CHUNKS, "gather_launches": launches,
        "adam_launches": adam_launches,
        "final_loss": losses[-1],
        "env_steps_per_s_chunks": eps, "updates_per_s_chunks": ups,
        "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
        "eager_env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks_e],
        "eager_updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks_e],
        "eager_warmup_chunk_env_steps_per_s": rec_e.chunks[0]["samples_per_sec"],
        "graphed_equals_eager_bitwise": True,
        "max_memory_allocated_gb": peak_gb,
    }
    print(f"uniform path: Trainer.train() Pong, {NUM_ENVS} envs, batch {BATCH}, "
          f"{r.opt_steps} updates in {UPDATE_CHUNKS} update chunks, the chunk "
          f"as CUDA-graph replays; env-steps/s {eps[-1]:.1f}, updates/s "
          f"{ups[-1]:.2f} (last chunk; eager chunk "
          f"{chunks_e[-1]['samples_per_sec']:.1f} and "
          f"{chunks_e[-1]['opt_steps_per_sec']:.2f}, the same states bitwise); "
          f"final loss {losses[-1]:.6g}; frame_gather and Adam kernel "
          f"launches {launches} and {adam_launches} = updates {r.opt_steps}",
          flush=True)
    print("uniform path numbers: " + json.dumps(result), flush=True)
    return launches + launches_e, tr, r


def _packed_leaves(tree, prefix=""):
    """(path, leaf) pairs of a state packed by ``pack_state``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packed_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _equal(a, b) -> bool:
    """``torch.equal`` in pieces of 256 Mi elements: on the card it makes a
    mask as large as its operands, a third ring's worth for a ring."""
    return a.shape == b.shape and all(
        x.equal(y) for x, y in zip(a.reshape(-1).split(1 << 28),
                                          b.reshape(-1).split(1 << 28)))


def _state_diff(torch, a, b):
    """Paths where two states packed by ``pack_state`` differ."""
    from border_tpu_torch.utils.checkpoint import pack_state

    a, b = dict(_packed_leaves(pack_state(a))), dict(_packed_leaves(pack_state(b)))
    if a.keys() != b.keys():
        return sorted(a.keys() ^ b.keys())
    return [k for k in a if not (
        _equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k])]


def _chunk_recorder():
    from border_tpu_torch.record import NullRecorder

    class ChunkRecorder(NullRecorder):
        """Keeps the record the trainer stores for every chunk, and the
        records written at once (evaluations)."""

        def __init__(self):
            super().__init__()
            self.chunks, self.written = [], []

        def store(self, record):
            self.chunks.append(record)

        def write_at(self, record, step):
            self.written.append(record)

    return ChunkRecorder()


def per_path(torch, dev) -> int:
    """Phase 8.  Returns the gather launches of its two runs."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig
    from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
    from border_tpu_torch.utils import CheckpointManager

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    class TimedEvaluator(Evaluator):
        seconds = ()

        def evaluate(self, *a, **kw):
            out, t = timed(lambda: super(TimedEvaluator, self).evaluate(*a, **kw))
            self.seconds += (t,)
            return out

    class TimedManager(CheckpointManager):
        save_s, restore_s = (), ()

        def save(self, *a, **kw):
            _, t = timed(lambda: super(TimedManager, self).save(*a, **kw))
            self.save_s += (t,)

        def restore(self, *a, **kw):
            out, t = timed(lambda: super(TimedManager, self).restore(*a, **kw))
            self.restore_s += (t,)
            return out

    upc = STEPS_PER_CHUNK * NUM_ENVS // OPT_INTERVAL

    def build(manager):
        agent = DQN(DQNConfig(model=lambda n: AtariCNN(n), lr=1e-4,
                              double_dqn=True, soft_update_interval=2_000,
                              tau=1.0, eps_final_step=2_000_000))
        buf = FrameReplayBuffer(capacity=PER_CAPACITY, num_envs=NUM_ENVS,
                                per=PerConfig(n_opts_final=50_000))
        cfg = TrainerConfig(
            num_envs=NUM_ENVS, steps_per_chunk=STEPS_PER_CHUNK, batch_size=BATCH,
            opt_interval=OPT_INTERVAL, warmup_period=0, eval_interval=upc,
            max_opts=2 * upc)
        rec = _chunk_recorder()
        ev = TimedEvaluator(make("Pong-v0", train=False),
                            n_episodes=EVAL_EPISODES, max_steps=EVAL_MAX_STEPS)
        tr = Trainer(make("Pong-v0"), agent, buf, cfg, recorder=rec,
                     evaluator=ev, checkpoint_manager=manager,
                     checkpoint_interval=upc if manager else 0)
        return tr, rec, ev

    work = tempfile.mkdtemp(prefix="border_smoke_")
    try:
        free_gb = shutil.disk_usage(work).free / 1e9
        if free_gb < 9:
            fail(f"{work} has {free_gb:.1f} GB free; two checkpoints of "
                 f"3.75 GB need 9")
        # -- the uninterrupted run: warmup chunk, two update chunks ---------
        mgr = TimedManager(os.path.join(work, "whole"), max_to_keep=2)
        tr, rec, ev = build(mgr)
        torch.cuda.reset_peak_memory_stats()
        frame_gather.gather_frames.launches = 0
        r = tr.train(seed=0)
        torch.cuda.synchronize()
        launches = frame_gather.gather_frames.launches

        chunks = [c for c in rec.chunks if "opt_steps_per_sec" in c]
        losses = [c["loss"] for c in chunks]
        if len(chunks) != 2 or not all(map(math.isfinite, losses)):
            fail(f"PER path: update chunks {len(chunks)}, losses {losses}")
        if r.opt_steps != 2 * upc or launches != r.opt_steps:
            fail(f"PER path: frame_gather launched {launches} times for "
                 f"{r.opt_steps} updates")
        tree, cap = r.buffer_state.tree, tr.buffer.tree.capacity
        total = tree.sum_tree[1].item()
        if not (math.isfinite(total) and total > 0):
            fail(f"PER path: the tree's total is {total}")
        # every leaf the sampler draws from the final state has priority
        g = torch.Generator(device=dev).manual_seed(9)
        for _ in range(32):
            e, s, w = tr.buffer.draw_per(r.buffer_state, g, BATCH, r.opt_steps)
            leaf = e * PER_CAPACITY + s % PER_CAPACITY
            if not ((tree.sum_tree[cap + leaf] > 0).all()
                    and torch.isfinite(w).all() and (w > 0).all()):
                fail("PER path: a sampled leaf has no priority")
        # the JAX tree's descent on this tree with the same draws: random
        # ones, then batches whose top stratum draws u = 1 - 2^-24, which
        # puts its mass point at the total (511 + u rounds up to 512)
        n_random, n_top = 128, 64
        dead_random = dead_top = 0
        for i in range(n_random + n_top):
            u = torch.rand(BATCH, generator=g, device=dev)
            if i >= n_random:
                u[-1] = 1 - 2.0 ** -24
            want = reference_descent(torch, tree.sum_tree, u)
            got = tr.buffer.tree.sample(tree, BATCH, u=u)
            live = tree.sum_tree[cap + want] > 0
            if not ((tree.sum_tree[cap + got] > 0).all()
                    and torch.equal(got[live], want[live])):
                fail("PER path: the descent left the reference's where that "
                     "one is live, or returned a dead leaf")
            if i < n_random:
                dead_random += int((~live).sum())
            else:
                dead_top += int(~live[-1])
        evals = [w_ for w_ in rec.written if "Episode return" in w_]
        if len(evals) != 2 or any({k for k, _ in w_} != EVAL_KEYS for w_ in evals):
            fail(f"PER path: evaluation records {[dict(w_.items()) for w_ in evals]}")
        if len(r.eval_history) != 2 or mgr.all_steps() != [upc, 2 * upc]:
            fail(f"PER path: evaluations {r.eval_history}, checkpoints "
                 f"{mgr.all_steps()}")
        ckpt_gb = os.path.getsize(mgr._path(upc)) / 1e9

        # -- a second trainer resumed from the FIRST checkpoint -------------
        os.makedirs(os.path.join(work, "killed"))
        os.rename(os.path.dirname(mgr._path(upc)),
                  os.path.join(work, "killed", str(upc)))
        mgr2 = TimedManager(os.path.join(work, "killed"))
        tr2, rec2, _ = build(None)
        # in this run every draw of the path is checked for residency (five
        # more small launches an update, so its times are not reported)
        dead = torch.zeros((), dtype=torch.int64, device=dev)
        draw_per = tr2.buffer.draw_per

        def checked_draw(state, *a, **kw):
            e, s, w = draw_per(state, *a, **kw)
            leaf = e * PER_CAPACITY + s % PER_CAPACITY
            dead.add_((state.tree.sum_tree[cap + leaf] == 0).sum())
            return e, s, w

        tr2.buffer.draw_per = checked_draw
        frame_gather.gather_frames.launches = 0
        r2 = tr2.train(seed=0, resume_from=mgr2)
        torch.cuda.synchronize()
        launches2 = frame_gather.gather_frames.launches
        if r2.opt_steps != 2 * upc or launches2 != upc:
            fail(f"resumed run: {r2.opt_steps} updates, {launches2} launches")
        if dead.item():
            fail(f"resumed run: {dead.item()} sampled leaves had no priority")
        if r2.buffer_state.total != r.buffer_state.total:
            fail("resumed run: another number of pushes")
        for name in ("agent_state", "buffer_state"):
            bad = _state_diff(torch, getattr(r, name), getattr(r2, name))
            if bad:
                fail(f"resumed run differs from the uninterrupted run in "
                     f"{name}: {bad[:8]}")
        if r2.eval_history != r.eval_history[1:]:
            fail(f"resumed run's evaluations {r2.eval_history} vs "
                 f"{r.eval_history[1:]}")

        result = {
            "env_steps": r.env_steps, "updates": r.opt_steps,
            "gather_launches": launches, "resumed_gather_launches": launches2,
            "final_loss": losses[-1], "tree_total": total,
            "env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks],
            "updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks],
            "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
            "eval_scores": [s for _, s in r.eval_history],
            "eval_record": dict(evals[-1].items()),
            "evaluator_s": list(ev.seconds),
            "checkpoint_gb": ckpt_gb, "checkpoint_save_s": list(mgr.save_s),
            "checkpoint_restore_s": list(mgr2.restore_s),
            "checkpoint_dir_free_gb": free_gb,
            "reference_descent_dead_leaves": {
                "random_points": [dead_random, n_random * BATCH],
                "top_stratum_points_at_the_total": [dead_top, n_top]},
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        print(f"PER path: Trainer.train() Pong, {NUM_ENVS} envs, batch {BATCH}, "
              f"ring {NUM_ENVS}x{PER_CAPACITY}, {r.opt_steps} updates in 2 "
              f"update chunks; env-steps/s {chunks[-1]['samples_per_sec']:.1f}, "
              f"updates/s {chunks[-1]['opt_steps_per_sec']:.2f} (last chunk); "
              f"frame_gather launches {launches} = updates; tree total "
              f"{total:.3f}; checkpoint {ckpt_gb:.3f} GB; a Trainer resumed "
              f"from step {upc} ended bitwise equal at step {r2.opt_steps}",
              flush=True)
        print("PER path numbers: " + json.dumps(result), flush=True)
        del tr2, r2, rec2
        torch.cuda.empty_cache()
        breakdown(torch, tr, r, "per")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches + launches2


def mode_paths(torch, dev) -> int:
    """Phase 9: a warmup chunk and one update chunk of slice mode and of
    n-step 3 at the main width.  Returns the gather launches."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    upc = STEPS_PER_CHUNK * NUM_ENVS // OPT_INTERVAL
    total = 0
    for label, kw, per_sample in (
            ("sample_mode='slice'", dict(sample_mode="slice", slice_group=SLICE_GROUP), 1),
            ("n_step=3", dict(n_step=3), 2)):
        agent = DQN(DQNConfig(model=lambda n: AtariCNN(n), lr=1e-4,
                              double_dqn=True, soft_update_interval=2_000,
                              tau=1.0))
        rec = _chunk_recorder()
        tr = Trainer(
            make("Pong-v0"), agent,
            FrameReplayBuffer(capacity=CAPACITY, num_envs=NUM_ENVS, **kw),
            TrainerConfig(num_envs=NUM_ENVS, steps_per_chunk=STEPS_PER_CHUNK,
                          batch_size=BATCH, opt_interval=OPT_INTERVAL,
                          warmup_period=0, max_opts=upc),
            recorder=rec)
        frame_gather.gather_frames.launches = 0
        r = tr.train(seed=0)
        torch.cuda.synchronize()
        launches = frame_gather.gather_frames.launches
        chunk = rec.chunks[-1]
        if r.opt_steps != upc or launches != per_sample * upc:
            fail(f"{label}: {launches} gather launches for {r.opt_steps} updates")
        if not (math.isfinite(chunk["loss"]) and all(
                torch.isfinite(p).all() for p in r.agent_state.params.parameters())):
            fail(f"{label}: loss {chunk['loss']} or parameters not finite")
        print(f"{label} path: {r.opt_steps} updates in one chunk, "
              f"{launches} frame_gather launches ({per_sample} a sample), "
              f"loss {chunk['loss']:.6g}, env-steps/s "
              f"{chunk['samples_per_sec']:.1f}, updates/s "
              f"{chunk['opt_steps_per_sec']:.2f}", flush=True)
        total += launches
        del tr, r
        torch.cuda.empty_cache()
    return total


def _pixel_dqn():
    from border_tpu_torch.learning import pixel_dqn

    return pixel_dqn()


def _train_pixel(torch, label, env_id, agent, batch, update_chunks, per_sample,
                 buffer_kw=None, evaluator=None):
    """``Trainer.train()`` on a pixel game at the gate configs' width: one
    warmup chunk and ``update_chunks`` update chunks.  Checks the loss, the
    parameters and the gather's launch count; returns the trainer, its
    result, the recorder and the launches."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    upc = STEPS_PER_CHUNK * GAME_ENVS // OPT_INTERVAL
    rec = _chunk_recorder()
    tr = Trainer(
        make(env_id), agent,
        FrameReplayBuffer(capacity=GAME_CAPACITY, num_envs=GAME_ENVS,
                          **(buffer_kw or {})),
        TrainerConfig(num_envs=GAME_ENVS, steps_per_chunk=STEPS_PER_CHUNK,
                      batch_size=batch, opt_interval=OPT_INTERVAL,
                      warmup_period=0, max_opts=update_chunks * upc,
                      eval_interval=update_chunks * upc),
        recorder=rec, evaluator=evaluator)
    if tr.updates_per_chunk != upc:
        fail(f"{label}: updates_per_chunk {tr.updates_per_chunk} != {upc}")
    before = [p.detach().clone() for p in agent.init(
        0, tr.vec.observation_space, tr.vec.action_space).params.parameters()]
    torch.cuda.reset_peak_memory_stats()
    frame_gather.gather_frames.launches = 0
    r = tr.train(seed=0)
    torch.cuda.synchronize()
    launches = frame_gather.gather_frames.launches

    chunks = [c for c in rec.chunks if "opt_steps_per_sec" in c]
    losses = [c["loss"] for c in chunks]
    after = list(r.agent_state.params.parameters())
    if len(chunks) != update_chunks or not all(map(math.isfinite, losses)):
        fail(f"{label}: update chunks {len(chunks)}, losses {losses}")
    if r.opt_steps != update_chunks * upc or launches != per_sample * r.opt_steps:
        fail(f"{label}: {launches} gather launches for {r.opt_steps} updates")
    if not all(torch.isfinite(p).all() for p in after):
        fail(f"{label}: non-finite parameters")
    if all(torch.equal(a, p.detach()) for a, p in zip(before, after)):
        fail(f"{label}: the parameters did not change")
    if r.buffer_state.total != (update_chunks + 1) * STEPS_PER_CHUNK:
        fail(f"{label}: buffer holds {r.buffer_state.total} pushes")
    obs = r.buffer_state.frames[:, : r.buffer_state.total]
    if not (obs > 0).any():
        fail(f"{label}: the ring holds only black frames")
    result = {
        "env_steps": r.env_steps, "updates": r.opt_steps,
        "gather_launches": launches, "final_loss": losses[-1],
        "env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks],
        "updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks],
        "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"{label} path: Trainer.train() {env_id}, {GAME_ENVS} envs, batch "
          f"{batch}, ring {GAME_ENVS}x{GAME_CAPACITY}, {r.opt_steps} updates in "
          f"{update_chunks} update chunks; env-steps/s "
          f"{chunks[-1]['samples_per_sec']:.1f}, updates/s "
          f"{chunks[-1]['opt_steps_per_sec']:.2f} (last chunk); final loss "
          f"{losses[-1]:.6g}; frame_gather launches {launches} = "
          f"{per_sample} x updates", flush=True)
    return tr, r, rec, launches, result


def seaquest_path(torch, dev) -> int:
    """Phase 10: IQN on Seaquest at the seaquest gate config's width, with
    one evaluation.  Returns the gather launches."""
    import functools

    from border_tpu_torch.agents import IQN, IQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.train import Evaluator

    agent = IQN(IQNConfig(
        psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True),
        feature_dim=512, n_cos=64, hidden=(512,),
        sample_percents_pred="uniform8", sample_percents_tgt="uniform8",
        sample_percents_act="const32", lr=1e-4,
        soft_update_interval=2_000, tau=1.0, eps_final_step=2_000_000))
    ev = Evaluator(make("Seaquest-v0", train=False), n_episodes=EVAL_EPISODES,
                   max_steps=EVAL_MAX_STEPS)
    t0 = time.perf_counter()
    tr, r, rec, launches, result = _train_pixel(
        torch, "seaquest-iqn", "Seaquest-v0", agent, SEAQUEST_BATCH, 1, 1,
        evaluator=ev)
    evals = [w_ for w_ in rec.written if "Episode return" in w_]
    if len(r.eval_history) != 1 or len(evals) != 1 or (
            {k for k, _ in evals[0]} != EVAL_KEYS):
        fail(f"seaquest-iqn: evaluations {r.eval_history}")
    score = r.eval_history[0][1]
    if not (math.isfinite(score) and score >= 0):
        fail(f"seaquest-iqn: evaluation score {score}")
    # quantile values of the expected shape, finite
    obs = r.buffer_state.frames[:4, 0, :, :, None].expand(-1, -1, -1, 4)
    taus = torch.rand((4, 8), device=dev)
    with torch.no_grad():  # no autograd graph left holding the parameters
        z = r.agent_state.params(obs, taus)
    if z.shape != (4, 8, 6) or not torch.isfinite(z).all():
        fail(f"seaquest-iqn: quantile values of shape {tuple(z.shape)}")
    result.update(eval_score=score, eval_record=dict(evals[0].items()),
                  seconds=time.perf_counter() - t0)
    print("seaquest-iqn path numbers: " + json.dumps(result), flush=True)
    breakdown(torch, tr, r, "seaquest-iqn")
    del tr, r
    torch.cuda.empty_cache()
    return launches


def game_paths(torch, dev) -> int:
    """Phase 11: a warmup chunk and one update chunk of DQN on each of the
    other three games at its gate config's width, one ring at a time.
    Returns the gather launches."""
    total = 0
    for label, env_id, buffer_kw, per_sample in (
            ("breakout", "Breakout-v0", {}, 1),
            ("freeway", "Freeway-v0", dict(n_step=3, gamma=0.99), 2),
            ("spaceinvaders", "SpaceInvaders-v0", dict(n_step=3), 2)):
        tr, r, _, launches, result = _train_pixel(
            torch, label, env_id, _pixel_dqn(), BATCH, 1, per_sample,
            buffer_kw=buffer_kw)
        print(f"{label} path numbers: " + json.dumps(result), flush=True)
        breakdown(torch, tr, r, label, env_only=True)
        total += launches
        del tr, r
        torch.cuda.empty_cache()
    return total


def cartpole_fused_path(torch, dev) -> None:
    """Phase 12: bench.py's fused CartPole config through Trainer.train()
    with the flat replay buffer: a warmup chunk and one update chunk."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    upc = CART_STEPS * CART_ENVS // CART_OPT_INTERVAL
    rec = _chunk_recorder()
    agent = DQN(DQNConfig(double_dqn=True))
    tr = Trainer(
        make("CartPole-v1"), agent, ReplayBuffer(capacity=CART_CAPACITY),
        TrainerConfig(num_envs=CART_ENVS, steps_per_chunk=CART_STEPS,
                      batch_size=BATCH, opt_interval=CART_OPT_INTERVAL,
                      warmup_period=0, max_opts=upc),
        recorder=rec)
    before = [p.detach().clone() for p in agent.init(
        0, tr.vec.observation_space, tr.vec.action_space).params.parameters()]
    r = tr.train(seed=0)
    torch.cuda.synchronize()
    chunks = [c for c in rec.chunks if "opt_steps_per_sec" in c]
    losses = [c["loss"] for c in chunks]
    after = list(r.agent_state.params.parameters())
    if (tr.updates_per_chunk != upc or r.opt_steps != upc
            or len(chunks) != 1 or not all(map(math.isfinite, losses))):
        fail(f"cartpole-fused: {r.opt_steps} updates, losses {losses}")
    if not all(torch.isfinite(p).all() for p in after) or all(
            torch.equal(a, p.detach()) for a, p in zip(before, after)):
        fail("cartpole-fused: parameters not finite or unchanged")
    # the ring wrapped: 2 chunks push 524,288 transitions into 65,536 slots
    st = r.buffer_state
    if not (st.size == CART_CAPACITY and st.cursor == (2 * CART_STEPS * CART_ENVS)
            % CART_CAPACITY and st.data.obs.is_cuda
            and tuple(st.data.obs.shape) == (CART_CAPACITY, 4)):
        fail(f"cartpole-fused: buffer size {st.size}, cursor {st.cursor}")
    with torch.no_grad():  # no autograd graph left holding the parameters
        q = r.agent_state.params(st.data.obs[:8])
    if q.shape != (8, 2) or not torch.isfinite(q).all():
        fail(f"cartpole-fused: Q values of shape {tuple(q.shape)}")
    result = {
        "env_steps": r.env_steps, "updates": r.opt_steps, "final_loss": losses[-1],
        "env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks],
        "updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks],
        "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
    }
    print(f"cartpole-fused path: Trainer.train() CartPole-v1, {CART_ENVS} envs, "
          f"batch {BATCH}, flat buffer of {CART_CAPACITY}, {r.opt_steps} updates "
          f"in 1 update chunk; env-steps/s {chunks[-1]['samples_per_sec']:.1f}, "
          f"updates/s {chunks[-1]['opt_steps_per_sec']:.2f} (last chunk); final "
          f"loss {losses[-1]:.6g}", flush=True)
    print("cartpole-fused path numbers: " + json.dumps(result), flush=True)
    breakdown(torch, tr, r, "cartpole-fused")


def _gate_run(torch, config: str):
    """``learning.run`` of the gate config ``config``, seed 0, whole, into a
    temporary directory; checks the artifact it wrote (the evaluations, and
    ``final_evals`` of the best checkpoint, finite).  Returns the run and
    its seconds."""
    from border_tpu_torch import learning

    work = tempfile.mkdtemp(prefix=f"border_smoke_{config}_")
    try:
        out = learning.artifact_path(config, 0, work)
        t0 = time.perf_counter()
        g = learning.run(config, 0, out)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(out) as f:
            art = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    finals = art.get("final_evals") or []
    if (art != g.artifact or len(finals) != learning.N_FINAL_EVALS.get(config, 5)
            or not all(map(math.isfinite, finals))
            or art["final_median"] != round(statistics.median(finals), 2)):
        fail(f"{config}: the artifact's final evaluations {finals}")
    return g, art, seconds


def cartpole_learns(torch, dev) -> None:
    """Phase 13: the cartpole learning-gate config on seed 0, whole, through
    ``learning.run`` (its artifact, with the best checkpoint's fresh
    evaluations)."""
    from border_tpu_torch import learning

    g, art, seconds = _gate_run(torch, "cartpole")
    r, gate = g.result, learning.CART_GATE
    scores = [s for _, s in r.eval_history]
    n_evals = gate["max_opts"] // gate["eval_interval"]
    if r.opt_steps < gate["max_opts"] or len(scores) < n_evals or not all(
            map(math.isfinite, scores)) or len(art["curve"]) != len(scores) + 1:
        fail(f"cartpole learns: {r.opt_steps} updates, evaluations {r.eval_history}")
    target = learning.TARGETS["cartpole"]
    result = {
        "updates": r.opt_steps, "env_steps": r.env_steps, "seconds": seconds,
        "train_seconds": r.duration_sec,
        "updates_per_s": r.opt_per_sec, "env_steps_per_s": r.samples_per_sec,
        "eval_history": r.eval_history, "best_score": r.best_score,
        "first_score": scores[0], "final_evals": art["final_evals"],
        "final_median": art["final_median"], "gate_target": target,
        "met_gate_target": art["final_median"] >= target,
    }
    print(f"cartpole learns: the whole cartpole gate config "
          f"({gate['max_opts']} updates) through learning.run, seed 0, "
          f"{r.opt_steps} updates and {len(scores)} evaluations of 20 episodes "
          f"in {r.duration_sec:.1f} s, {seconds:.1f} s with the certification; "
          f"best score {r.best_score:.1f} (first {scores[0]:.1f}); the best "
          f"checkpoint's fresh evaluations {art['final_evals']}, median "
          f"{art['final_median']} (the gate's target {target:.0f} "
          f"{'met' if result['met_gate_target'] else 'not met'})", flush=True)
    print("cartpole learns numbers: " + json.dumps(result), flush=True)
    if r.best_score < CART_MIN_SCORE:
        fail(f"cartpole learns: best evaluation score {r.best_score} is under "
             f"{CART_MIN_SCORE}")


def pendulum_sac_path(torch, dev) -> None:
    """Phase 14: SAC on Pendulum at the pendulum gate config's width: one
    warmup chunk, two update chunks of 256 updates and one evaluation of
    10 episodes x 200 steps, then phase 7 for this path."""
    from border_tpu_torch import learning
    from border_tpu_torch.train import Trainer

    env, agent, buffer, cfg, ev, _ = learning.build("pendulum", 0, dev)
    upc = cfg.steps_per_chunk * cfg.num_envs // cfg.opt_interval
    max_opts = PEND_UPDATE_CHUNKS * upc
    rec = _chunk_recorder()
    tr = Trainer(env, agent, buffer,
                 cfg.replace(max_opts=max_opts, eval_interval=max_opts),
                 recorder=rec, evaluator=ev)
    before = [p.detach().clone() for p in agent.init(
        0, tr.vec.observation_space, tr.vec.action_space).actor_params.parameters()]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = tr.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    chunks = [c for c in rec.chunks if "opt_steps_per_sec" in c]
    keys = ("loss_critic", "loss_actor", "loss_alpha", "ent_coef", "entropy", "q_mean")
    if (tr.updates_per_chunk != upc or r.opt_steps != max_opts
            or len(chunks) != PEND_UPDATE_CHUNKS or len(rec.chunks) != PEND_UPDATE_CHUNKS + 1
            or not all(math.isfinite(c[k]) for c in chunks for k in keys)):
        fail(f"pendulum-sac: {r.opt_steps} updates, chunks {[dict(c.items()) for c in chunks]}")
    st = r.agent_state
    after = list(st.actor_params.parameters())
    nets = (st.actor_params, st.critic_params, st.critic_target_params)
    if not (all(p.is_cuda and torch.isfinite(p).all() for n in nets for p in n.parameters())
            and st.log_alpha.is_cuda and r.buffer_state.data.obs.is_cuda):
        fail("pendulum-sac: a network or the buffer is not finite or not on the card")
    if all(torch.equal(a, p.detach()) for a, p in zip(before, after)):
        fail("pendulum-sac: the actor did not change")
    evals = [w for w in rec.written if "Episode return" in w]
    if len(r.eval_history) != 1 or len(evals) != 1 or {k for k, _ in evals[0]} != EVAL_KEYS:
        fail(f"pendulum-sac: evaluations {r.eval_history}")
    score = r.eval_history[0][1]
    if not (math.isfinite(score) and -200 * 16.3 <= score <= 0):
        fail(f"pendulum-sac: evaluation score {score}")
    result = {
        "env_steps": r.env_steps, "updates": r.opt_steps, "seconds": seconds,
        "final_metrics": {k: chunks[-1][k] for k in keys},
        "env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks],
        "updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks],
        "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
        "eval_score": score, "eval_record": dict(evals[0].items()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"pendulum-sac path: Trainer.train() Pendulum-v1, SAC 128x128, "
          f"{cfg.num_envs} envs, batch {cfg.batch_size}, "
          f"{r.opt_steps} updates in {PEND_UPDATE_CHUNKS} update chunks; "
          f"env-steps/s {chunks[-1]['samples_per_sec']:.1f}, updates/s "
          f"{chunks[-1]['opt_steps_per_sec']:.2f} (last chunk); evaluation "
          f"score {score:.1f}", flush=True)
    print("pendulum-sac path numbers: " + json.dumps(result), flush=True)
    breakdown(torch, tr, r, "pendulum-sac")


def offline_path(torch, dev, name: str, max_opts, min_score=None) -> None:
    """Phases 15-17: the offline gate config ``name`` at full width over the
    whole committed corpus, with an evaluation of 200 episodes x 50 steps
    every 2,000 updates: whole through ``learning.run`` (seed 0, its
    artifact with the best checkpoint's fresh evaluations) when ``max_opts``
    is None, else cut to ``max_opts`` updates, the first evaluation there;
    then one chunk of 250 updates timed and 32 updates traced.
    ``min_score``: the normalized best score the run must reach."""
    from border_tpu_torch import learning
    from border_tpu_torch.data import normalized_score
    from border_tpu_torch.record import BufferedRecorder
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import OfflineTrainer

    corpus = (os.path.join(learning.IQL_CORPUS_DIR, learning.IQL_CORPUS)
              if name == "iql_offline" else
              os.path.join(ROOT, "artifacts", "datasets", learning.OFFLINE_CORPUS))
    for ext in (".npz", ".json"):
        if not os.path.isfile(corpus + ext):
            fail(f"{name}: the corpus file {corpus + ext} is missing")
    upc = learning.OFFLINE_UPDATES_PER_CHUNK
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art = None
    if max_opts is None:
        g, art, _ = _gate_run(torch, name)
        tr, r = g.trainer, g.result
        behavior = art["behavior_normalized"]
    else:
        md, agent, cfg, evaluator = learning.offline_config(name, dev, max_opts)
        cfg = cfg.replace(eval_interval=min(cfg.eval_interval, max_opts))
        buffer = ReplayBuffer(capacity=md.get_num_transitions())
        buf_state = md.create_replay_buffer(buffer)
        vec = evaluator.vec
        agent_state = agent.init(0, vec.observation_space, vec.action_space)
        tr = OfflineTrainer(agent, buffer, cfg, recorder=BufferedRecorder(),
                            evaluator=evaluator, updates_per_chunk=upc)
        r = tr.train(agent_state, buf_state, seed=1000)
        behavior = md.behavior_normalized_score()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    agent, buffer, cfg, rec = tr.agent, tr.buffer, tr.config, tr.recorder
    max_opts = cfg.max_opts
    buf_state = r.buffer_state
    if not (buf_state.size == 25_000 and buf_state.data.obs.is_cuda
            and tuple(buf_state.data.obs.shape) == (25_000, 8)):
        fail(f"{name}: buffer of {buf_state.size} transitions, obs "
             f"{tuple(buf_state.data.obs.shape)} on {buf_state.data.obs.device}")
    # the run's chunk metrics, flushed once at its end (min, max, mean and
    # median over the chunks)
    metrics = [w for w in rec.records if "opt_steps" in w]
    metric_keys = [k for k, _ in metrics[-1] if k != "opt_steps"]
    if r.opt_steps != max_opts or len(metrics) != 1 or not all(
            math.isfinite(metrics[0][k]) for k in metric_keys):
        fail(f"{name}: {r.opt_steps} updates, metrics {[dict(w.items()) for w in metrics]}")
    ups = metrics[0]["opt_steps_per_sec_median" if max_opts > upc else "opt_steps_per_sec"]
    nets = [v for v in vars(r.agent_state).values() if isinstance(v, torch.nn.Module)]
    if not all(p.is_cuda and torch.isfinite(p).all() for n in nets for p in n.parameters()):
        fail(f"{name}: a network is not finite or not on the card")
    evals = [w for w in rec.records if "Episode return" in w]
    want_keys = EVAL_KEYS | {"Normalized score"}
    if len(evals) != max_opts // cfg.eval_interval or len(r.eval_history) != len(
            evals) or any({k for k, _ in w} != want_keys for w in evals):
        fail(f"{name}: evaluation records {[dict(w.items()) for w in evals]}")
    scores = [w["Normalized score"] for w in evals]
    best = normalized_score(r.best_score, tr.evaluator.ref_min, tr.evaluator.ref_max)
    if not all(map(math.isfinite, scores)):
        fail(f"{name}: normalized scores {scores}")
    result = {
        "updates": r.opt_steps, "seconds": seconds, "train_seconds": r.duration_sec,
        "updates_per_s": r.opt_per_sec, "updates_per_s_median_chunk": ups,
        "chunk_metrics": {k: metrics[0][k] for k in metric_keys},
        "normalized_scores": scores, "best_normalized": best,
        "eval_record": dict(evals[-1].items()),
        "behavior_normalized": behavior,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    target = learning.TARGETS[name]
    if art is not None:
        result.update(target=target, floor=min_score, final_evals=art["final_evals"],
                      final_median=art["final_median"],
                      met_target=art["final_median"] >= target)
    if name == "bc_offline":
        result.update(lr_at_last_update=agent.config.lr(r.opt_steps - 1))
    print(f"{name} path: OfflineTrainer.train() over {os.path.basename(corpus)} "
          f"({buf_state.size} transitions), {type(agent).__name__} at the gate "
          f"width, batch {cfg.batch_size}, {r.opt_steps} updates in "
          f"{r.duration_sec:.1f} s ({ups:.1f} updates/s, median chunk); normalized "
          f"scores {[round(x, 2) for x in scores]}, best {best:.2f}"
          + (f"; through learning.run: the best checkpoint's fresh evaluations "
             f"{art['final_evals']}, median {art['final_median']} (the gate's "
             f"target {target:.0f}, floor {min_score:.0f})"
             if art is not None else ""), flush=True)
    print(f"{name} path numbers: " + json.dumps(result), flush=True)
    if min_score is not None and not best >= min_score:
        fail(f"{name}: best normalized score {best} is under {min_score}")

    # from the run's final state: one chunk timed for the graphed trainer
    # and its eager twin in turns (graphed, eager, eager, graphed), then 32
    # updates of each traced
    gen = torch.Generator(device=dev).manual_seed(3)
    ag, buf = r.agent_state, r.buffer_state
    twins = {"graphed": tr, "eager": OfflineTrainer(
        agent, buffer, cfg, updates_per_chunk=upc,
        cuda_graphs=False)}
    if not tr.cuda_graphs:
        fail(f"{name}: the OfflineTrainer on the card is not graphed")
    tr._chunk(ag, buf, gen)  # the capture, before anything is timed
    out = {k: {"chunk_s": []} for k in twins}
    for k in ("graphed", "eager", "eager", "graphed"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ag, buf, _ = twins[k]._chunk(ag, buf, gen)
        torch.cuda.synchronize()
        out[k]["chunk_s"].append(time.perf_counter() - t)
    for k, t in twins.items():
        out[k]["ms_per_update"] = [1e3 * x / upc
                                   for x in out[k]["chunk_s"]]
        t.updates_per_chunk = 32
        out[k]["update_trace"] = trace(torch, lambda: t._chunk(ag, buf, gen), 32)
    if not out["eager"]["update_trace"]["device_busy_ms_each"] > 0:
        fail(f"{name}: the profiler saw no device time in the update trace")
    if not (out["graphed"]["update_trace"]["host_ops_each"]
            < out["eager"]["update_trace"]["host_ops_each"]):
        fail(f"{name}: the graphed update makes no fewer host operator calls")
    print(f"breakdown ({name}): " + json.dumps(out), flush=True)
    del tr, r, buf_state
    torch.cuda.empty_cache()


def breakdown(torch, tr, r, label: str, env_only: bool = False) -> None:
    """The env and update phases of a chunk of ``tr``'s path timed apart (host
    clock, each ending in a device sync), then a shorter stretch of each
    traced (:func:`trace`), for the graphed chunk (``tr``, CUDA-graph
    replays) and the eager one (a twin of ``tr`` with ``cuda_graphs=False``)
    in turns: graphed, then eager.  Starts from the main
    path's final agent and replay state, with the trainer's own buffer (and
    its modes); the two twins go on from each other's states.  For the
    graphed twin the device time of a phase is also taken with CUDA events
    while the host has queued the whole phase ahead of the card (so it
    holds no host time).  ``env_only``: trace the env steps alone (the
    launches an env step)."""
    from border_tpu_torch.train import Trainer, TrainerConfig

    gen = torch.Generator(device=tr.device).manual_seed(3)
    c = tr.config
    ag, buf = r.agent_state, r.buffer_state
    twins = {"graphed": tr, "eager": Trainer(
        tr.env, tr.agent, tr.buffer, c, cuda_graphs=False)}
    if not tr.cuda_graphs:
        fail(f"breakdown ({label}): the path's trainer is not graphed")
    vecs = {k: tr.vec.reset(1) for k in twins}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def env_phase(k, t):
        nonlocal ag, buf
        ag, vecs[k], buf, _, _ = t._env_scan(ag, vecs[k], buf, gen, explore=True)

    def update_phase(t):
        nonlocal ag, buf
        ag, buf, _ = t._update_scan(ag, buf, gen)

    # the graphed twin's captures, before anything is timed
    env_phase("graphed", tr)
    if not env_only:
        update_phase(tr)
    out = {k: {"env_phase_s": [], "update_phase_s": []} for k in twins}
    for k in () if env_only else ("graphed", "eager"):
        out[k]["env_phase_s"].append(timed(lambda: env_phase(k, twins[k]))[1])
        out[k]["update_phase_s"].append(timed(lambda: update_phase(twins[k]))[1])
    for k, o in out.items():
        o["ms_per_env_step"] = [1e3 * e / c.steps_per_chunk for e in o["env_phase_s"]]
        o["ms_per_update"] = [1e3 * u / tr.updates_per_chunk
                              for u in o["update_phase_s"]]

    def device_ms(run, n):
        """Device milliseconds per step of ``run()``: the card sleeps while
        the host queues every replay, so the events hold no host time."""
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        run()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    out["graphed"]["device_ms_per_env_step_events"] = device_ms(
        lambda: env_phase("graphed", tr), c.steps_per_chunk)
    if not env_only:
        out["graphed"]["device_ms_per_update_events"] = device_ms(
            lambda: update_phase(tr), tr.updates_per_chunk)

    # trainers built for the trace lengths: 2 env steps, 32 updates
    trace_steps = 2
    for k, t in twins.items():
        tt = Trainer(t.env, t.agent, t.buffer, TrainerConfig(
            num_envs=c.num_envs, steps_per_chunk=trace_steps,
            batch_size=c.batch_size, opt_interval=c.opt_interval,
            warmup_period=0), cuda_graphs=t.cuda_graphs)
        phases = [("env", trace_steps, lambda: env_phase(k, tt))]
        if not env_only:
            phases.append(("update", tt.updates_per_chunk,
                           lambda: update_phase(tt)))
        for phase, n, run in phases:
            for _ in range(3):  # the eager warm-up and the capture, untraced
                run()
            out[k][f"{phase}_trace"] = trace(torch, run, n)
    last = "env_trace" if env_only else "update_trace"
    if not out["eager"][last]["device_busy_ms_each"] > 0:
        fail(f"the profiler saw no device time in the eager {last}")
    for phase in ("env",) if env_only else ("env", "update"):
        g, e = out["graphed"][f"{phase}_trace"], out["eager"][f"{phase}_trace"]
        if not g["host_ops_each"] < e["host_ops_each"]:
            fail(f"breakdown ({label}): graphed {phase} makes "
                 f"{g['host_ops_each']} host operator calls each, eager "
                 f"{e['host_ops_each']}")
    print(f"breakdown ({label}): " + json.dumps(out), flush=True)


def trace(torch, run, n: int) -> dict:
    """``run()`` (``n`` env steps or updates) traced with torch.profiler:
    device busy time, idle share of the traced wall (the profiler's own
    host cost is in that wall), launches, the kernels with the most device
    time and the operators with the most host time of their own, each per
    step or update."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: an operator's row repeats its kernels' time, and a
    # record_function's device row (the optimizer's step) spans its kernels
    # and the gaps between them
    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)}
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in annotations]
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    rows.sort(key=lambda e: -e.self_device_time_total)
    # where the host's time goes: operator rows by their own CPU time
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return {
        "per": n, "wall_ms_each": 1e3 * wall / n,
        "device_busy_ms_each": 1e3 * busy_s / n,
        "device_idle_share": 1.0 - busy_s / wall,
        "launches_each": sum(e.count for e in rows) / n,
        "top_ms_each": [[e.key[:80], e.count / n,
                         e.self_device_time_total / 1e3 / n]
                        for e in rows[:8]],
        "host_ops_each": sum(e.count for e in host) / n,
        "top_host_ms_each": [[e.key[:60], e.count / n,
                              e.self_cpu_time_total / 1e3 / n]
                             for e in host[:8]],
    }


def host_config(name: str, device, **cut):
    """``learning.host_config`` (the host-env gate config ``name``, seed 0,
    ``cut`` as there), pendulum_host's envs :class:`NumpyPendulum` behind
    ``PyVecEnv``: the card's machine has no gymnasium."""
    from border_tpu_torch import learning
    from border_tpu_torch.envs.py_env import numpy_pendulum

    return learning.host_config(name, device, make_env=numpy_pendulum, **cut)


class _IndexedEvaluator:
    """Wraps an evaluator: keeps each evaluation's index, score and seconds."""

    def __init__(self, inner, torch):
        self.inner, self.torch = inner, torch
        self.indices, self.scores, self.seconds, self.records = [], [], [], []

    def evaluate(self, agent, agent_state, eval_index=0):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        score, rec = self.inner.evaluate(agent, agent_state, eval_index=eval_index)
        self.seconds.append(time.perf_counter() - t0)
        self.indices.append(eval_index)
        self.scores.append(score)
        self.records.append(dict(rec.items()))
        return score, rec


def _async_vs_fused(torch, tr, r) -> dict:
    """The fused Trainer's chunk, AsyncTrainer's dispatch (syncing every
    time) and its eager twin (cuda_graphs=False) in turns,
    fused-async-eager-eager-async-fused, from the run's final state at its
    width with 4 env steps and 64 updates each: seconds a turn, host clock
    ending in a device sync; then one dispatch of each AsyncTrainer traced
    (after its captures): the graphed one must make fewer host operator
    calls."""
    from border_tpu_torch.train import AsyncTrainer, Trainer

    short = tr.config.replace(steps_per_chunk=4, sync_interval=1)
    runs = {"fused": Trainer(tr.env, tr.agent, tr.buffer, short),
            "async": AsyncTrainer(tr.env, tr.agent, tr.buffer, short),
            "async_eager": AsyncTrainer(tr.env, tr.agent, tr.buffer, short,
                                        cuda_graphs=False)}
    gen = torch.Generator(device=tr.device).manual_seed(4)
    ag, vec, buf = r.agent_state, tr.vec.reset(2), r.buffer_state
    out = {"updates_a_turn": runs["fused"].updates_per_chunk,
           "env_steps_a_turn": short.steps_per_chunk,
           "fused_s": [], "async_s": [], "async_eager_s": []}

    def dispatch(which):
        nonlocal ag, vec, buf
        ag, vec, buf, _, _, _ = runs[which]._dispatch(ag, vec, buf, gen, True)

    for which in ("fused", "async", "async_eager", "async_eager", "async", "fused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch(which)
        torch.cuda.synchronize()
        out[f"{which}_s"].append(time.perf_counter() - t0)
    for which in ("async", "async_eager"):
        out[f"{which}_dispatch_trace"] = trace(torch, lambda: dispatch(which), 1)
    g, e = out["async_dispatch_trace"], out["async_eager_dispatch_trace"]
    if not g["host_ops_each"] < e["host_ops_each"]:
        fail(f"async pong: a graphed dispatch makes {g['host_ops_each']} host "
             f"operator calls, an eager one {e['host_ops_each']}")
    print(f"host operator calls a dispatch (async pong, {short.steps_per_chunk} "
          f"env steps and {out['updates_a_turn']} updates): graphed "
          f"{g['host_ops_each']}, eager {e['host_ops_each']}", flush=True)
    return out


def _free(torch) -> None:
    """Collect what a phase left (a ring in a reference cycle stays on the
    card until the collector runs) before the next phase's peak."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _host_run(torch, label, tr, rec):
    """``tr.train()`` with the gather's count set to 0 just before and read
    just after; the numbers of the run's update phase from the records kept
    at chunk cadence (windows of ``steps_per_chunk`` iterations; a window
    with metrics ended in an update burst, and the first of them may hold
    warmup iterations, so it is left out)."""
    from border_tpu_torch.ops import frame_gather

    torch.cuda.reset_peak_memory_stats()
    frame_gather.gather_frames.launches = 0
    t0 = time.perf_counter()
    r = tr.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = frame_gather.gather_frames.launches
    windows = [c for c in rec.chunks if "env_steps" in c]
    updating = [c for c in windows if any(k.startswith("loss") for k, _ in c)][1:]
    warm = [c for c in windows if not any(k.startswith("loss") for k, _ in c)]
    if not updating or not warm:
        fail(f"{label}: {len(warm)} warmup and {len(updating)} update windows")
    eps = [c["samples_per_sec"] for c in updating]
    upt = tr.updates_per_transition
    numbers = {
        "env_steps": r.env_steps, "updates": r.opt_steps, "seconds": seconds,
        "gather_launches": launches,
        "env_steps_per_s_update_windows": eps,
        "updates_per_s_update_windows": [e * upt for e in eps],
        "host_wait_frac_update_windows": [c["host_wait_frac"] for c in updating],
        "warmup_env_steps_per_s_median": statistics.median(
            c["samples_per_sec"] for c in warm),
        "warmup_host_wait_frac_median": statistics.median(
            c["host_wait_frac"] for c in warm),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    losses = [v for c in updating for k, v in c if k.startswith("loss")]
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: losses {losses}")
    return r, launches, numbers


def _host_eager_twin(torch, label, tr, rec, r_graphed, numbers, ev=None,
                     ev_graphed=None):
    """``tr`` (the run's config with cuda_graphs=False, the same seeds) run
    as the graphed run was: its final agent and replay state, updates, env
    steps, gather launches and evaluation records must equal the graphed
    run's; its numbers go into ``numbers["eager"]``."""
    if tr.cuda_graphs:
        fail(f"{label}: the eager twin is graphed")
    r, launches, twin = _host_run(torch, f"{label} eager", tr, rec)
    for part in ("agent_state", "buffer_state"):
        bad = _state_diff(torch, getattr(r_graphed, part), getattr(r, part))
        if bad:
            fail(f"{label}: the eager twin's {part} differs from the graphed "
                 f"run's in {bad[:8]}")
    if ((r.opt_steps, r.env_steps, launches) != (
            r_graphed.opt_steps, r_graphed.env_steps, numbers["gather_launches"])
            or (ev is not None and ev.records != ev_graphed.records)):
        fail(f"{label}: eager twin {r.opt_steps} updates, {r.env_steps} env "
             f"steps, {launches} launches, evaluations "
             f"{ev.records if ev else None}; graphed {r_graphed.opt_steps}, "
             f"{r_graphed.env_steps}, {numbers['gather_launches']}, "
             f"{ev_graphed.records if ev_graphed else None}")
    numbers["eager"] = {k: twin[k] for k in (
        "seconds", "env_steps_per_s_update_windows", "updates_per_s_update_windows",
        "host_wait_frac_update_windows", "warmup_env_steps_per_s_median")}
    if ev is not None:
        numbers["eager"]["evaluator_s"] = ev.seconds
    numbers["graphed_equals_eager_bitwise"] = True
    return r


def host_breakdown(torch, tr, r, label: str, make_env, iters: int = 16,
                   trace_iters: int = 8, pools=None) -> dict:
    """The parts of a host iteration timed apart from the run's final state
    on fresh host envs (host clock, each part ending in a device sync), for
    the graphed trainer ``tr`` and its eager twin (cuda_graphs=False) in
    turns, graphed-eager-eager-graphed: the update burst, the host env step,
    the upload of its results, the device step (push, stack, select) and
    the download of the actions and counters (``iters`` each); then
    ``trace_iters`` iterations of each twin pipelined as the trainer runs
    them, traced (:func:`trace`): the graphed twin must make fewer host
    operator calls an iteration.  ``make_env()``: a fresh host env.
    ``pools``: ``{label: make_env}``, host envs whose pipelined graphed
    iterations are timed (``iters`` each, untraced)."""
    import copy

    import numpy as np

    from border_tpu_torch.envs.native import AsyncEnvFeeder
    from border_tpu_torch.train.host import HostIO
    from border_tpu_torch.utils.counters import counts_of, set_mirrors

    if not tr.cuda_graphs:
        fail(f"breakdown ({label}): the path's trainer is not graphed")
    eager = copy.copy(tr)
    eager.cuda_graphs, eager._graphs = False, {}
    twins = {"graphed": tr, "eager": eager}
    gen = torch.Generator(device=tr.device).manual_seed(3)
    ag, buf = r.agent_state, r.buffer_state
    n = tr.config.num_envs
    m = max(1, round(n * tr.updates_per_transition))
    io = {k: HostIO(tr.device) for k in twins}
    acts = {}

    def start(k, env):
        """The twin's fixed obs from a reset, and its first actions."""
        io[k].upload("obs", env.reset())
        a = twins[k]._select(ag, io[k].dev["obs"], gen)
        if k in acts:
            acts[k].copy_(a)
        else:
            acts[k] = a
        return np.zeros(n, np.int32)

    def download(k):
        a_np, values = io[k].download(acts[k], counts_of(ag, buf))
        set_mirrors((ag, buf), values)
        return a_np

    parts = ("burst_ms", "host_env_step_ms", "upload_ms", "device_step_ms",
             "download_ms")
    out = {k: {p: [] for p in parts} for k in twins}

    def clock(k, key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[k][key].append(1e3 * (time.perf_counter() - t0))
        return res

    for k in ("graphed", "eager", "eager", "graphed"):
        t = twins[k]
        env = make_env()
        ep_len = start(k, env)
        a_np = download(k)
        for _ in range(iters):
            clock(k, "burst_ms", lambda: t._update_burst(ag, buf, gen, m))
            step = clock(k, "host_env_step_ms", lambda: env.step_final(a_np))
            clock(k, "upload_ms", lambda: t._stage(io[k], step, ep_len))
            clock(k, "device_step_ms", lambda: t._device_step_run(
                ag, buf, io[k], acts[k], gen))
            a_np = clock(k, "download_ms", lambda: download(k))
            ep_len = np.where(step[3] | step[4], 0, ep_len + 1).astype(np.int32)
        env.close()
    for k in twins:
        for p in parts:
            out[k][p] = statistics.median(out[k][p])
    out["burst_updates"] = m

    def pipelined(k, env, count, run=None):
        """``count`` iterations of twin ``k`` in the trainer's order;
        ``run`` wraps them (the trace), else their wall time an iteration
        in ms."""
        t = twins[k]
        feeder = AsyncEnvFeeder(env, step_fn=env.step_final)
        ep_len = start(k, env)
        feeder.submit(download(k))

        def loop():
            nonlocal ep_len
            for _ in range(count):
                t._update_burst(ag, buf, gen, m)
                step = feeder.collect()
                t._stage(io[k], step, ep_len)
                t._device_step_run(ag, buf, io[k], acts[k], gen)
                ep_len = np.where(step[3] | step[4], 0, ep_len + 1).astype(np.int32)
                feeder.submit(download(k))

        try:
            if run is not None:
                return run(loop)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / count
        finally:
            feeder.collect()
            feeder.close()  # closes the env

    for k in twins:
        out[k]["iteration_trace"] = pipelined(
            k, make_env(), trace_iters, run=lambda loop: trace(torch, loop, trace_iters))
    g, e = out["graphed"]["iteration_trace"], out["eager"]["iteration_trace"]
    if not g["host_ops_each"] < e["host_ops_each"]:
        fail(f"breakdown ({label}): a graphed iteration makes {g['host_ops_each']} "
             f"host operator calls, an eager one {e['host_ops_each']}")
    for pool, make_pool in (pools or {}).items():
        out["graphed"][f"pipelined_ms_per_iteration_{pool}"] = pipelined(
            "graphed", make_pool(), iters)
    if not g["device_busy_ms_each"] > 0:
        fail(f"{label}: the profiler saw no device time in the iteration trace")
    print(f"breakdown ({label}): " + json.dumps(out), flush=True)
    print(f"host operator calls an iteration ({label}): graphed "
          f"{g['host_ops_each']}, eager {e['host_ops_each']}", flush=True)
    return out


def pong_host_path(torch, dev) -> int:
    """Phase 18: the pong_host config at its width through the warmup and
    HOST_UPDATES updates, two evaluations cut to 200 steps and a full-state
    checkpoint at the end; a second trainer resumed from it.  Returns the
    gather launches of both runs."""
    from border_tpu_torch import learning
    from border_tpu_torch.envs.native import NativeVecEnv
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.train import HostEnvTrainer
    from border_tpu_torch.utils import CheckpointManager

    name, updates = "pong_host", HOST_UPDATES["pong_host"]
    work = tempfile.mkdtemp(prefix="border_smoke_host_")
    try:
        mgr = CheckpointManager(os.path.join(work, "ckpt"), max_to_keep=1)
        save = mgr.save
        save_s = []

        def timed_save(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(*a, **kw)
            save_s.append(time.perf_counter() - t0)

        mgr.save = timed_save
        env, agent, buf, cfg, ev = host_config(
            name, dev, eval_steps=PONG_HOST_EVAL_STEPS, max_opts=updates,
            eval_interval=updates // 2)
        ev = _IndexedEvaluator(ev, torch)
        rec = _chunk_recorder()
        tr = HostEnvTrainer(env, agent, buf, cfg, recorder=rec, evaluator=ev,
                            checkpoint_manager=mgr, checkpoint_interval=updates)
        r, launches, numbers = _host_run(torch, name, tr, rec)
        warm_iters = -(-cfg.warmup_period // cfg.num_envs) + STACK + 1
        if r.opt_steps != updates or launches != r.opt_steps:
            fail(f"{name}: {launches} gather launches for {r.opt_steps} updates")
        if r.buffer_state.total < warm_iters or not (r.buffer_state.frames > 0).any():
            fail(f"{name}: {r.buffer_state.total} pushes, or only black frames")
        if ev.indices != [0, 1] or mgr.all_steps() != [updates] or any(
                rec_["Episodes truncated"] != learning.HOST_EVAL[name][0] for rec_ in ev.records):
            fail(f"{name}: evaluations {ev.indices} {ev.records}, checkpoints "
                 f"{mgr.all_steps()}")
        ckpt_gb = os.path.getsize(mgr._path(updates)) / 1e9

        # -- the eager twin of the run, from the same seeds ----------------------
        env_e, agent_e, buf_e, cfg_e, ev_e = host_config(
            name, dev, eval_steps=PONG_HOST_EVAL_STEPS, max_opts=updates,
            eval_interval=updates // 2, cuda_graphs=False)
        ev_e = _IndexedEvaluator(ev_e, torch)
        rec_e = _chunk_recorder()
        _host_eager_twin(torch, name, HostEnvTrainer(
            env_e, agent_e, buf_e, cfg_e, recorder=rec_e, evaluator=ev_e,
            cuda_graphs=False), rec_e, r, numbers, ev_e, ev)
        del env_e, agent_e, buf_e
        _free(torch)

        # -- a second trainer resumed from the checkpoint ----------------------
        restore = mgr.restore
        checked, restore_s = [], []

        def restore_and_check(*a, **kw):
            t0 = time.perf_counter()
            out = restore(*a, **kw)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            for part in ("agent_state", "buffer_state"):
                bad = _state_diff(torch, getattr(r, part), out[part])
                if bad:
                    fail(f"{name}: the restored {part} differs from the saved "
                         f"one in {bad[:8]}")
            checked.append(out["extra"]["n_evals"])
            return out

        mgr.restore = restore_and_check
        env2, agent2, buf2, cfg2, ev2 = host_config(
            name, dev, eval_steps=PONG_HOST_EVAL_STEPS,
            max_opts=updates + HOST_RESUME_UPDATES, eval_interval=updates // 2)
        ev2 = _IndexedEvaluator(ev2, torch)
        tr2 = HostEnvTrainer(env2, agent2, buf2, cfg2, evaluator=ev2)
        frame_gather.gather_frames.launches = 0
        r2 = tr2.train(resume_from=mgr)
        torch.cuda.synchronize()
        launches2 = frame_gather.gather_frames.launches
        iters2 = HOST_RESUME_UPDATES * cfg.opt_interval // cfg.num_envs
        if (checked != [1] or ev2.indices != [1] or r2.opt_steps != updates + HOST_RESUME_UPDATES
                or launches2 != HOST_RESUME_UPDATES
                or r2.env_steps != r.env_steps + iters2 * cfg.num_envs
                or r2.buffer_state.total != r.buffer_state.total + iters2):
            fail(f"{name}: resumed run: restored n_evals {checked}, evaluations "
                 f"{ev2.indices}, {r2.opt_steps} updates, {launches2} launches, "
                 f"{r2.env_steps} env steps, {r2.buffer_state.total} pushes")
        numbers.update(
            eval_indices=ev.indices + ev2.indices, eval_scores=ev.scores + ev2.scores,
            evaluator_s=ev.seconds + ev2.seconds, eval_record=ev.records[-1],
            checkpoint_gb=ckpt_gb, checkpoint_save_s=save_s,
            checkpoint_restore_s=restore_s, resumed_gather_launches=launches2)
        print(f"pong_host path: HostEnvTrainer.train() Pong-v0 (C++ envpool), "
              f"{cfg.num_envs} envs, batch {cfg.batch_size}, ring "
              f"{cfg.num_envs}x{learning.HOST_CAPACITY[name]}, warmup {cfg.warmup_period} "
              f"env steps then {r.opt_steps} updates in {numbers['seconds']:.1f} s; "
              f"env-steps/s {statistics.median(numbers['env_steps_per_s_update_windows']):.1f}, "
              f"updates/s {statistics.median(numbers['updates_per_s_update_windows']):.2f}, "
              f"host_wait_frac {statistics.median(numbers['host_wait_frac_update_windows']):.3f} "
              f"(median update window); frame_gather launches {launches} = updates; "
              f"a trainer resumed from the {ckpt_gb:.3f} GB checkpoint restored the "
              f"ring bitwise and went on to {r2.opt_steps} updates, evaluation "
              f"index 1", flush=True)
        print("pong_host path numbers: " + json.dumps(numbers), flush=True)
        del tr2, r2, buf2, mgr
        _free(torch)
        # the C++ pool at its default size (a core left to the main thread)
        # and on every core, in turns
        pools = {}
        for label, k in (("default_a", None), ("all_cores_a", os.cpu_count()),
                         ("all_cores_b", os.cpu_count()), ("default_b", None)):
            pools[label] = (lambda k=k: NativeVecEnv("Pong-v0", cfg.num_envs,
                                                     seed=2, n_threads=k))
        host_breakdown(torch, tr, r, name,
                       lambda: NativeVecEnv("Pong-v0", cfg.num_envs, seed=1),
                       pools=pools)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del tr, r
    _free(torch)
    return launches + launches2


def breakout_host_path(torch, dev) -> int:
    """Phase 19: the breakout_host config at its width through the warmup
    and HOST_UPDATES updates.  Returns the gather launches."""
    from border_tpu_torch.envs.native import NativeVecEnv
    from border_tpu_torch.train import HostEnvTrainer

    name, updates = "breakout_host", HOST_UPDATES["breakout_host"]
    env, agent, buf, cfg, _ = host_config(name, dev, max_opts=updates)
    rec = _chunk_recorder()
    tr = HostEnvTrainer(env, agent, buf, cfg, recorder=rec)
    r, launches, numbers = _host_run(torch, name, tr, rec)
    if r.opt_steps != updates or launches != r.opt_steps:
        fail(f"{name}: {launches} gather launches for {r.opt_steps} updates")
    if not (r.buffer_state.frames > 0).any():
        fail(f"{name}: the ring holds only black frames")
    env_e, agent_e, buf_e, cfg_e, _ = host_config(name, dev, max_opts=updates)
    rec_e = _chunk_recorder()
    _host_eager_twin(torch, name, HostEnvTrainer(
        env_e, agent_e, buf_e, cfg_e, recorder=rec_e, cuda_graphs=False),
        rec_e, r, numbers)
    del env_e, agent_e, buf_e
    _free(torch)
    print(f"breakout_host path: HostEnvTrainer.train() Breakout-v0 (C++ envpool), "
          f"{cfg.num_envs} envs, batch {cfg.batch_size}, warmup "
          f"{cfg.warmup_period} env steps then {r.opt_steps} updates in "
          f"{numbers['seconds']:.1f} s; env-steps/s "
          f"{statistics.median(numbers['env_steps_per_s_update_windows']):.1f}, "
          f"host_wait_frac {statistics.median(numbers['host_wait_frac_update_windows']):.3f} "
          f"(median update window); frame_gather launches {launches} = updates",
          flush=True)
    print("breakout_host path numbers: " + json.dumps(numbers), flush=True)
    host_breakdown(torch, tr, r, name,
                   lambda: NativeVecEnv("Breakout-v0", cfg.num_envs, seed=1))
    del tr, r
    _free(torch)
    return launches


def pendulum_host_path(torch, dev) -> None:
    """Phase 20: the pendulum_host config at its width over PyVecEnv and
    NumpyPendulum: the warmup, HOST_UPDATES updates and one evaluation of
    the gate's 10 x 200 steps."""
    from border_tpu_torch.train import HostEnvTrainer

    name, updates = "pendulum_host", HOST_UPDATES["pendulum_host"]
    env, agent, buf, cfg, ev = host_config(name, dev, max_opts=updates,
                                           eval_interval=updates)
    ev = _IndexedEvaluator(ev, torch)
    rec = _chunk_recorder()
    tr = HostEnvTrainer(env, agent, buf, cfg, recorder=rec, evaluator=ev)
    r, launches, numbers = _host_run(torch, name, tr, rec)
    st = r.agent_state
    if r.opt_steps != updates or launches or ev.indices != [0]:
        fail(f"{name}: {r.opt_steps} updates, {launches} gather launches, "
             f"evaluations {ev.indices}")
    if not (all(p.is_cuda and torch.isfinite(p).all()
                for p in st.actor_params.parameters())
            and r.buffer_state.data.obs.is_cuda):
        fail(f"{name}: the actor or the buffer is not finite or not on the card")
    score = ev.scores[0]
    if not (math.isfinite(score) and -200 * 16.3 <= score <= 0):
        fail(f"{name}: evaluation score {score}")
    env_e, agent_e, buf_e, cfg_e, ev_e = host_config(
        name, dev, max_opts=updates, eval_interval=updates, cuda_graphs=False)
    ev_e = _IndexedEvaluator(ev_e, torch)
    rec_e = _chunk_recorder()
    _host_eager_twin(torch, name, HostEnvTrainer(
        env_e, agent_e, buf_e, cfg_e, recorder=rec_e, evaluator=ev_e,
        cuda_graphs=False), rec_e, r, numbers, ev_e, ev)
    numbers.update(eval_score=score, eval_record=ev.records[0],
                   evaluator_s=ev.seconds)
    print(f"pendulum_host path: HostEnvTrainer.train() over PyVecEnv of "
          f"{cfg.num_envs} numpy Pendulums, SAC 128x128, batch {cfg.batch_size}, "
          f"warmup {cfg.warmup_period} env steps then {r.opt_steps} updates in "
          f"{numbers['seconds']:.1f} s; env-steps/s "
          f"{statistics.median(numbers['env_steps_per_s_update_windows']):.1f}, "
          f"host_wait_frac {statistics.median(numbers['host_wait_frac_update_windows']):.3f} "
          f"(median update window); evaluation score {score:.1f}", flush=True)
    print("pendulum_host path numbers: " + json.dumps(numbers), flush=True)
    from border_tpu_torch.envs.py_env import numpy_pendulum

    host_breakdown(torch, tr, r, name, lambda: numpy_pendulum(cfg.num_envs, 1))


def host_cartpole_learns(torch, dev) -> None:
    """Phase 21: native CartPole through HostEnvTrainer at the JAX
    package's host-path learning test config, graphed; fails under a best
    score of HOST_CART_MIN_SCORE.  Then its eager twin from the same seeds
    must end bitwise equal (agent and replay state, evaluations)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig

    def build(graphs):
        agent = DQN(DQNConfig(hidden=(64, 64), lr=1e-3, tau=0.01,
                              soft_update_interval=1, double_dqn=True,
                              eps_final_step=20_000))
        rec = _chunk_recorder()
        return HostEnvTrainer(
            "CartPole-v1", agent, ReplayBuffer(16_384),
            TrainerConfig(seed=0, **HOST_CART), recorder=rec,
            evaluator=HostEvaluator("CartPole-v1", n_episodes=5, max_steps=500,
                                    cuda_graphs=graphs),
            cuda_graphs=graphs), rec

    runs = {}
    for graphs in (True, False):
        tr, rec = build(graphs)
        t0 = time.perf_counter()
        r = tr.train()
        torch.cuda.synchronize()
        runs[graphs] = (r, time.perf_counter() - t0, rec)
    (r, seconds, rec), (r_e, seconds_e, _) = runs[True], runs[False]
    waits = [c["host_wait_frac"] for c in rec.chunks]
    if r.opt_steps < HOST_CART["max_opts"] or len(r.eval_history) != 3:
        fail(f"host cartpole: {r.opt_steps} updates, evaluations {r.eval_history}")
    for part in ("agent_state", "buffer_state"):
        bad = _state_diff(torch, getattr(r, part), getattr(r_e, part))
        if bad:
            fail(f"host cartpole: the eager twin's {part} differs in {bad[:8]}")
    if r_e.eval_history != r.eval_history or r_e.env_steps != r.env_steps:
        fail(f"host cartpole: eager twin evaluations {r_e.eval_history}, "
             f"graphed {r.eval_history}")
    result = {"updates": r.opt_steps, "env_steps": r.env_steps, "seconds": seconds,
              "eval_history": r.eval_history, "best_score": r.best_score,
              "host_wait_frac_median": statistics.median(waits),
              "env_steps_per_s": r.samples_per_sec,
              "eager": {"seconds": seconds_e, "env_steps_per_s": r_e.samples_per_sec},
              "graphed_equals_eager_bitwise": True}
    print(f"host cartpole learns: HostEnvTrainer.train() CartPole-v1 (C++ "
          f"envpool), {HOST_CART['num_envs']} envs, {r.opt_steps} updates in "
          f"{seconds:.1f} s graphed ({seconds_e:.1f} s eager, bitwise equal); "
          f"evaluations {r.eval_history}, best "
          f"{r.best_score:.1f} (fails under {HOST_CART_MIN_SCORE:.0f})", flush=True)
    print("host cartpole learns numbers: " + json.dumps(result), flush=True)
    if r.best_score < HOST_CART_MIN_SCORE:
        fail(f"host cartpole: best evaluation score {r.best_score} is under "
             f"{HOST_CART_MIN_SCORE}")


def async_pong_path(torch, dev) -> int:
    """Phase 22: AsyncTrainer on Pong at bench.py's config (the uniform
    path's), sync_interval from TrainerConfig: a warmup chunk and two update
    chunks with a full-state checkpoint after each; at every chunk's start
    the actor's parameters must equal, bitwise, the learner's at the last
    sync; a second trainer resumed from the first checkpoint must end
    bitwise equal.  Returns the gather launches of both runs."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import AsyncTrainer, TrainerConfig
    from border_tpu_torch.utils import CheckpointManager

    class CheckedAsync(AsyncTrainer):
        """Clones the learner's parameters at every sync and checks the
        actor's against the last clone at every chunk's start."""

        synced, mismatches, chunk_starts = None, 0, 0

        def _sync(self, policy, n_opts):
            super()._sync(policy, n_opts)
            self.synced = [t.detach().clone() for t in policy.state_dict().values()]
            self.sync_steps = getattr(self, "sync_steps", []) + [n_opts]

        def _restore_checkpoint_extra(self, ex, agent_state):
            super()._restore_checkpoint_extra(ex, agent_state)
            self.synced = list(ex["actor_params"].values())

        def _dispatch(self, agent_state, *a, **kw):
            if self._actor_params is not None:
                self.chunk_starts += 1
                actor = list(self._actor_params.state_dict().values())
                if self.synced is None or not all(
                        torch.equal(x.cpu(), y.cpu()) for x, y in zip(actor, self.synced)):
                    self.mismatches += 1
            return super()._dispatch(agent_state, *a, **kw)

    upc = STEPS_PER_CHUNK * NUM_ENVS // OPT_INTERVAL
    cfg = TrainerConfig(num_envs=NUM_ENVS, steps_per_chunk=STEPS_PER_CHUNK,
                        batch_size=BATCH, opt_interval=OPT_INTERVAL,
                        warmup_period=0, max_opts=2 * upc)

    def build(manager, graphs=None):
        rec = _chunk_recorder()
        return CheckedAsync(
            make("Pong-v0"), _pixel_dqn(),
            FrameReplayBuffer(capacity=CAPACITY, num_envs=NUM_ENVS), cfg,
            recorder=rec, checkpoint_manager=manager,
            checkpoint_interval=upc if manager else 0, cuda_graphs=graphs), rec

    work = tempfile.mkdtemp(prefix="border_smoke_async_")
    try:
        mgr = CheckpointManager(os.path.join(work, "whole"), max_to_keep=2)
        tr, rec = build(mgr)
        torch.cuda.reset_peak_memory_stats()
        frame_gather.gather_frames.launches = 0
        t0 = time.perf_counter()
        r = tr.train(seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = frame_gather.gather_frames.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        chunks = [c for c in rec.chunks if "opt_steps_per_sec" in c]
        if r.opt_steps != 2 * upc or launches != r.opt_steps or len(chunks) != 2:
            fail(f"async pong: {launches} gather launches for {r.opt_steps} updates")
        want_syncs = [0]
        for n_opts in (upc, 2 * upc):
            if n_opts - want_syncs[-1] >= cfg.sync_interval:
                want_syncs.append(n_opts)
        if tr.mismatches or tr.chunk_starts != 2 or tr.sync_steps != want_syncs:
            fail(f"async pong: {tr.mismatches} of {tr.chunk_starts} chunk starts "
                 f"acted on other parameters than the last sync's; syncs at "
                 f"{tr.sync_steps}")
        if not all(math.isfinite(c["loss"]) for c in chunks):
            fail(f"async pong: losses {[c['loss'] for c in chunks]}")

        if not tr.cuda_graphs:
            fail("async pong: the AsyncTrainer on the card is not graphed")

        # the eager twin, from the same seeds: bitwise equal
        tr_e, rec_e = build(None, graphs=False)
        t0 = time.perf_counter()
        r_e = tr_e.train(seed=0)
        torch.cuda.synchronize()
        seconds_e = time.perf_counter() - t0
        for part, a, b in (("agent_state", r.agent_state, r_e.agent_state),
                           ("buffer_state", r.buffer_state, r_e.buffer_state),
                           ("actor_params", tr._actor_params, tr_e._actor_params)):
            bad = _state_diff(torch, a, b)
            if bad:
                fail(f"async pong: the eager twin differs in {part}: {bad[:8]}")
        chunks_e = [c for c in rec_e.chunks if "opt_steps_per_sec" in c]
        eager = {"seconds": seconds_e,
                 "env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks_e],
                 "updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks_e]}
        del tr_e, r_e
        _free(torch)

        os.makedirs(os.path.join(work, "killed"))
        os.rename(os.path.dirname(mgr._path(upc)), os.path.join(work, "killed", str(upc)))
        tr2, _ = build(None)
        frame_gather.gather_frames.launches = 0
        r2 = tr2.train(seed=0, resume_from=CheckpointManager(os.path.join(work, "killed")))
        torch.cuda.synchronize()
        launches2 = frame_gather.gather_frames.launches
        if r2.opt_steps != r.opt_steps or launches2 != upc or tr2.mismatches:
            fail(f"async pong: resumed run {r2.opt_steps} updates, {launches2} "
                 f"launches, {tr2.mismatches} stale-parameter mismatches")
        for part, a, b in (("agent_state", r.agent_state, r2.agent_state),
                           ("buffer_state", r.buffer_state, r2.buffer_state),
                           ("actor_params", tr._actor_params, tr2._actor_params)):
            bad = _state_diff(torch, a, b)
            if bad:
                fail(f"async pong: the resumed run differs in {part}: {bad[:8]}")
        result = {
            "env_steps": r.env_steps, "updates": r.opt_steps, "seconds": seconds,
            "gather_launches": launches, "resumed_gather_launches": launches2,
            "sync_steps": tr.sync_steps, "sync_interval": cfg.sync_interval,
            "env_steps_per_s_chunks": [c["samples_per_sec"] for c in chunks],
            "updates_per_s_chunks": [c["opt_steps_per_sec"] for c in chunks],
            "warmup_chunk_env_steps_per_s": rec.chunks[0]["samples_per_sec"],
            "max_memory_allocated_gb": peak_gb,
            "eager": eager, "graphed_equals_eager_bitwise": True,
        }
        print(f"async pong path: AsyncTrainer.train() Pong, {NUM_ENVS} envs, batch "
              f"{BATCH}, {r.opt_steps} updates in 2 update chunks, syncs at "
              f"{tr.sync_steps} (sync_interval {cfg.sync_interval}); env-steps/s "
              f"{chunks[-1]['samples_per_sec']:.1f}, updates/s "
              f"{chunks[-1]['opt_steps_per_sec']:.2f} (last chunk); the actor acted "
              f"on the last sync's parameters at every chunk; frame_gather "
              f"launches {launches} = updates; the eager twin ({seconds_e:.1f} s, "
              f"graphed {seconds:.1f} s) and a trainer resumed from step {upc} "
              f"ended bitwise equal", flush=True)
        print("async pong path numbers: " + json.dumps(result), flush=True)
        del tr2, r2
        _free(torch)
        print("async pong vs fused, in turns: " + json.dumps(
            _async_vs_fused(torch, tr, r)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches + launches2


def _numpy_values(pol, obs):
    """The values the numpy policy takes its argmax of (per action)."""
    import numpy as np

    m = pol.meta
    x = np.asarray(obs, np.float32)
    if m["kind"] == "iqn_argmax":
        return pol._iqn_q(x)
    if m["kind"] == "cnn_argmax":
        x = pol._cnn(x, "", m["conv_strides"], m["scale"])
    return pol._dense_stack(x, pol.layers)


def utilities_on_card(torch, dev) -> None:
    """Phase 23: the export of a DQN-AtariCNN state at the main path's width
    and of an IQN state at the Seaquest path's width, each run by the numpy
    policy against the port's float32 greedy action on the card (TF32 off);
    a profiler trace with CUDA kernel events; an elastic CartPole run that
    recovers from one injected crash, bitwise equal to the run without it."""
    import functools

    import numpy as np

    from border_tpu_torch.agents import DQN, IQN, DQNConfig, IQNConfig
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig, run_elastic
    from border_tpu_torch.utils import (CheckpointManager, NumpyMLPPolicy,
                                        export_policy, profile_trace)

    work = tempfile.mkdtemp(prefix="border_smoke_utils_")
    out = {}
    try:
        # -- export: numpy policy vs the port's float32 greedy action -------
        cnn32 = functools.partial(AtariCNN, dtype=torch.float32)
        cases = (
            ("dqn", "Pong-v0", DQN(DQNConfig(model=lambda n: cnn32(out_dim=n)))),
            ("iqn", "Seaquest-v0", IQN(IQNConfig(
                psi_fn=functools.partial(cnn32, out_dim=0, skip_linear=True),
                feature_dim=512, n_cos=64, hidden=(512,),
                sample_percents_act="const32"))))
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for label, env_id, agent in cases:
                vec = VecEnv(make(env_id), 64)
                st = agent.init(0, vec.observation_space, vec.action_space)
                vs = vec.reset(0)
                g = torch.Generator(device=dev).manual_seed(0)
                for _ in range(40):  # 40 random-action steps into the game
                    a = torch.randint(0, vec.action_space.n, (64,), generator=g,
                                      device=dev, dtype=torch.int32)
                    _, vs = vec.step(vs, a)
                obs = vs.obs
                path = export_policy(agent, st, os.path.join(work, label))
                pol = NumpyMLPPolicy(path)
                obs_np = obs.cpu().numpy()
                want = pol(obs_np)
                got = agent.select_action_eval(st, obs).cpu().numpy()
                v = np.sort(_numpy_values(pol, obs_np), axis=-1)
                clear = v[:, -1] - v[:, -2] > 1e-4 * max(float(np.abs(v).max()), 1.0)
                if clear.sum() < 32 or not np.array_equal(got[clear], want[clear]):
                    fail(f"export ({label}): the numpy policy's actions differ "
                         f"from the port's float32 greedy actions on the card "
                         f"({int(clear.sum())} of 64 past the margin)")
                out[f"export_{label}"] = {
                    "kind": pol.meta["kind"], "obs": list(obs_np.shape),
                    "actions_compared": int(clear.sum()),
                    "equal_everywhere": bool(np.array_equal(got, want))}
                del vec, vs, st
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

        # -- profile_trace: a Chrome trace with the card's kernels ----------
        trace_dir = os.path.join(work, "trace")
        net = AtariCNN(6).to(dev)
        x = torch.randint(0, 256, (512, 84, 84, 4), device=dev, dtype=torch.uint8)
        with profile_trace(trace_dir):
            for _ in range(3):
                net(x)
            torch.cuda.synchronize()
        (trace_file,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace_file)) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            fail("profile_trace: the trace holds no CUDA kernel event")
        out["profile_trace_kernel_events"] = len(kernels)

        # -- run_elastic: one injected crash, bitwise the uninterrupted run --
        cfg = TrainerConfig(max_opts=192, warmup_period=0, opt_interval=64,
                            batch_size=64, num_envs=128, steps_per_chunk=32,
                            eval_interval=10**9, seed=3)  # 64 updates a chunk
        crashes = [1]

        class CrashingTrainer(Trainer):
            def _chunk(self, *a, **kw):
                res = super()._chunk(*a, **kw)
                if crashes[0] and self.checkpoint_manager.latest_step() is not None:
                    crashes[0] -= 1
                    raise RuntimeError("injected fault")
                return res

        def trainer(mgr, cls=Trainer):
            return cls(make("CartPole-v1"), DQN(DQNConfig(hidden=(64, 64))),
                       ReplayBuffer(16_384), cfg, checkpoint_manager=mgr,
                       checkpoint_interval=64)

        attempts = []

        def make_trainer(mgr):
            attempts.append(mgr.latest_step())
            return trainer(mgr, CrashingTrainer)

        want = trainer(CheckpointManager(os.path.join(work, "whole"))).train()
        got = run_elastic(make_trainer, os.path.join(work, "elastic"),
                          max_restarts=1)
        torch.cuda.synchronize()
        bad = (_state_diff(torch, got.agent_state, want.agent_state)
               + _state_diff(torch, got.buffer_state, want.buffer_state))
        if attempts != [None, 64] or bad or (got.opt_steps, got.env_steps) != (
                want.opt_steps, want.env_steps):
            fail(f"run_elastic: attempts from {attempts}; the recovered run "
                 f"differs from the uninterrupted one in {bad[:8]}")
        out["elastic"] = {"attempts_from_step": attempts, "updates": got.opt_steps,
                          "bitwise_equal": True}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("utilities: the numpy export acts as the port's float32 greedy "
          "policy (DQN at Pong's width, IQN at Seaquest's); profile_trace "
          "traced the card's kernels; run_elastic recovered from a crash "
          "bitwise: " + json.dumps(out), flush=True)


def gif_frames(data: bytes):
    """(width, height, number of images) of a GIF89a file."""
    import struct

    if data[:6] != b"GIF89a" or data[-1:] != b";":
        fail("the GIF lacks its header or trailer")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    n = 0

    def skip_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension: introducer, label, sub-blocks
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image: descriptor, LZW code size, data
            n += 1
            lflags = data[pos + 9]
            pos += 10 + (3 << ((lflags & 7) + 1) if lflags & 0x80 else 0)
            pos = skip_blocks(pos + 1)
        else:
            fail(f"the GIF has an unknown block 0x{data[pos]:02x} at {pos}")
    return w, h, n


def jax_pong_policy(torch, dev) -> None:
    """Phase 24: the committed JAX-trained Pong policy, loaded by
    load_jax_policy into the port's bf16 AtariCNN, evaluated by the
    dqn_pong example's own evaluator."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.convert import load_jax_policy
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.train import Evaluator

    model = os.path.join(ROOT, "artifacts", "pong_model", "best")
    for f in ("dqn.npz", "dqn.treedef.txt"):
        if not os.path.isfile(os.path.join(model, f)):
            fail(f"the JAX-trained Pong model lacks {f} under {model}")
    with open(os.path.join(ROOT, "artifacts", "pong_curve.json")) as f:
        jax_evals = json.load(f)["final_evals"]
    ev = Evaluator(make("Pong-v0", train=False), n_episodes=10, max_steps=3_000)
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n)))
    st = load_jax_policy(agent, model, ev.vec.observation_space,
                         ev.vec.action_space)
    if st.params.dtype != torch.bfloat16 or not next(st.params.parameters()).is_cuda:
        fail("the loaded policy is not the port's bf16 AtariCNN on the card")
    if not ev.cuda_graphs:
        fail("the Pong evaluator on the card is not graphed")
    ev_eager = Evaluator(make("Pong-v0", train=False), n_episodes=10,
                         max_steps=3_000, cuda_graphs=False)
    seconds, records = {}, {}
    for which, e in (("graphed", ev), ("eager", ev_eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score, rec = e.evaluate(agent, st, eval_index=0)
        torch.cuda.synchronize()
        seconds[which] = time.perf_counter() - t0
        records[which] = dict(rec.items())
    record = records["graphed"]
    score = record["Episode return"]
    if records["eager"] != record:
        fail(f"the graphed Pong evaluation {record} differs from the eager one "
             f"{records['eager']}")
    # host operator calls an evaluation step: 16-step evaluations, traced
    # after their captures
    ops = {}
    for which, graphs in (("graphed", True), ("eager", False)):
        short = Evaluator(make("Pong-v0", train=False), n_episodes=10,
                          max_steps=16, cuda_graphs=graphs)
        short.evaluate(agent, st)
        ops[which] = trace(torch, lambda: short.evaluate(agent, st), 16)
    if not ops["graphed"]["host_ops_each"] < ops["eager"]["host_ops_each"]:
        fail(f"Pong evaluation: a graphed step makes "
             f"{ops['graphed']['host_ops_each']} host operator calls, an eager "
             f"one {ops['eager']['host_ops_each']}")
    print(f"JAX-trained Pong policy on the card (bf16 AtariCNN, load_jax_policy): "
          f"mean return {score:.2f} over 10 episodes in {seconds['graphed']:.2f} s "
          f"graphed, {seconds['eager']:.2f} s eager, the records bitwise equal "
          f"(min {record['Episode return min']}, max "
          f"{record['Episode return max']}, length {record['Episode length']}); "
          f"the JAX run's final evaluations {jax_evals}; the gate's target "
          f"{PONG_TARGET}: " + json.dumps(record), flush=True)
    print("Pong evaluation numbers: " + json.dumps(
        {"seconds": seconds,
         "host_ops_each_step": {k: v["host_ops_each"] for k, v in ops.items()},
         "traces": ops}), flush=True)
    if not score >= PONG_TARGET:
        fail(f"the JAX-trained Pong policy scored {score} on the card, under "
             f"{PONG_TARGET}")


class _MlflowStub:
    """An in-process MLflow REST stub on 127.0.0.1: records every request."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer

        requests = self.requests = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, payload):
                body = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                requests.append(("GET", self.path, None))
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                requests.append(("POST", self.path, body))
                if self.path.endswith("experiments/create"):
                    self._reply({"experiment_id": "1"})
                elif self.path.endswith("runs/create"):
                    self._reply({"run": {"info": {"run_id": "run1"}}})
                else:
                    self._reply({})

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.uri = f"http://127.0.0.1:{self.server.server_port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)

    def posted(self, endpoint):
        return [b for m, p, b in self.requests if m == "POST" and p.endswith(endpoint)]


def _example(torch, name: str, argv, seconds: dict):
    """``border_tpu_torch.examples.<name>.main(argv)`` on its default device
    (the card): its result and what it printed (kept off this script's
    output, whose lines a caller reads); its seconds into ``seconds``."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"border_tpu_torch.examples.{name}")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = mod.main(argv)
    torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    return res, out.getvalue()


def _printed(name: str, text: str, pattern: str) -> list:
    """The numbers of ``pattern``'s first match in what example ``name``
    printed: each must parse and be finite."""
    import re

    m = re.search(pattern, text)
    vals = [float(g.replace(",", "")) for g in m.groups()] if m else []
    if not vals or not all(math.isfinite(v) for v in vals):
        fail(f"{name} example: no finite {pattern!r} in what it printed: "
             f"{text[-800:]!r}")
    return vals


def _networks(state) -> list:
    """The networks (modules) of an agent state."""
    from torch import nn

    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), nn.Module)]


def _check_agent(torch, name: str, state, agent=None, model_dir=None) -> None:
    """Every network of ``state`` on the card and finite; with ``agent``,
    the model it saved under ``model_dir`` (``Agent.save``) loaded into a
    zeroed copy of ``state`` must give finite networks on the card that
    are not all zero."""
    import copy

    nets = _networks(state)
    if not nets or not all(p.is_cuda and torch.isfinite(p).all()
                           for n in nets for p in n.parameters()):
        fail(f"{name} example: parameters not finite or not on the card")
    if agent is None:
        return
    template = copy.deepcopy(state)
    with torch.no_grad():
        for n in _networks(template):
            for p in n.parameters():
                p.zero_()
    loaded = agent.load(template, model_dir)
    params = [p for n in _networks(loaded) for p in n.parameters()]
    if not (all(p.is_cuda and torch.isfinite(p).all() for p in params)
            and any(bool(p.ne(0).any()) for p in params)):
        fail(f"{name} example: the model saved under {model_dir} does not "
             f"read back into a state on the card")


def examples_on_card(torch, dev) -> int:
    """Phase 25: the examples' main(argv) at their default width and device
    (cuda), each cut in depth through its own options.  Returns the gather
    launches (dqn_pong's, async_dqn_pong's, iqn_seaquest's and
    dqn_pong_host's)."""
    import numpy as np

    from border_tpu_torch.agents import DQN, SAC, DQNConfig, SACConfig
    from border_tpu_torch.data import OfflineDataset
    from border_tpu_torch.examples import (convert_policy, dqn_cartpole, dqn_pong,
                                           offline_fetch_reacher)
    from border_tpu_torch.ops import frame_gather

    work = tempfile.mkdtemp(prefix="border_smoke_examples_")
    seconds = {}
    try:
        # dqn_pong: bench.py's width, the 50,000-step warmup, one update chunk
        t0 = time.perf_counter()
        frame_gather.gather_frames.launches = 0
        out = os.path.join(work, "pong")
        r = dqn_pong.main(["--max-opts", "512", "--tensorboard", "--out", out])
        torch.cuda.synchronize()
        launches = frame_gather.gather_frames.launches
        seconds["dqn_pong"] = time.perf_counter() - t0
        if r.opt_steps != 512 or launches != r.opt_steps:
            fail(f"dqn_pong example: {r.opt_steps} updates, {launches} gather "
                 f"launches")
        if not any(f.startswith("events.out.tfevents") for f in os.listdir(out)):
            fail("dqn_pong example: no TensorBoard event file")
        _check_agent(torch, "dqn_pong", r.agent_state)
        print(f"example dqn_pong: {r.opt_steps} updates after the 50,000-step "
              f"warmup, {launches} gather launches = updates, TensorBoard "
              f"events written, in {seconds['dqn_pong']:.1f} s", flush=True)
        del r
        _free(torch)

        # dqn_cartpole: the agent from a config, MLflow, checkpoints, resume
        try:
            import yaml  # noqa: F401
            have_yaml = True
        except ImportError:
            have_yaml = False
        agent_cfg = dqn_cartpole.default_agent().config
        out = os.path.join(work, "cartpole")
        stub = _MlflowStub()
        try:
            t0 = time.perf_counter()
            argv = ["--max-opts", "1024", "--checkpoint-interval", "256",
                    "--out", out, "--mlflow", stub.uri]
            if have_yaml:
                from border_tpu_torch.utils import save_config

                path = os.path.join(work, "agent.yaml")
                save_config(agent_cfg, path, kind="dqn")
                argv += ["--agent-config", path]
                r = dqn_cartpole.main(argv)
            else:  # the agent from a dict: build_agent, as the YAML would
                from border_tpu_torch.utils import build_agent, config_to_dict

                args = dqn_cartpole.parser().parse_args(argv)
                objs = dqn_cartpole.build(args)
                objs["agent"] = build_agent("dqn", config_to_dict(agent_cfg))
                r = dqn_cartpole.run(args, objs)
        finally:
            stub.close()
        metrics, params = stub.posted("runs/log-metric"), stub.posted("runs/log-parameter")
        finished = stub.posted("runs/update")
        keys = {p["key"] for p in params}
        if (r.opt_steps != 1024 or not r.eval_history
                or not {"trainer.max_opts", "agent.hidden", "env"} <= keys
                or not any(m["key"] == "Episode return" for m in metrics)
                or [u["status"] for u in finished] != ["FINISHED"]):
            fail(f"dqn_cartpole example: {r.opt_steps} updates, evaluations "
                 f"{r.eval_history}, {len(metrics)} metrics, params {sorted(keys)[:8]}, "
                 f"run updates {finished}")
        r2 = dqn_cartpole.main(["--max-opts", "1536", "--checkpoint-interval",
                                "256", "--out", out, "--resume"]
                               + (["--agent-config", path] if have_yaml else []))
        seconds["dqn_cartpole"] = time.perf_counter() - t0
        steps = sorted(int(d) for d in os.listdir(os.path.join(out, "ckpt")))
        if r2.opt_steps != 1536 or steps[-1] != 1536:
            fail(f"dqn_cartpole example: the resumed run ended at {r2.opt_steps}, "
                 f"checkpoints {steps}")
        print(f"example dqn_cartpole: agent from a {'YAML' if have_yaml else 'dict'} "
              f"config (PyYAML {'present' if have_yaml else 'absent'}), "
              f"{len(metrics)} MLflow metrics and {len(params)} params to a stub "
              f"on 127.0.0.1, checkpoints every 256 updates, then --resume from "
              f"1024 to {r2.opt_steps} (best evaluation {r.best_score:.1f}), in "
              f"{seconds['dqn_cartpole']:.1f} s", flush=True)

        # convert_policy: SAC, export, numpy-only deployment on C++ Pendulum
        t0 = time.perf_counter()
        returns = convert_policy.main(["--max-opts", "512", "--out",
                                       os.path.join(work, "policy")])
        seconds["convert_policy"] = time.perf_counter() - t0
        if returns is None or returns.shape != (5,) or not np.isfinite(returns).all():
            fail(f"convert_policy example: deployment returns {returns}")
        print(f"example convert_policy: 512 SAC updates, exported, numpy-only "
              f"deployment on 5 C++ Pendulum envs (mean return "
              f"{returns.mean():.1f}), in {seconds['convert_policy']:.1f} s",
              flush=True)

        # offline_fetch_reacher over the .npz corpus (the card has no h5py)
        t0 = time.perf_counter()
        r = offline_fetch_reacher.main(["--dataset", "fetch-reacher-medium-v0",
                                        "--max-opts", "250"])
        seconds["offline_fetch_reacher"] = time.perf_counter() - t0
        if r.opt_steps != 250:
            fail(f"offline_fetch_reacher example: {r.opt_steps} updates")
        _check_agent(torch, "offline_fetch_reacher", r.agent_state)
        print(f"example offline_fetch_reacher: IQL, 250 updates over "
              f"fetch-reacher-medium-v0 in {seconds['offline_fetch_reacher']:.1f} s",
              flush=True)
        _free(torch)

        # the pixel examples: their warmups and EXAMPLE_OPTS updates; the
        # gather launches once a sample
        for name, argv, opts, saves in (
                ("async_dqn_pong", ["--out", os.path.join(work, "async")],
                 EXAMPLE_OPTS["async_dqn_pong"], True),
                ("iqn_seaquest", ["--out", os.path.join(work, "iqn")],
                 EXAMPLE_OPTS["iqn_seaquest"], False),
                ("dqn_pong_host", [], EXAMPLE_OPTS["dqn_pong_host"], False)):
            frame_gather.gather_frames.launches = 0
            r, text = _example(torch, name, argv + ["--max-opts", str(opts)],
                               seconds)
            n = frame_gather.gather_frames.launches
            launches += n
            if r.opt_steps != opts or n != opts:
                fail(f"{name} example: {r.opt_steps} updates, {n} gather launches")
            _check_agent(torch, name, r.agent_state,
                         DQN(DQNConfig()) if saves else None,
                         os.path.join(argv[1], "best") if saves else None)
            if saves and len(r.eval_history) != 1:
                fail(f"{name} example: evaluations {r.eval_history}")
            pattern = {"async_dqn_pong": r"samples/s=([\d,.]+)\s+opt/s=([\d,.]+)",
                       "iqn_seaquest": r"opt_steps=(\d+) samples/s=([\d,.]+)",
                       "dqn_pong_host": r"samples/s ([\d,.]+)\s+host_wait_frac ([\d.]+)"}
            _printed(name, text, pattern[name])
            print(f"example {name}: {r.opt_steps} updates after its warmup, {n} "
                  f"gather launches = updates, evaluations {r.eval_history}, in "
                  f"{seconds[name]:.1f} s", flush=True)
            del r
            _free(torch)

        # the MLP examples: an evaluation at the end, the best model saved
        for name, agent in (("dqn_cartpole_native", DQN(DQNConfig())),
                            ("sac_pendulum", SAC(SACConfig())),
                            ("sac_reacher", SAC(SACConfig()))):
            out = os.path.join(work, name)
            r, text = _example(torch, name, ["--max-opts", str(EXAMPLE_OPTS[name]),
                                             "--out", out], seconds)
            if r.opt_steps != EXAMPLE_OPTS[name] or len(r.eval_history) != 1:
                fail(f"{name} example: {r.opt_steps} updates, evaluations "
                     f"{r.eval_history}")
            _check_agent(torch, name, r.agent_state, agent, os.path.join(out, "best"))
            ret, rate = _printed(name, text, r"best eval return=([-\d.]+)\s+"
                                 r"samples/s=([\d,.]+)")
            print(f"example {name}: {r.opt_steps} updates, best evaluation "
                  f"{ret}, {rate} samples/s, the best model read back, in "
                  f"{seconds[name]:.1f} s", flush=True)

        # offline_pendulum: its behavior corpus built (cut), then IQL
        corpus = os.path.join(work, "pendulum_corpus.npz")
        r, text = _example(torch, "offline_pendulum", [
            "--dataset", corpus, "--corpus-steps", str(EXAMPLE_CORPUS_STEPS),
            "--max-opts", str(EXAMPLE_OPTS["offline_pendulum"])], seconds)
        n = len(OfflineDataset.from_npz(corpus))
        if (n != EXAMPLE_CORPUS_STEPS or r.opt_steps != EXAMPLE_OPTS["offline_pendulum"]
                or _printed("offline_pendulum", text, r"dataset: (\d+) transitions") != [n]):
            fail(f"offline_pendulum example: a corpus of {n} transitions, "
                 f"{r.opt_steps} updates")
        _check_agent(torch, "offline_pendulum", r.agent_state)
        _printed("offline_pendulum", text, r"opt/s=([\d,.]+)")
        print(f"example offline_pendulum: a corpus of {n} transitions built and "
              f"read back, {r.opt_steps} IQL updates, in "
              f"{seconds['offline_pendulum']:.1f} s", flush=True)

        # offline_pendulum_medium: the committed corpus, each of its agents
        for agent in ("bc", "awac", "iql"):
            name = f"offline_pendulum_medium --agent {agent}"
            r, text = _example(torch, "offline_pendulum_medium", [
                "--agent", agent, "--max-opts",
                str(EXAMPLE_OPTS["offline_pendulum_medium"])], seconds)
            seconds[name] = seconds.pop("offline_pendulum_medium")
            if (r.opt_steps != EXAMPLE_OPTS["offline_pendulum_medium"]
                    or len(r.eval_history) != 1):
                fail(f"{name} example: {r.opt_steps} updates, evaluations "
                     f"{r.eval_history}")
            _check_agent(torch, name, r.agent_state)
            ret, norm = _printed(name, text, rf"{agent}: eval return ([-\d.]+) "
                                 r"\(normalized ([-\d.]+)")
            print(f"example {name}: {r.opt_steps} updates over pendulum-medium-v0, "
                  f"evaluation {ret} (normalized {norm}), in {seconds[name]:.1f} s",
                  flush=True)

        # play_pong: the committed JAX-trained policy into a GIF
        gif = os.path.join(work, "play.gif")
        returns, text = _example(torch, "play_pong", [
            "--no-render", "--gif", gif, "--steps", str(PLAY_STEPS)], seconds)
        with open(gif, "rb") as f:
            data = f.read()
        w, h, n = gif_frames(data)
        if ((w, h) != FRAME_HW[::-1] or not 0 < n <= PLAY_STEPS
                or f"gif: {gif}" not in text):
            fail(f"play_pong example: a GIF of {w}x{h} with {n} images")
        print(f"example play_pong: {PLAY_STEPS} steps into a GIF of {n} {w}x{h} "
              f"images ({len(data)} bytes), read back, episode returns {returns}, "
              f"in {seconds['play_pong']:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("examples seconds: " + json.dumps(seconds), flush=True)
    return launches


# -- phase 26: the multi-GPU paths ----------------------------------------------

def _pong_config(**kw):
    """bench.py's Pong config (the uniform path's), ``kw`` replaced."""
    from border_tpu_torch.train import TrainerConfig

    return TrainerConfig(num_envs=NUM_ENVS, steps_per_chunk=STEPS_PER_CHUNK,
                         batch_size=BATCH, opt_interval=OPT_INTERVAL,
                         warmup_period=0).replace(**kw)


def _loss_of(metrics) -> float:
    return float(metrics["loss"])


def sharded_world_of_one(torch, dev) -> dict:
    """Phase 26 (a): ShardedTrainer in a world of one rank over NCCL (a
    FileStore in a temporary directory) at the uniform path's config, one
    env chunk and one update chunk from the plain Trainer's states and
    generator state: the agent state and the ring must end bitwise equal
    to the plain Trainer's; then one chunk of ShardedAsyncTrainer."""
    import copy

    import torch.distributed as dist

    from border_tpu_torch.envs import make
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.parallel import (ShardedAsyncTrainer, ShardedTrainer,
                                           init_distributed, make_mesh)
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer
    from border_tpu_torch.utils import collectives
    from border_tpu_torch.utils.counters import sync_counters

    work = tempfile.mkdtemp(prefix="border_smoke_nccl_")
    init_distributed(f"file://{os.path.join(work, 'store')}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"sharded (a): backend {dist.get_backend()}, not nccl")
        cfg = _pong_config()
        env, mesh = make("Pong-v0"), make_mesh()
        plain = Trainer(env, _pixel_dqn(), FrameReplayBuffer(CAPACITY, NUM_ENVS), cfg)
        sharded = ShardedTrainer(env, _pixel_dqn(), FrameReplayBuffer(CAPACITY, NUM_ENVS),
                                 cfg, mesh=mesh)
        sharded_eager = ShardedTrainer(
            env, _pixel_dqn(), FrameReplayBuffer(CAPACITY, NUM_ENVS), cfg, mesh=mesh,
            cuda_graphs=False)
        if not (plain.cuda_graphs and sharded.cuda_graphs) or sharded_eager.cuda_graphs:
            fail("sharded (a): the plain and the NCCL trainer must be graphed")
        agent_state, vec_state, buf_state = plain.init_states(0, 1)
        states = {"plain": [agent_state, vec_state, buf_state]}
        for name, tr in (("sharded", sharded), ("sharded_eager", sharded_eager)):
            states[name] = [copy.deepcopy(agent_state), tr.vec.reset(1),
                            tr.buffer.init()]
        out, launches, reduces = {}, {}, {}
        for name, tr in (("plain", plain), ("sharded", sharded),
                         ("sharded_eager", sharded_eager)):
            st = states[name]
            gen = torch.Generator(device=dev).manual_seed(7)
            st[:] = tr._chunk(*st, gen, False)[:3]
            torch.cuda.synchronize()
            frame_gather.gather_frames.launches = 0
            collectives.counts.clear()
            t0 = time.perf_counter()
            *chunk, metrics, _, _ = tr._chunk(*st, gen, True)
            st[:] = chunk
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[name] = frame_gather.gather_frames.launches
            reduces[name] = sum(v for (op, _), v in collectives.counts.items()
                                if op == "all_reduce")
            out[name] = {"updates_per_s": tr.updates_per_chunk / dt,
                         "loss": _loss_of(metrics), "gen": gen,
                         "graphed": tr.cuda_graphs}
        n_upd = sharded.updates_per_chunk
        if (set(launches.values()) != {n_upd}
                or not math.isfinite(out["sharded"]["loss"])):
            fail(f"sharded (a): gather launches {launches} for {n_upd} updates, "
                 f"loss {out['sharded']['loss']}")
        # the update's gradient all-reduce counts one a replay, as eagerly
        if reduces["sharded"] != reduces["sharded_eager"] or reduces["sharded"] <= n_upd:
            fail(f"sharded (a): all-reduces graphed {reduces['sharded']}, eager "
                 f"{reduces['sharded_eager']} for {n_upd} updates")
        for name in ("sharded", "sharded_eager"):
            for part, i in (("agent state", 0), ("ring", 2)):
                bad = _state_diff(torch, states["plain"][i], states[name][i])
                if bad:
                    fail(f"sharded (a): the world-of-one {part} ({name}) differs "
                         f"from the plain Trainer's in {bad[:8]}")
            if out["plain"]["loss"] != out[name]["loss"]:
                fail(f"sharded (a): loss {out[name]['loss']} ({name}) != the "
                     f"plain Trainer's {out['plain']['loss']}")

        # host operator calls an update: 16 updates of each sharded twin,
        # traced after their captures, from the compared states
        ops = {}
        for name, tr in (("sharded", sharded), ("sharded_eager", sharded_eager)):
            tt = copy.copy(tr)
            tt.updates_per_chunk = 16
            a, _, b = states[name]
            gen_t = out[name]["gen"]
            tt._update_scan(a, b, gen_t)
            ops[name] = trace(torch, lambda: tt._update_scan(a, b, gen_t), 16)
        if not ops["sharded"]["host_ops_each"] < ops["sharded_eager"]["host_ops_each"]:
            fail(f"sharded (a): a graphed update makes "
                 f"{ops['sharded']['host_ops_each']} host operator calls, an "
                 f"eager one {ops['sharded_eager']['host_ops_each']}")
        # the host mirrors of the counters the replays advanced
        sync_counters(states["sharded"][0], states["sharded"][2])
        print(f"host operator calls an update (sharded (a), NCCL world of one): "
              f"graphed {ops['sharded']['host_ops_each']}, eager "
              f"{ops['sharded_eager']['host_ops_each']}", flush=True)
        del sharded_eager
        states.pop("sharded_eager")
        _free(torch)

        # the sharded update chunk again, its first-time costs paid (its
        # states go on from the compared ones, which were checked above)
        a, v, b = (copy.deepcopy(x) for x in states["sharded"])
        gen2 = torch.Generator(device=dev).manual_seed(8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, b = sharded._update_scan(a, b, gen2)[:2]
        torch.cuda.synchronize()
        again = sharded.updates_per_chunk / (time.perf_counter() - t0)
        del a, v, b

        # one chunk of ShardedAsyncTrainer, from the sharded run's states
        tr = ShardedAsyncTrainer(env, sharded.agent, sharded.buffer, cfg, mesh=mesh)
        a, v, b = states["sharded"]
        n0 = a.n_opts
        frame_gather.gather_frames.launches = 0
        t0 = time.perf_counter()
        a, v, b, metrics, _, _ = tr._dispatch(a, v, b, out["sharded"]["gen"], True)
        torch.cuda.synchronize()
        dt_async = time.perf_counter() - t0
        async_launches = frame_gather.gather_frames.launches
        if (a.n_opts - n0 != tr.updates_per_chunk or async_launches != tr.updates_per_chunk
                or not math.isfinite(_loss_of(metrics))):
            fail(f"sharded (a): the ShardedAsyncTrainer chunk ran {a.n_opts - n0} "
                 f"updates with {async_launches} gather launches")
        result = {"updates": n_upd, "updates_per_s_sharded": out["sharded"]["updates_per_s"],
                  "updates_per_s_sharded_eager": out["sharded_eager"]["updates_per_s"],
                  "updates_per_s_plain": out["plain"]["updates_per_s"],
                  "all_reduces_update_chunk": reduces["sharded"],
                  "host_ops_each_update": {k: v["host_ops_each"] for k, v in ops.items()},
                  "update_traces": ops,
                  "plain_graphed": out["plain"]["graphed"],
                  "sharded_update_chunk_again_updates_per_s": again,
                  "loss": out["sharded"]["loss"], "gather_launches": launches["sharded"],
                  "async_chunk_s": dt_async, "async_gather_launches": async_launches,
                  "async_loss": _loss_of(metrics)}
        print(f"sharded (a): ShardedTrainer, a world of one over NCCL, Pong "
              f"{NUM_ENVS} envs, batch {BATCH}: one env chunk and {n_upd} updates "
              f"bitwise equal to the plain Trainer (agent state, ring, loss), "
              f"graphed and eager; updates/s {result['updates_per_s_sharded']:.2f} "
              f"graphed, {result['updates_per_s_sharded_eager']:.2f} eager (plain "
              f"{result['updates_per_s_plain']:.2f}); then a ShardedAsyncTrainer "
              f"chunk in {dt_async:.2f} s, loss {result['async_loss']:.6g}", flush=True)
        return {**result, "launches_total": sum(launches.values()) + async_launches}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


def sharded_rank(spec_path: str, rank: int) -> None:
    """A rank of phase 26 (b), (c) and (d): two ranks on the one card over gloo.
    Writes ``rank<r>.json`` (and its parameters) into the spec's directory."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from border_tpu_torch.envs import make
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.parallel import (GSPMDTrainer, ShardedTrainer,
                                           init_distributed, make_dp_tp_mesh)
    from border_tpu_torch.parallel.gspmd import full_state_dict
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    work, dev = spec["dir"], torch.device("cuda")
    init_distributed(f"file://{os.path.join(work, 'store')}", 2, rank,
                     backend="gloo")
    res = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}
    try:
        # started while (a) runs: the card's work waits for (a)'s end
        deadline = time.perf_counter() + 300
        while not os.path.exists(os.path.join(work, "go")):
            if time.perf_counter() > deadline:
                raise TimeoutError("no go from the parent in 300 s")
            time.sleep(0.05)
        # (b) ShardedTrainer: 1024 envs and batch 512 over two ranks
        tr = ShardedTrainer(make("Pong-v0"), _pixel_dqn(),
                            FrameReplayBuffer(CAPACITY, NUM_ENVS), _pong_config())
        a, v, b = tr.init_states(0, 1)
        gen = tr._loop_generator(0)
        a, v, b = tr._chunk(a, v, b, gen, False)[:3]
        torch.cuda.synchronize()
        frame_gather.gather_frames.launches = 0
        t0 = time.perf_counter()
        a, v, b, metrics, _, _ = tr._chunk(a, v, b, gen, True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res["b"] = {"local_envs": tr.local_envs, "local_batch": tr.local_batch,
                    "updates": tr.updates_per_chunk, "loss": _loss_of(metrics),
                    "updates_per_s": tr.updates_per_chunk / dt,
                    "gather_launches": frame_gather.gather_frames.launches}
        torch.save({k: t.cpu() for k, t in a.params.state_dict().items()},
                   os.path.join(work, f"params{rank}.pt"))
        del tr, a, v, b
        torch.cuda.empty_cache()

        # (c) GSPMDTrainer, dp=1 and tp=2: the first update against the
        # plain Trainer's from the same ring and generator state (rank 0),
        # then the rest of a chunk cut to GSPMD_UPDATES updates
        cfg = _pong_config(steps_per_chunk=GSPMD_ENV_STEPS)
        g = GSPMDTrainer(make("Pong-v0"), _pixel_dqn(),
                         FrameReplayBuffer(CAPACITY, NUM_ENVS), cfg,
                         mesh=make_dp_tp_mesh(1, 2))
        ga, gv, gb = g.init_states(0, 1)
        sharded = {k: tuple(t.shape) for k, t in ga.params.state_dict().items()}
        plain = Trainer(make("Pong-v0"), _pixel_dqn(),
                        FrameReplayBuffer(CAPACITY, NUM_ENVS), cfg)
        pa, pv, pb = plain.init_states(0, 1)
        pgen = plain._loop_generator(0)
        pa, pv, pb = plain._chunk(pa, pv, pb, pgen, False)[:3]  # one env chunk
        ggen = torch.Generator(device=dev)
        ggen.set_state(pgen.get_state())
        g.updates_per_chunk = plain.updates_per_chunk = 1
        before = {k: t.clone() for k, t in pa.params.state_dict().items()}
        pa = plain._update_scan(pa, pb, pgen)[0]
        frame_gather.gather_frames.launches = 0
        ga, gb, _ = g._update_scan(ga, pb, ggen)  # the plain run's ring
        full = full_state_dict(ga.params)
        lr = float(ga.opt_state.param_groups[0]["lr"])
        diffs = torch.cat([(full[k] - t).abs().reshape(-1)
                           for k, t in pa.params.state_dict().items()])
        moved = max((pa.params.state_dict()[k] - t).abs().max().item()
                    for k, t in before.items())
        res["c"] = {
            "sharded_shapes": sharded, "lr": lr, "moved": moved,
            "max_abs_diff": diffs.max().item(),
            "frac_diff_over_1e-3_lr": (diffs > 1e-3 * lr).float().mean().item()}
        del plain, pa, pv, pb, before
        torch.cuda.empty_cache()
        g.updates_per_chunk = GSPMD_UPDATES
        gb = g.buffer.init()  # its own ring: an env chunk acting through TP
        t0 = time.perf_counter()
        ga, gv, gb, metrics, _, _ = g._chunk(ga, gv, gb, ggen, True)
        torch.cuda.synchronize()
        res["c"].update(chunk_s=time.perf_counter() - t0, loss=_loss_of(metrics),
                        env_steps=GSPMD_ENV_STEPS, updates=GSPMD_UPDATES + 1,
                        gather_launches=frame_gather.gather_frames.launches)
        del g, ga, gv, gb
        torch.cuda.empty_cache()
        res["d"] = gspmd_data_parallel(torch, dev, rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def gspmd_data_parallel(torch, dev, rank: int) -> dict:
    """Phase 26 (d), on a rank of the two: GSPMDTrainer at dp=2, tp=1, the
    ring's env columns split over ``actors`` (ActorShardedFrames, half the
    ring a rank) and the env step dp-fold.  An env chunk of GSPMD_ENV_STEPS
    steps beside the plain Trainer's from the same states and generator
    state: the rank's env rows and ring columns must equal the plain
    run's bitwise.  Then the first update from the same generator state
    against the plain Trainer's (DQN's update draws nothing: the two
    differ only by the order of the gradient's sums), then a chunk of
    GSPMD_UPDATES updates."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.ops import frame_gather
    from border_tpu_torch.parallel import GSPMDTrainer, make_dp_tp_mesh
    from border_tpu_torch.parallel.gspmd import ActorShardedFrames
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer

    cfg = _pong_config(steps_per_chunk=GSPMD_ENV_STEPS)
    g = GSPMDTrainer(make("Pong-v0"), _pixel_dqn(),
                     FrameReplayBuffer(CAPACITY, NUM_ENVS), cfg,
                     mesh=make_dp_tp_mesh(2, 1))
    plain = Trainer(make("Pong-v0"), _pixel_dqn(),
                    FrameReplayBuffer(CAPACITY, NUM_ENVS), cfg)
    pa, pv, pb = plain.init_states(0, 1)
    ga, gv, gb = g.init_states(0, 1)
    pgen = plain._loop_generator(0)
    ggen = torch.Generator(device=dev)
    ggen.set_state(pgen.get_state())
    pa, pv, pb = plain._chunk(pa, pv, pb, pgen, False)[:3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ga, gv, gb = g._chunk(ga, gv, gb, ggen, False)[:3]  # the dp-fold env steps
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t0
    lo, k = rank * g.local_envs, g.local_envs
    differ = [f.name for f in dataclasses.fields(gb)
              if torch.is_tensor(getattr(gb, f.name)) and f.name != "counts"
              and not torch.equal(getattr(gb, f.name), getattr(pb, f.name)[lo:lo + k])]
    if not torch.equal(gv.obs, pv.obs[lo:lo + k]):
        differ.append("obs")
    ring_gb = sum(t.numel() * t.element_size() for t in (gb.frames, gb.act, gb.reward,
                                                         gb.terminated, gb.truncated,
                                                         gb.age)) / 1e9
    ggen.set_state(pgen.get_state())
    g.updates_per_chunk = plain.updates_per_chunk = 1
    before = {k_: t.clone() for k_, t in pa.params.state_dict().items()}
    pa = plain._update_scan(pa, pb, pgen)[0]
    frame_gather.gather_frames.launches = 0
    ga, gb, _ = g._update_scan(ga, gb, ggen)
    got = ga.params.state_dict()
    lr = float(ga.opt_state.param_groups[0]["lr"])
    diffs = torch.cat([(got[k_] - t).abs().reshape(-1)
                       for k_, t in pa.params.state_dict().items()])
    moved = max((pa.params.state_dict()[k_] - t).abs().max().item()
                for k_, t in before.items())
    out = {"local_envs": k, "dp": g.dp, "tp": g.tp,
           "sharded_ring": isinstance(g.buffer, ActorShardedFrames),
           "ring_gb": ring_gb, "env_chunk_s": env_s, "differ_from_plain": differ,
           "lr": lr, "moved": moved, "max_abs_diff": diffs.max().item(),
           "frac_diff_over_1e-3_lr": (diffs > 1e-3 * lr).float().mean().item()}
    del plain, pa, pv, pb, before
    torch.cuda.empty_cache()
    g.updates_per_chunk = GSPMD_UPDATES
    t0 = time.perf_counter()
    ga, gv, gb, metrics, _, _ = g._chunk(ga, gv, gb, ggen, True)
    torch.cuda.synchronize()
    out.update(chunk_s=time.perf_counter() - t0, loss=_loss_of(metrics),
               env_steps=2 * GSPMD_ENV_STEPS, updates=GSPMD_UPDATES + 1,
               gather_launches=frame_gather.gather_frames.launches,
               params_sum=float(sum(t.double().sum() for t in
                                    ga.params.state_dict().values())))
    return out


def start_two_ranks():
    """Phase 26 (b), (c) and (d): two ranks of this script on the one card,
    started (imports, process group) before (a) and waiting for its end."""
    work = tempfile.mkdtemp(prefix="border_smoke_gloo_")
    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as f:
        json.dump({"dir": work}, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sharded-rank", spec, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    return work, procs


def finish_two_ranks(torch, work, procs) -> dict:
    """Lets the two ranks run, waits for them and checks what they wrote
    (the caller kills a rank left running and removes ``work``)."""
    open(os.path.join(work, "go"), "w").close()
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(f"rank {r} exited {p.returncode}: {err[-3000:]}")
    except subprocess.TimeoutExpired:
        errs.append("the two ranks outlasted 300 s")
    if errs:
        fail("sharded (b, c, d): " + "\n".join(errs))
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    p0, p1 = (torch.load(os.path.join(work, f"params{r}.pt")) for r in range(2))

    b = [r["b"] for r in ranks]
    if any(r["backend"] != "gloo" or r["world"] != 2 for r in ranks):
        fail(f"sharded (b): ranks {[(r['backend'], r['world']) for r in ranks]}")
    bad = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    if bad:
        fail(f"sharded (b): the parameters differ across the ranks in {bad}")
    for x in b:
        if (x["local_envs"] != NUM_ENVS // 2 or x["local_batch"] != BATCH // 2
                or x["gather_launches"] != x["updates"] or not math.isfinite(x["loss"])):
            fail(f"sharded (b): {x}")
    c = [r["c"] for r in ranks]
    want = {"conv0.weight": [16, 4, 8, 8], "conv1.weight": [32, 32, 4, 4],
            "conv2.weight": [32, 64, 3, 3], "fc0.weight": [256, 3136],
            "fc1.weight": [3, 512], "fc0.bias": [512]}
    for x in c:
        shapes = {k: list(v) for k, v in x["sharded_shapes"].items()}
        if any(shapes[k] != v for k, v in want.items()):
            fail(f"sharded (c): the rank holds {shapes}")
        # Adam's first step is about lr·sign(g): both runs step each element
        # by at most lr, and the same amount wherever the bf16 gradient's
        # sign does not flip between the two layouts' summation orders
        if (x["max_abs_diff"] > 2 * x["lr"] * (1 + 1e-3)
                or x["frac_diff_over_1e-3_lr"] > GSPMD_MAX_FRAC
                or x["moved"] < 0.5 * x["lr"]
                or not math.isfinite(x["loss"])
                or x["gather_launches"] != x["updates"]):
            fail(f"sharded (c): {x}")
    print(f"sharded (b): ShardedTrainer, two ranks on the one card over gloo, "
          f"{NUM_ENVS} envs ({NUM_ENVS // 2} a rank), batch {BATCH} ({BATCH // 2} "
          f"a rank): one env chunk and {b[0]['updates']} updates, parameters "
          f"bitwise equal across the ranks, loss {b[0]['loss']:.6g}; updates/s "
          f"{b[0]['updates_per_s']:.2f}, {b[1]['updates_per_s']:.2f}; gather "
          f"launches {b[0]['gather_launches']}, {b[1]['gather_launches']}", flush=True)
    print(f"sharded (c): GSPMDTrainer dp=1 tp=2 over gloo on the one card, "
          f"bf16 AtariCNN column-sharded (conv0 {want['conv0.weight']} a rank): "
          f"after the first update max |GSPMD - plain Trainer| "
          f"{c[0]['max_abs_diff']:.3g} (bound 2 lr = {2 * c[0]['lr']:.3g}), "
          f"{c[0]['frac_diff_over_1e-3_lr']:.5f} of the elements beyond 1e-3 lr "
          f"(bound {GSPMD_MAX_FRAC}); a chunk of {GSPMD_ENV_STEPS} env steps and "
          f"{GSPMD_UPDATES} updates in {c[0]['chunk_s']:.2f} s, loss "
          f"{c[0]['loss']:.6g}", flush=True)
    d = [r["d"] for r in ranks]
    for x in d:
        if (not x["sharded_ring"] or (x["dp"], x["tp"]) != (2, 1)
                or x["local_envs"] != NUM_ENVS // 2 or x["differ_from_plain"]
                or x["max_abs_diff"] > 2 * x["lr"] * (1 + 1e-3)
                or x["frac_diff_over_1e-3_lr"] > GSPMD_MAX_FRAC
                or x["moved"] < 0.5 * x["lr"]
                or not math.isfinite(x["loss"])
                or x["gather_launches"] != x["updates"]):
            fail(f"sharded (d): {x}")
    if d[0]["params_sum"] != d[1]["params_sum"]:
        fail(f"sharded (d): the replicated parameters differ across the ranks "
             f"(sums {d[0]['params_sum']!r}, {d[1]['params_sum']!r})")
    print(f"sharded (d): GSPMDTrainer dp=2 tp=1 over gloo on the one card, "
          f"{NUM_ENVS // 2} envs and the ring's env columns ({d[0]['ring_gb']:.3f} "
          f"GB) a rank: {GSPMD_ENV_STEPS} dp-fold env steps bitwise the plain "
          f"Trainer's rows and ring columns ({d[0]['env_chunk_s']:.2f} s); after "
          f"the first update max |GSPMD - plain Trainer| {d[0]['max_abs_diff']:.3g} "
          f"(bound 2 lr = {2 * d[0]['lr']:.3g}), "
          f"{max(x['frac_diff_over_1e-3_lr'] for x in d):.5f} of the elements "
          f"beyond 1e-3 lr (bound {GSPMD_MAX_FRAC}); a chunk of {GSPMD_ENV_STEPS} "
          f"env steps and {GSPMD_UPDATES} updates in {d[0]['chunk_s']:.2f} s, "
          f"loss {d[0]['loss']:.6g}", flush=True)
    launches = sum(x["gather_launches"] for part in (b, c, d) for x in part)
    return {"b": b, "c": c, "d": d, "launches_total": launches}


def sharded_example(torch) -> dict:
    """Phase 26 (e): the sharded_dqn example through main(argv), a world of
    one over NCCL, its defaults' width, --max-opts cut to 1,000."""
    import torch.distributed as dist

    from border_tpu_torch.examples import sharded_dqn

    t0 = time.perf_counter()
    r = sharded_dqn.main(["--max-opts", "1000"])
    seconds = time.perf_counter() - t0
    if (r.opt_steps < 1000 or not r.eval_history or dist.is_initialized()
            or not all(p.is_cuda and torch.isfinite(p).all()
                       for p in r.agent_state.params.parameters())):
        fail(f"sharded (e): {r.opt_steps} updates, evaluations {r.eval_history}")
    print(f"sharded (e): the sharded_dqn example, a world of one over NCCL, "
          f"{r.opt_steps} updates, evaluation {r.eval_history}, in {seconds:.1f} s",
          flush=True)
    return {"updates": r.opt_steps, "seconds": seconds,
            "updates_per_s": r.opt_per_sec, "eval_history": r.eval_history}


def sharded_paths(torch, dev) -> int:
    """Phase 26.  Returns the gather launches of the sharded runs (the two
    worker ranks' included)."""
    t = {}
    work, procs = start_two_ranks()
    try:
        t0 = time.perf_counter()
        a = sharded_world_of_one(torch, dev)
        _free(torch)
        t["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bc = finish_two_ranks(torch, work, procs)
        t["b_c_d"] = time.perf_counter() - t0
    finally:  # a failed check leaves no rank behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    e = sharded_example(torch)
    t["e"] = time.perf_counter() - t0
    print("sharded path numbers: " + json.dumps(
        {"a": a, "b": bc["b"], "c": bc["c"], "d": bc["d"], "e": e, "seconds": t}),
        flush=True)
    return a["launches_total"] + bc["launches_total"]



def reset_paths(torch, dev) -> None:
    """Phase 27: every registered env id's evaluation reset on the card is
    the CPU's, bitwise (obs and state) at RESET_INDICES; then a fixed AWAC
    policy (seed 0's initial parameters) evaluated at awac_offline's
    evaluation config on the card and on the CPU from index 0: the same
    lengths, and returns within RESET_EVAL_RTOL / RESET_EVAL_ATOL."""
    from border_tpu_torch import learning
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make, registry
    from border_tpu_torch.train.graphs import _leaves

    cpu = torch.device("cpu")
    leaves = 0
    for env_id in sorted(registry):
        on_cpu = VecEnv(make(env_id), EVAL_EPISODES, device=cpu)
        on_card = VecEnv(make(env_id), EVAL_EPISODES, device=dev)
        for index in RESET_INDICES:
            a = on_cpu.reset_with_index(RESET_BASE_SEED, index)
            b = on_card.reset_with_index(RESET_BASE_SEED, index)
            for (k, x), (_, y) in zip(_leaves({"obs": a.obs, "state": a.env_state}),
                                      _leaves({"obs": b.obs, "state": b.env_state}),
                                      strict=True):
                if not (y.device.type == dev.type and x.dtype == y.dtype
                        and torch.equal(x, y.cpu())):
                    fail(f"resets: {env_id} index {index}: {k} differs between "
                         f"the card and the CPU")
                leaves += 1
            if b.gen.device.type != dev.type:
                fail(f"resets: {env_id}: the in-episode generator is on {b.gen.device}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out, policy = [], None
        for d in (dev, cpu):
            _, agent, _, ev = learning.offline_config("awac_offline", d)
            vec = ev.vec
            state = agent.init(0, vec.observation_space, vec.action_space, device=d)
            if policy is None:
                policy = agent.policy_params(state).state_dict()
            else:
                agent.policy_params(state).load_state_dict(policy)
            t0 = time.perf_counter()
            returns, lengths, running = ev._rollout(agent, state, 0)
            score, _ = ev.evaluate(agent, state, eval_index=0)
            if d.type == "cuda":
                torch.cuda.synchronize()
            out.append((returns.cpu(), lengths.cpu(), int(running),
                        time.perf_counter() - t0, score))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (rg, lg, ng, sg, score_g), (rc, lc, nc, sc, score_c) = out
    err = (rg - rc).abs().max().item()
    if not (torch.equal(lg, lc) and ng == nc
            and torch.allclose(rg, rc, rtol=RESET_EVAL_RTOL, atol=RESET_EVAL_ATOL)):
        fail(f"resets: the AWAC evaluation on the card differs from the CPU's: "
             f"max |return diff| {err}, lengths equal {torch.equal(lg, lc)}")
    print(f"resets: {len(registry)} env ids x {len(RESET_INDICES)} indices, "
          f"{leaves} obs and state tensors bitwise the CPU's; awac_offline's "
          f"evaluation ({rg.numel()} episodes x {learning.OFFLINE_EVAL_STEPS} steps) "
          f"of seed 0's AWAC policy: max |card - CPU| return {err:.3g}, mean "
          f"return {rg.mean().item():.6g} / {rc.mean().item():.6g}, evaluation "
          f"score {score_g:.4f} / {score_c:.4f}, {sg:.2f} / {sc:.2f} s", flush=True)


def bench_path(torch, dev) -> int:
    """Phase 28: the four functions of border_tpu_torch.bench at full width,
    cut to BENCH_CHUNKS timed chunks and BENCH_STEPS timed steps.  The frame
    gather must launch once an update (the fused Pong bench: the untimed
    chunk's and the timed chunks'; the per-step one: its first update and a
    step's); the line must hold bench.py's keys plus ``device``, every rate
    finite and above 0.  Returns the gather's launches."""
    from border_tpu_torch import bench, learning
    from border_tpu_torch.ops import frame_gather

    t = {}
    frame_gather.gather_frames.launches = 0
    t0 = time.perf_counter()
    pong_eps, pong_ups, pong_env_only = bench.bench_pong_fused(BENCH_CHUNKS, dev)
    t["pong_fused"] = time.perf_counter() - t0
    fused_launches = frame_gather.gather_frames.launches
    _, _, _, cfg = bench.pong_fused_config(dev)
    fused_updates = (BENCH_CHUNKS + 1) * cfg.steps_per_chunk * cfg.num_envs // cfg.opt_interval
    _free(torch)
    frame_gather.gather_frames.launches = 0
    t0 = time.perf_counter()
    pong_base = bench.bench_pong_reference_architecture(BENCH_STEPS, dev)
    t["pong_per_step"] = time.perf_counter() - t0
    base_launches = frame_gather.gather_frames.launches
    if fused_launches != fused_updates or base_launches != BENCH_STEPS + 1:
        fail(f"bench: frame_gather launched {fused_launches} times for "
             f"{fused_updates} fused updates and {base_launches} for "
             f"{BENCH_STEPS + 1} per-step updates")
    _free(torch)
    t0 = time.perf_counter()
    cp_fused = bench.bench_fused(BENCH_CHUNKS, dev)
    t["cartpole_fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp_base = bench.bench_reference_architecture(BENCH_STEPS, dev)
    t["cartpole_per_step"] = time.perf_counter() - t0
    line = bench.result_line(pong_eps, pong_ups, pong_env_only, pong_base,
                             cp_fused, cp_base, learning.device_label(dev))
    rates = [v for k, v in line.items() if isinstance(v, float)]
    if (set(line) != BENCH_KEYS or len(rates) != 9
            or not all(math.isfinite(v) and v > 0 for v in rates)
            or torch.cuda.get_device_name(dev) not in line["device"]):
        fail(f"bench: line {line}")
    print(f"bench: border_tpu_torch.bench at full width, {BENCH_CHUNKS} timed "
          f"chunks and {BENCH_STEPS} timed steps; frame_gather launches "
          f"{fused_launches} = fused updates, {base_launches} = per-step "
          f"updates; seconds {json.dumps({k: round(v, 2) for k, v in t.items()})}",
          flush=True)
    print("bench line (cut): " + json.dumps(line), flush=True)
    return fused_launches + base_launches


def dryrun_path(torch, dev) -> int:
    """Phase 29: border_tpu_torch.dryrun on the card: entry()'s forward, then
    dryrun_multichip(2), two gloo ranks on the one card, its five lines.
    Returns the ranks' gather launches."""
    from border_tpu_torch import dryrun

    fn, args = dryrun.entry(device=dev)
    with torch.no_grad():
        q = fn(*args)
    if q.shape != (8, 6) or not q.is_cuda or not torch.isfinite(q.float()).all():
        fail(f"dryrun: entry's forward gave {tuple(q.shape)} on {q.device}")
    t0 = time.perf_counter()
    lines, launches = dryrun.dryrun_multichip(2, dev)
    seconds = time.perf_counter() - t0
    heads = ("dryrun_multichip OK", "dryrun_multichip pixel OK",
             "dryrun_multichip dp×tp OK", "dryrun_multichip pixel dp×tp OK",
             "dryrun_multichip sharded-async OK")
    # the pixel chunks' updates, a gather on each rank each: ShardedTrainer's
    # 4 and GSPMDTrainer's 2
    if (len(lines) != len(heads) or launches != 2 * (4 + 2)
            or not all(x.startswith(h) for x, h in zip(lines, heads))):
        fail(f"dryrun: lines {lines}, gather launches {launches}")
    print(f"dryrun: entry's forward (8, 6) on the card; dryrun_multichip(2) over "
          f"gloo on the one card, five lines, in {seconds:.1f} s; frame_gather "
          f"launches on the ranks {launches}", flush=True)
    return launches

if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--only"]:
        main(only=set(sys.argv[2].split(",")))
    else:
        main()
