"""Tests that need the card: the port's CUDA kernels against their plain
PyTorch versions, bitwise, and the Adam kernel's optimizers against torch's
capturable Adam and AdamW, bitwise; the bf16 Atari torso's kernels (no float32
fallback, no layout transposes); the sum tree, the games, the classic-control
envs and the Reacher, and the DQN, IQN, SAC, AWAC and IQL updates on the
card against the CPU path; a small prioritized train-checkpoint-resume on
the card; the graphed chunk (CUDA-graph replays) against the eager one,
bitwise, on every graphed path, a graphed run resumed from a checkpoint,
and a body that cannot be captured; the same for the host-env trainer in
frame and flat mode, both evaluators, the async actor-learner (a sync and
a resume) and a world of one ShardedTrainer over NCCL.  They skip without
a CUDA device.

This file imports no JAX, so on a machine without it (the GPU machine) it
runs without the repo's JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from border_tpu_torch.models.cnn import space_to_depth
from border_tpu_torch.ops import frame_gather
from border_tpu_torch.ops import gather_frames, gather_frames_ref


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, b, s, dtype",
    [
        ((37, 84, 84), 9, 4, torch.uint8),
        ((4096, 84, 84), 512, 4, torch.uint8),  # separate mode, n-step
        ((16, 12, 20), 7, 5, torch.uint8),
        ((16, 12, 20), 7, 5, torch.float32),
        ((1031, 84, 84), 513, 5, torch.uint8),  # B·S not a multiple of the block
        ((16, 7, 9), 7, 5, torch.uint8),  # 63 B frames: the byte path
    ],
)
@pytest.mark.parametrize("offset", [0, 1])  # 1: a base not 16-aligned
def test_gather_frames_kernel_matches_plain_version_on_card(shape, b, s, dtype,
                                                             offset):
    """The CUDA kernel against ``frames[idx]`` on the card, bitwise."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    m, h, w = shape
    flat = (torch.randint(0, 256, (offset + m * h * w,), generator=g,
                          device="cuda").to(dtype))
    frames = flat[offset:].view(shape)
    idx = torch.randint(0, shape[0], (b, s), generator=g, device="cuda",
                        dtype=torch.int32)
    launches = frame_gather.gather_frames.launches
    out = gather_frames(frames, idx)
    torch.cuda.synchronize()
    assert frame_gather.gather_frames.launches == launches + 1
    assert torch.equal(out, gather_frames_ref(frames, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [5, 4])
def test_gather_frames_kernel_reads_past_byte_offset_2_31(s):
    """A ring the size of the prioritized path's (1024·512 frames, 3.70 GB):
    half of the indices name frames that lie wholly past byte 2^31."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    m = 1024 * 512
    frames = torch.randint(0, 256, (m, 84, 84), generator=g, device="cuda",
                           dtype=torch.uint8)
    past = 2**31 // (84 * 84) + 1
    idx = torch.randint(0, m, (512, s), generator=g, device="cuda",
                        dtype=torch.int32)
    idx[256:] = torch.randint(past, m, (256, s), generator=g, device="cuda",
                              dtype=torch.int32)
    idx[-1, -1] = m - 1
    assert torch.equal(gather_frames(frames, idx), gather_frames_ref(frames, idx))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_buffer_sample_through_kernel_matches_cpu_path():
    """The same pushes and draws into a CUDA buffer (kernel gather) and a
    CPU buffer (plain gather): the batches are equal bitwise."""
    import types

    from border_tpu_torch.replay import FrameReplayBuffer

    dev = _cuda()
    n, cap = 8, 32
    bufs = {d: FrameReplayBuffer(cap, n, device=d) for d in ("cpu", dev)}
    states = {d: b.init() for d, b in bufs.items()}
    g = torch.Generator().manual_seed(0)
    ep = torch.zeros(n, dtype=torch.int32)
    for _ in range(cap + 5):
        obs = torch.randint(0, 256, (n, 84, 84, 4), generator=g, dtype=torch.uint8)
        act = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
        term = torch.rand(n, generator=g) < 0.2
        for d, b in bufs.items():
            ts = types.SimpleNamespace(reward=torch.ones(n, device=d),
                                       terminated=term.to(d),
                                       truncated=torch.zeros(n, dtype=torch.bool,
                                                             device=d))
            states[d] = b.process_step(states[d], obs.to(d), act.to(d), ts,
                                       ep.to(d))
        ep = torch.where(term, 0, ep + 1).to(torch.int32)
    e, s = bufs["cpu"].draw(states["cpu"], g, 256)
    launches = frame_gather.gather_frames.launches
    got = bufs[dev].sample_at(states[dev], e.to(dev), s.to(dev))
    torch.cuda.synchronize()
    assert frame_gather.gather_frames.launches == launches + 1
    want = bufs["cpu"].sample_at(states["cpu"], e, s)
    for name in ("obs", "next_obs", "act", "terminated", "ix_sample"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_gather_frames_raises_on_non_contiguous_cuda_input():
    dev = _cuda()
    frames = torch.zeros((8, 84, 84), dtype=torch.uint8, device=dev)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gather_frames(frames.transpose(1, 2), idx)


# substrings of the kernels cuDNN runs around a convolution whose layout or
# channel count its bf16 tensor-core kernels do not take: the float32
# fallback (``…f32f32_f32f32_f32…``) and the transposes and conversions
_TORSO_DETOURS = ("f32f32_f32f32", "nchwToNhwc", "nhwcToNchw", "convertTensor")


@pytest.mark.cuda
def test_bf16_torso_runs_no_fallback_or_transposes_on_card():
    """A bf16 torso forward and backward at batch 512 from a ``[512, 5, 84,
    84]`` union gather (the replay8 cells' update) runs no float32 fallback
    convolution and no layout transpose or conversion: conv0 over the
    space-to-depth input, every convolution channels-last."""
    from torch.profiler import ProfilerActivity, profile

    from border_tpu_torch.models import AtariCNN

    dev = _cuda()
    net = AtariCNN(6)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.to(dev)
    g = torch.randint(0, 256, (512, 5, 84, 84), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1)).to(dev)
    obs = g[:, :4].permute(0, 2, 3, 1)  # the sampled stack, NHWC, not dense

    def step():
        net.zero_grad(set_to_none=True)
        net(obs).square().mean().backward()

    step()  # cuDNN's plans and the allocator, outside the trace
    torch.cuda.synchronize()
    before = space_to_depth.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    assert space_to_depth.launches == before + 1
    cuda = torch.autograd.DeviceType.CUDA
    names = {e.name for e in prof.events() if e.device_type == cuda}
    assert names, "the profiler saw no kernel"
    detours = sorted(n for n in names if any(d in n for d in _TORSO_DETOURS))
    assert not detours, detours
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in net.parameters())


@pytest.mark.cuda
def test_sum_tree_on_card_matches_cpu_path():
    """The same updates (duplicate indices with different priorities among
    them) and injected uniforms: the same leaves; trees and weights to 1e-6
    relative."""
    from border_tpu_torch.replay import SumTree

    dev = _cuda()
    cap, b = 4096, 256
    g = torch.Generator().manual_seed(0)
    trees = {d: SumTree(cap, device=d) for d in ("cpu", dev)}
    states = {d: t.init() for d, t in trees.items()}
    for _ in range(6):
        idx = torch.randint(0, cap, (b,), generator=g)
        idx[b // 2:] = idx[: b // 2]
        pr = torch.rand(b, generator=g) * 3
        pr[torch.rand(b, generator=g) < 0.1] = 0.0
        for d, t in trees.items():
            t.update(states[d], idx.to(d), pr.to(d))
    u = torch.rand(b, generator=g)
    leaves = {d: t.sample(states[d], b, u=u.to(d)) for d, t in trees.items()}
    assert torch.equal(leaves[dev].cpu(), leaves["cpu"])
    for name in ("sum_tree", "min_tree", "max_priority"):
        torch.testing.assert_close(getattr(states[dev], name).cpu(),
                                   getattr(states["cpu"], name),
                                   rtol=1e-6, atol=0.0)
    for norm_all in (True, False):
        w = {d: t.weights(states[d], leaves[d], 3000, 0.6, norm_all)
             for d, t in trees.items()}
        torch.testing.assert_close(w[dev].cpu(), w["cpu"], rtol=1e-6, atol=0.0)


def _tree_updates(case, cap, g):
    """The update batches of a card case as ``(indices, priorities of a
    state)`` pairs: the priorities may read the state's own scalar."""
    dev = torch.device("cuda")
    if case == "push":  # FrameReplayBuffer._tree_push: 1024 envs x 5 slots
        envs, slots = 1024, cap // 1024
        base = (torch.arange(envs, device=dev) * slots)[:, None]
        enters = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0], device=dev)
        return [((base + (p + torch.arange(5, device=dev)) % slots).reshape(-1),
                 lambda st: (enters * st.max_priority)[None, :]
                 .expand(envs, -1).reshape(-1))
                for p in (0, 3, slots - 2)]
    if case == "empty":
        return [(torch.zeros(0, dtype=torch.int64, device=dev),
                 lambda st: torch.zeros(0, device=dev))]
    if case == "stride0":  # the flat ring's push: max_priority.expand(n)
        return [(torch.randint(0, cap, (512,), generator=g, device=dev),
                 lambda st: st.max_priority.expand(512))]
    if case == "left_half":  # the right subtree's sum stays zero
        idx = torch.randint(0, cap // 2, (512,), generator=g, device=dev)
        pr = torch.rand(512, generator=g, device=dev) + 0.01
        return [(idx, lambda st: pr)]
    out = []
    for _ in range(3):  # K = 512, every index twice with two priorities
        idx = torch.randint(0, cap, (512,), generator=g, device=dev)
        idx[256:] = idx[:256]
        pr = torch.rand(512, generator=g, device=dev) * 5
        pr[torch.rand(512, generator=g, device=dev) < 0.1] = 0.0
        out.append((idx, lambda st, pr=pr: pr))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case, cap", [
    ("push", 2**20), ("dups", 2**20), ("empty", 4096), ("stride0", 2**20),
    ("left_half", 64), ("dups", 64), ("dups", 4096), ("push", 4096)])
def test_sum_tree_kernels_match_plain_version_on_card(case, cap):
    """The update and descent kernels against the plain loop on the same
    card tensors, bitwise: the trees, the max priority and the leaves of
    descents at B = 512 (u = 1 - 2^-24 among the draws) and B = 37."""
    from border_tpu_torch.ops import (sum_tree_sample, sum_tree_sample_ref,
                                      sum_tree_update, sum_tree_update_ref)
    from border_tpu_torch.replay import SumTree

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(cap + len(case))
    tree = SumTree(cap, device=dev)
    kern = tree.init()
    # a tree already in use: half the leaves live, a fifth of them dead
    idx = torch.randperm(cap, generator=g, device=dev)[: cap // 2]
    pr = torch.rand(idx.shape, generator=g, device=dev) * 2 + 0.01
    pr[torch.rand(idx.shape, generator=g, device=dev) < 0.2] = 0.0
    if case == "left_half":
        kern.sum_tree.zero_()
        kern.min_tree.fill_(float("inf"))
    else:
        sum_tree_update_ref(kern.sum_tree, kern.min_tree, kern.max_priority,
                            idx, pr)
    plain = type(kern)(*(x.clone() for x in (kern.sum_tree, kern.min_tree,
                                              kern.max_priority)))
    n0, s0 = sum_tree_update.launches, sum_tree_sample.launches
    updates = _tree_updates(case, cap, g)
    for indices, prio in updates:
        sum_tree_update(kern.sum_tree, kern.min_tree, kern.max_priority,
                        indices, prio(kern))
        sum_tree_update_ref(plain.sum_tree, plain.min_tree, plain.max_priority,
                            indices, prio(plain))
        torch.cuda.synchronize()
        for name in ("sum_tree", "min_tree", "max_priority"):
            assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    for b in (512, 37):
        u = torch.rand(b, generator=g, device=dev)
        u[-1] = 1 - 2.0**-24
        got = sum_tree_sample(kern.sum_tree, u)
        assert torch.equal(got, sum_tree_sample_ref(plain.sum_tree, u))
        assert (kern.sum_tree[cap + got] > 0).all()  # never a dead leaf
        if case == "left_half":
            assert (got < cap // 2).all()
    assert sum_tree_update.launches == n0 + sum(
        i.numel() > 0 for i, _ in updates)
    assert sum_tree_sample.launches == s0 + 2


def _adam_param_lists(kind, dev):
    """The optimizers' parameter lists of the benchmark's agents on ``dev``,
    one list an optimizer: DQN's Nature torso and head (1,687,206
    elements), IQN's (2,245,798), and SAC's critics (the stacked ``[2, …]``
    ensemble), actor and one-element log α at 2 × 256."""
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


def _adam_sides(lists, name, dev):
    """Two copies of ``lists``, each parameter with a zero gradient:
    ``"torch"`` under torch's capturable Adam or AdamW, ``"kernel"`` under
    the kernel's; one optimizer a list."""
    from border_tpu_torch.ops.adam import KernelAdam, KernelAdamW

    classes = {"adam": (torch.optim.Adam, KernelAdam),
               "adamw": (torch.optim.AdamW, KernelAdamW)}[name]
    kw = dict(weight_decay=1e-4) if name == "adamw" else {}
    sides = {}
    for side, cls in zip(("torch", "kernel"), classes):
        params = [[p.detach().clone().requires_grad_() for p in ps] for ps in lists]
        for p in (p for ps in params for p in ps):
            p.grad = torch.zeros_like(p)
        sides[side] = (params, [cls(ps, lr=torch.tensor(3e-4, device=dev),
                                    capturable=True, **kw) for ps in params])
    return sides


def _new_grads(sides, g):
    """The same gradients into both sides: scales 1e-9 to 10 (so eps, the
    moments and the bias corrections all show) and about 1 % exact zeros."""
    dev = g.device
    for pt, pk in zip(*([p for ps in sides[s][0] for p in ps] for s in sides)):
        x = torch.randn(pt.shape, generator=g, device=dev) * 10.0 ** torch.randint(
            -9, 2, pt.shape, generator=g, device=dev)
        x[torch.rand(pt.shape, generator=g, device=dev) < 0.01] = 0.0
        pt.grad.copy_(x)
        pk.grad.copy_(x)


def _assert_same_adam(sides, when):
    (params_t, opts_t), (params_k, opts_k) = sides["torch"], sides["kernel"]
    for ps_t, ps_k, ot, ok in zip(params_t, params_k, opts_t, opts_k):
        for i, (pt, pk) in enumerate(zip(ps_t, ps_k)):
            assert torch.equal(pt, pk), f"parameter {i} {when}"
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(ot.state[pt][key], ok.state[pk][key]), (
                    f"{key} of parameter {i} {when}")


@pytest.mark.cuda
@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("kind", ["dqn", "iqn", "sac"])
def test_adam_kernel_is_torchs_capturable_step_bitwise(kind, name, graphed):
    """The kernel's optimizer against torch's capturable Adam / AdamW on the
    same gradients, over the benchmark's agents' parameter lists: p,
    ``exp_avg``, ``exp_avg_sq`` and ``step`` bitwise after the first
    (eager) step and after 100 more, eager or as replays of a captured
    graph of each side's steps, the rate changed through ``set_lr``
    halfway; one launch a list a step."""
    from border_tpu_torch.agents.common import set_lr
    from border_tpu_torch.ops import adam_step

    dev = _cuda()
    lists = _adam_param_lists(kind, dev)
    sides = _adam_sides(lists, name, dev)
    g = torch.Generator(device=dev).manual_seed(7)

    def steps(side):
        for opt in sides[side][1]:
            opt.step()

    n0, c0 = adam_step.launches, adam_step.captured
    _new_grads(sides, g)
    for side in sides:
        steps(side)
    torch.cuda.synchronize()
    _assert_same_adam(sides, "after the first step")
    assert adam_step.launches == n0 + len(lists)
    run = steps
    if graphed:
        graphs = {}
        for side in sides:
            graphs[side] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[side]):
                steps(side)
        run = lambda side: graphs[side].replay()  # noqa: E731
        assert adam_step.captured == c0 + len(lists)
    for i in range(100):
        if i == 50:
            for opt in (o for s in sides.values() for o in s[1]):
                set_lr(opt, 1e-3)
        _new_grads(sides, g)
        for side in sides:
            run(side)
    torch.cuda.synchronize()
    _assert_same_adam(sides, "after 100 more steps")
    assert adam_step.launches == n0 + len(lists) * (1 if graphed else 101)


@pytest.mark.cuda
def test_adam_kernel_state_dict_resume_continues_bitwise():
    """SAC's three optimizers: a ``state_dict`` saved after 5 steps and
    loaded into fresh kernel optimizers (and into torch's capturable Adam)
    over the parameters as they were then: 5 more steps on the same
    gradients end bitwise where the uninterrupted run ends."""
    import copy

    from border_tpu_torch.ops.adam import KernelAdam

    dev = _cuda()
    lists = _adam_param_lists("sac", dev)
    g = torch.Generator(device=dev).manual_seed(11)
    grads = [[[torch.randn(p.shape, generator=g, device=dev) for p in ps]
              for ps in lists] for _ in range(10)]

    def run(cls, params, opts, k):
        for step_grads in grads[k:k + 5]:
            for ps, gs, opt in zip(params, step_grads, opts):
                for p, x in zip(ps, gs):
                    p.grad = x.clone()
                opt.step()

    def fresh(cls, params):
        return [cls(ps, lr=torch.tensor(3e-4, device=dev), capturable=True)
                for ps in params]

    params = [[p.detach().clone().requires_grad_() for p in ps] for ps in lists]
    opts = fresh(KernelAdam, params)
    run(KernelAdam, params, opts, 0)
    saved = [copy.deepcopy(o.state_dict()) for o in opts]
    at5 = [[p.detach().clone() for p in ps] for ps in params]
    run(KernelAdam, params, opts, 5)
    for cls in (KernelAdam, torch.optim.Adam):
        resumed = [[p.clone().requires_grad_() for p in ps] for ps in at5]
        ropts = fresh(cls, resumed)
        for o, sd in zip(ropts, saved):
            o.load_state_dict(copy.deepcopy(sd))
        run(cls, resumed, ropts, 5)
        torch.cuda.synchronize()
        for ps, rs, o, ro in zip(params, resumed, opts, ropts):
            for p, r in zip(ps, rs):
                assert torch.equal(p, r), cls.__name__
                for key in ("step", "exp_avg", "exp_avg_sq"):
                    assert torch.equal(o.state[p][key], ro.state[r][key]), key


@pytest.mark.cuda
def test_adam_kernel_optimizer_deep_copy_steps_on_its_own():
    """A deep copy of parameters and kernel optimizer together (as a copy
    of an agent's state makes it) gets its own done-counter and steps on
    bitwise beside the original on the same gradients."""
    import copy

    from border_tpu_torch.ops.adam import KernelAdamW

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(17)
    params = [p.detach().clone().requires_grad_()
              for p in _adam_param_lists("sac", dev)[0]]
    opt = KernelAdamW(params, lr=torch.tensor(3e-4, device=dev),
                      weight_decay=1e-4, capturable=True)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=dev)
    opt.step()
    params2, opt2 = copy.deepcopy((params, opt))
    assert opt2._done[0].data_ptr() != opt._done[0].data_ptr()
    for _ in range(5):
        for p, q in zip(params, params2):
            p.grad = torch.randn(p.shape, generator=g, device=dev)
            q.grad = p.grad.clone()
        opt.step()
        opt2.step()
    torch.cuda.synchronize()
    for p, q in zip(params, params2):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt2.state[q][key]), key


@pytest.mark.cuda
def test_adam_kernel_long_lists_odd_sizes_and_unaligned_tensors():
    """130 tensors (three launches a step), of 0 to 1,027 elements, half of
    them views 4 bytes past an allocation's start (no 16-byte vectors): three
    AdamW steps of ``adam_step`` bitwise torch's capturable AdamW."""
    from border_tpu_torch.ops import adam_step
    from border_tpu_torch.ops.adam import scratch

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    sizes = [int(n) for n in torch.randint(0, 1028, (130,), generator=g, device=dev)]
    sizes[:3] = [0, 1, 4]
    flat = torch.randn(sum(sizes) + 130, generator=g, device=dev)
    sides = []
    for _ in range(2):
        params, offset = [], 1
        for i, n in enumerate(sizes):
            if i % 2:
                params.append(flat[offset:offset + n].clone())
            else:  # a view at an odd offset
                params.append(torch.empty(n + 1, device=dev)[1:].copy_(
                    flat[offset:offset + n]))
            offset += n + 1
        sides.append(params)
    kern, plain = sides
    m = [torch.zeros_like(p) for p in kern]
    v = [torch.zeros_like(p) for p in kern]
    t = [torch.zeros((), device=dev) for _ in kern]
    lr = torch.tensor(1e-3, device=dev)
    done = scratch(dev)
    ref = torch.optim.AdamW(plain, lr=lr.clone(), weight_decay=1e-4,
                            capturable=True, foreach=True)
    n0 = adam_step.launches
    for _ in range(3):
        grads = [torch.randn(n, generator=g, device=dev) for n in sizes]
        adam_step(kern, grads, m, v, t, lr=lr, done=done, weight_decay=1e-4,
                  decoupled=True)
        for p, x in zip(plain, grads):
            p.grad = x.clone()
        ref.step()
    torch.cuda.synchronize()
    for i, p in enumerate(plain):
        state = ref.state[p]
        assert torch.equal(kern[i], p), i
        assert torch.equal(m[i], state["exp_avg"]), i
        assert torch.equal(v[i], state["exp_avg_sq"]), i
        assert torch.equal(t[i], state["step"]), i
    assert adam_step.launches == n0 + 3 * 3


@pytest.mark.cuda
def test_adam_kernel_steps_on_two_streams_at_once():
    """Two kernel optimizers stepping on two streams with nothing ordering
    their launches (DQN's parameters, so that a launch spans the card, and
    SAC's critics): each group has its own done-counter, so after 20 steps
    each side is bitwise torch's capturable Adam run alone."""
    from border_tpu_torch.ops.adam import KernelAdam

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(13)
    lists = _adam_param_lists("dqn", dev) + _adam_param_lists("sac", dev)[:1]
    sides = {}
    for cls in (KernelAdam, torch.optim.Adam):
        params = [[p.detach().clone().requires_grad_() for p in ps] for ps in lists]
        sides[cls] = (params, [cls(ps, lr=torch.tensor(3e-4, device=dev),
                                   capturable=True) for ps in params])
    for ps_k, ps_t in zip(sides[KernelAdam][0], sides[torch.optim.Adam][0]):
        for pk, pt in zip(ps_k, ps_t):
            x = torch.randn(pk.shape, generator=g, device=dev)
            pk.grad, pt.grad = x, x.clone()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in lists]
    for _ in range(20):
        for stream, opt in zip(streams, sides[KernelAdam][1]):
            with torch.cuda.stream(stream):
                opt.step()
    for _ in range(20):
        for opt in sides[torch.optim.Adam][1]:
            opt.step()
    torch.cuda.synchronize()
    (params_k, opts_k), (params_t, opts_t) = sides.values()
    for ps_k, ps_t, ok, ot in zip(params_k, params_t, opts_k, opts_t):
        for pk, pt in zip(ps_k, ps_t):
            assert torch.equal(pk, pt)
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(ok.state[pk][key], ot.state[pt][key]), key


@pytest.mark.cuda
def test_adam_kernel_refuses_what_it_does_not_take():
    """The optimizer and the wrapper raise, on the card, on every input the
    kernel does not take; nothing falls back to torch's step.  A refused
    group added later leaves the optimizer as it was."""
    from border_tpu_torch.ops import adam_step
    from border_tpu_torch.ops.adam import KernelAdam, KernelAdamW, scratch

    dev = _cuda()
    lr = torch.tensor(1e-3, device=dev)

    def param(**kw):
        p = torch.zeros(8, device=dev, **kw).requires_grad_()
        p.grad = torch.ones_like(p)
        return p

    for kw, match in ((dict(amsgrad=True), "amsgrad"),
                      (dict(maximize=True), "maximize"),
                      (dict(weight_decay=1e-2), "decoupled"),
                      (dict(capturable=False), "capturable")):
        with pytest.raises(ValueError, match=match):
            KernelAdam([param()], **{"lr": lr, "capturable": True, **kw})
    with pytest.raises(ValueError, match="rate"):
        KernelAdamW([param()], lr=1e-3, capturable=True)
    with pytest.raises(TypeError, match="float32"):
        KernelAdam([param(dtype=torch.bfloat16)], lr=lr, capturable=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        KernelAdam([param(), torch.zeros(8, requires_grad=True)], lr=lr,
                   capturable=True)
    opt = KernelAdam([param()], lr=lr, capturable=True)
    with pytest.raises(TypeError, match="float32"):
        opt.add_param_group({"params": [param(dtype=torch.float16)]})
    assert len(opt.param_groups) == 1
    opt.step()
    opt.param_groups[0]["amsgrad"] = True
    with pytest.raises(ValueError, match="amsgrad"):
        opt.step()

    def tensors(n=8, device=dev):
        return [torch.zeros(n, device=device)]

    one = [torch.zeros((), device=dev)]
    done = scratch(dev)
    with pytest.raises(ValueError, match="on cpu"):
        adam_step(tensors(), tensors(device="cpu"), tensors(), tensors(), one,
                  lr=lr, done=done)
    with pytest.raises(ValueError, match="contiguous"):
        adam_step([torch.zeros(8, 2, device=dev).t()],
                  [torch.zeros(2, 8, device=dev)] * 1, [torch.zeros(2, 8, device=dev)],
                  [torch.zeros(2, 8, device=dev)], one, lr=lr, done=done)
    with pytest.raises(ValueError, match="rate"):
        adam_step(tensors(), tensors(), tensors(), tensors(), one, lr=lr.cpu(),
                  done=done)
    with pytest.raises(ValueError, match="done-counter"):
        adam_step(tensors(), tensors(), tensors(), tensors(), one, lr=lr,
                  done=torch.zeros((), device=dev))
    with pytest.raises(ValueError, match="parameter"):
        adam_step(tensors(), tensors(7), tensors(), tensors(), one, lr=lr,
                  done=done)


@pytest.mark.cuda
@pytest.mark.parametrize("mode, per_sample", [
    (dict(sample_mode="union"), 1), (dict(sample_mode="separate"), 2),
    (dict(sample_mode="slice", slice_group=4), 1), (dict(n_step=3), 2)])
def test_every_mode_reads_through_the_kernel_and_matches_cpu_path(mode, per_sample):
    import types

    from border_tpu_torch.replay import FrameReplayBuffer

    dev = _cuda()
    n, cap = 8, 32
    bufs = {d: FrameReplayBuffer(cap, n, device=d, **mode) for d in ("cpu", dev)}
    states = {d: b.init() for d, b in bufs.items()}
    g = torch.Generator().manual_seed(0)
    ep = torch.zeros(n, dtype=torch.int32)
    for _ in range(cap + 5):
        obs = torch.randint(0, 256, (n, 84, 84, 4), generator=g, dtype=torch.uint8)
        term = torch.rand(n, generator=g) < 0.2
        for d, b in bufs.items():
            ts = types.SimpleNamespace(
                reward=torch.ones(n, device=d), terminated=term.to(d),
                truncated=torch.zeros(n, dtype=torch.bool, device=d))
            states[d] = b.process_step(states[d], obs.to(d),
                                       torch.zeros(n, dtype=torch.int32, device=d),
                                       ts, ep.to(d))
        ep = torch.where(term, 0, ep + 1).to(torch.int32)
    e, s = bufs["cpu"].draw(states["cpu"], g, 64)
    launches = frame_gather.gather_frames.launches
    got = bufs[dev].sample_at(states[dev], e.to(dev), s.to(dev))
    torch.cuda.synchronize()
    assert frame_gather.gather_frames.launches == launches + per_sample
    want = bufs["cpu"].sample_at(states["cpu"], e, s)
    for name in ("obs", "next_obs", "terminated", "reward", "ix_sample"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_per_train_checkpoint_resume_on_card(tmp_path):
    """A small prioritized run on the card, checkpointed every chunk, and a
    second trainer resumed from the first checkpoint: bitwise the same
    parameters, tree and ring; one gather launch per update, and one
    descent and one tree-update launch an update plus one tree update a
    push."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.ops import sum_tree_sample, sum_tree_update
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig
    from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
    from border_tpu_torch.utils import CheckpointManager

    _cuda()
    upc = 8

    def trainer(max_opts, manager=None):
        return Trainer(
            make("Pong-v0"),
            DQN(DQNConfig(model=AtariCNN, lr=1e-4, double_dqn=True)),
            FrameReplayBuffer(32, 16, per=PerConfig(n_opts_final=32)),
            TrainerConfig(num_envs=16, steps_per_chunk=8, batch_size=32,
                          opt_interval=16, warmup_period=0, max_opts=max_opts,
                          eval_interval=upc),
            evaluator=Evaluator(make("Pong-v0", train=False), 2, 8),
            checkpoint_manager=manager,
            checkpoint_interval=upc if manager else 0)

    launches = frame_gather.gather_frames.launches
    tree_launches = sum_tree_update.launches, sum_tree_sample.launches
    want = trainer(3 * upc).train()
    torch.cuda.synchronize()
    assert frame_gather.gather_frames.launches == launches + 3 * upc
    # the graphed chunks: a descent and a priority write an update, a tree
    # update a push (an env step), each one launch
    assert sum_tree_sample.launches == tree_launches[1] + 3 * upc
    assert sum_tree_update.launches == (tree_launches[0] + 3 * upc
                                        + want.buffer_state.total)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    trainer(upc, mgr).train()
    assert mgr.all_steps() == [upc]
    got = trainer(3 * upc).train(resume_from=mgr)
    assert got.opt_steps == want.opt_steps == 3 * upc
    for a, b in zip(got.agent_state.params.parameters(),
                    want.agent_state.params.parameters()):
        assert torch.equal(a, b)
    for name in ("sum_tree", "min_tree", "max_priority"):
        assert torch.equal(getattr(got.buffer_state.tree, name),
                           getattr(want.buffer_state.tree, name)), name
    assert torch.equal(got.buffer_state.frames, want.buffer_state.frames)
    assert got.buffer_state.total == want.buffer_state.total
    assert got.eval_history == want.eval_history[1:]


def _to(x, device):
    """A dataclass of tensors (nested) copied to ``device``."""
    import dataclasses

    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), device)
                          for f in dataclasses.fields(x)})
    return x.to(device) if torch.is_tensor(x) else x


def _assert_close_state(got, want):
    import dataclasses

    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name).cpu(), getattr(want, f.name)
        if w.dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6, msg=f.name)
        else:
            assert torch.equal(g, w), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("env_id, n_draws", [
    ("Breakout-v0", 1), ("Seaquest-v0", 6), ("Freeway-v0", 0),
    ("SpaceInvaders-v0", 3)])
def test_game_frames_on_card_match_cpu_path(env_id, n_draws):
    """40 frames of each new game on the card against the CPU path, from the
    same state with the same actions and draws: integer and boolean fields
    and the rendered frames bitwise, floats to 1e-6."""
    _cuda()
    from border_tpu_torch.envs import make

    game = make(env_id).game
    n = 64
    rng = torch.Generator().manual_seed(0)
    sc = game.init(rng, n, torch.device("cpu"))
    sg = _to(sc, "cuda")
    for t in range(40):
        a = torch.randint(0, game.num_actions, (n,), generator=rng,
                          dtype=torch.int32)
        u = torch.rand((n, n_draws), generator=rng)
        sc, rc, dc = game.frame_step(None, sc, a, u=u)
        sg2, rg, dg = game.frame_step(None, sg, a.cuda(), u=u.cuda())
        _assert_close_state(sg2, sc)
        assert torch.equal(rg.cpu(), rc) and torch.equal(dg.cpu(), dc)
        # continue from the CPU state, so a 1e-6 difference cannot grow
        sg = _to(sc, "cuda")
        assert torch.equal(game.render(sg).cpu(), game.render(sc)), t
    assert (game.render(sc) > 0).any()


@pytest.mark.cuda
def test_pixel_grid_and_scalar_divisions_on_card_are_true_divisions():
    """On a CUDA tensor ``x / 83`` multiplies by the reciprocal; the games
    divide through ``pixel_grid`` and ``true_div``, which agree bitwise with
    the CPU's (and the JAX package's) division."""
    _cuda()
    from border_tpu_torch.envs.pixel import pixel_grid, true_div

    for denom in (83, 84):
        for g, c in zip(pixel_grid(torch.device("cuda"), denom),
                        pixel_grid(torch.device("cpu"), denom)):
            assert torch.equal(g.cpu(), c)
    x = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    for c in (0.03, 0.055, 0.58 / 6, 35.0):
        assert torch.equal(true_div(x.cuda(), c).cpu(), true_div(x, c)), c
        assert torch.equal(true_div(x, c), x / c)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "nstep", "per"])
def test_flat_buffer_sample_on_card_matches_cpu_path(kind):
    """The flat buffer on the card against the CPU path: the same pushes and
    the same injected draws give the same batch."""
    _cuda()
    from border_tpu_torch.replay import PerConfig, ReplayBuffer, Transition

    kw = {"uniform": {}, "nstep": dict(n_step=3, stride=8),
          "per": dict(per=PerConfig(n_opts_final=100))}[kind]
    bufs = {d: ReplayBuffer(256, device=d, **kw) for d in ("cpu", "cuda")}
    g = torch.Generator().manual_seed(1)
    z = torch.zeros(4)
    flag = torch.zeros((), dtype=torch.bool)
    example = Transition(z, torch.zeros((), dtype=torch.int32), z,
                         torch.zeros(()), flag, flag)
    states = {d: b.init(_to(example, d)) for d, b in bufs.items()}
    for _ in range(40):  # 320 transitions: the ring wraps
        batch = Transition(
            obs=torch.rand((8, 4), generator=g),
            act=torch.randint(0, 3, (8,), generator=g, dtype=torch.int32),
            next_obs=torch.rand((8, 4), generator=g),
            reward=torch.rand((8,), generator=g),
            terminated=torch.rand((8,), generator=g) < 0.1,
            truncated=torch.rand((8,), generator=g) < 0.05)
        for d, b in bufs.items():
            b.push(states[d], _to(batch, d))
    out = {}
    for d, b in bufs.items():
        if kind == "per":
            td = torch.linspace(0.01, 3, 32)
            b.update_priority(states[d], torch.arange(32).to(d), td.to(d))
            u = torch.rand(64, generator=torch.Generator().manual_seed(2))
            out[d] = b.sample_at(states[d], *b.draw_per(
                states[d], None, 64, n_opts=50, u=u.to(d)))
        else:
            lo, hi = (16, 256) if kind == "nstep" else (0, 256)
            raw = torch.randint(lo, hi, (64,),
                                generator=torch.Generator().manual_seed(2))
            out[d] = b.sample_at(states[d], b.draw(states[d], None, 64,
                                                   raw=raw.to(d)))
    torch.cuda.synchronize()
    got, want = out["cuda"], out["cpu"]
    for name in ("obs", "act", "next_obs", "terminated", "truncated", "ix_sample"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.reward.cpu(), want.reward, rtol=1e-6, atol=1e-7)
    if kind == "nstep":
        torch.testing.assert_close(got.discount.cpu(), want.discount, rtol=1e-6,
                                   atol=0)
    if kind == "per":
        torch.testing.assert_close(got.weight.cpu(), want.weight, rtol=1e-5,
                                   atol=0)
    assert states["cuda"].cursor == states["cpu"].cursor == 320 % 256


@pytest.mark.cuda
@pytest.mark.parametrize("psi", ["mlp", "cnn"])
def test_iqn_update_on_card_matches_cpu_path(psi):
    """One float32 IQN update with the same τ on the card (no TF32) and on
    the CPU: loss and td errors to rtol 1e-4."""
    _cuda()
    import functools

    from border_tpu_torch.agents import IQN, IQNConfig
    from border_tpu_torch.core import spaces
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import TransitionBatch

    b, n_act = 16, 6
    g = torch.Generator().manual_seed(3)
    if psi == "cnn":
        cfg = IQNConfig(psi_fn=functools.partial(
            AtariCNN, out_dim=0, skip_linear=True, dtype=torch.float32),
            feature_dim=32, n_cos=16, hidden=(32,), lr=1e-4)
        space = spaces.Box(0, 255, (84, 84, 4), torch.uint8)
        obs = lambda: torch.randint(0, 256, (b, 84, 84, 4), generator=g,  # noqa: E731
                                    dtype=torch.uint8)
    else:
        cfg = IQNConfig(feature_dim=32, n_cos=16, hidden=(32,))
        space = spaces.Box(-1.0, 1.0, (4,), torch.float32)
        obs = lambda: torch.rand((b, 4), generator=g)  # noqa: E731
    agent = IQN(cfg)
    batch = dict(obs=obs(), act=torch.randint(0, n_act, (b,), generator=g,
                                              dtype=torch.int32),
                 next_obs=obs(), reward=torch.randn((b,), generator=g),
                 terminated=torch.rand((b,), generator=g) < 0.25,
                 truncated=torch.zeros(b, dtype=torch.bool))
    taus = (torch.rand((b, 8), generator=g), torch.rand((b, 8), generator=g),
            ((torch.arange(32.0) + 0.5) / 32).expand(b, 32))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for d in ("cpu", "cuda"):
            st = agent.init(0, space, spaces.Discrete(n_act), device=d)
            _, m, td = agent.update(
                st, TransitionBatch(**{k: v.to(d) for k, v in batch.items()}),
                taus=tuple(t.to(d) for t in taus))
            res[d] = (m["loss"].item(), td.cpu(), st)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-4)
    torch.testing.assert_close(res["cuda"][1], res["cpu"][1], rtol=1e-4, atol=1e-5)
    assert res["cuda"][2].n_opts == 1
    assert next(res["cuda"][2].params.parameters()).is_cuda


@pytest.mark.cuda
def test_classic_control_on_card_matches_cpu_path():
    """20 steps of every classic-control env on the card against the CPU
    path from the same state and actions: rtol 1e-5 (sin and cos differ in
    the last place between the two)."""
    _cuda()
    from border_tpu_torch.envs import make

    for env_id in ("CartPole-v1", "Pendulum-v1", "MountainCar-v0",
                   "MountainCarContinuous-v0", "Acrobot-v1"):
        env = make(env_id)
        p = env.default_params
        g = torch.Generator().manual_seed(4)
        _, sc = env.reset_env(g, 128, p, torch.device("cpu"))
        space = env.action_space(p)
        for _ in range(20):
            a = (torch.randint(0, space.n, (128,), generator=g, dtype=torch.int32)
                 if hasattr(space, "n") else torch.rand((128, 1), generator=g) * 2 - 1)
            oc, sc2, rc, tc, uc, _ = env.step_env(None, sc, a, p)
            og, _, rg, tg, ug, _ = env.step_env(None, _to(sc, "cuda"), a.cuda(), p)
            torch.testing.assert_close(og.cpu(), oc, rtol=1e-5, atol=1e-5, msg=env_id)
            torch.testing.assert_close(rg.cpu(), rc, rtol=1e-5, atol=1e-5, msg=env_id)
            assert torch.equal(ug.cpu(), uc), env_id
            sc = sc2


@pytest.mark.cuda
def test_reset_with_index_on_card_is_the_cpu_reset_bitwise():
    """Every registered env id at three indices: the card's per-index reset
    (obs and state) is the CPU's, bitwise, and its in-episode generator is
    a card generator seeded with the index's seed (re-seeded in place when
    given)."""
    dev = _cuda()
    from border_tpu_torch.core.env import VecEnv, index_seed
    from border_tpu_torch.envs import make, registry
    from border_tpu_torch.train.graphs import _leaves

    for env_id in sorted(registry):
        cpu, card = VecEnv(make(env_id), 5, device="cpu"), VecEnv(make(env_id), 5, device=dev)
        held = torch.Generator(device=dev)
        for index in (0, 1, 10_007):
            a, b = cpu.reset_with_index(3, index), card.reset_with_index(3, index, gen=held)
            for (k, x), (_, y) in zip(_leaves({"obs": a.obs, "state": a.env_state}),
                                      _leaves({"obs": b.obs, "state": b.env_state}),
                                      strict=True):
                assert y.is_cuda and torch.equal(x, y.cpu()), (env_id, index, k)
            assert b.gen is held and torch.equal(
                held.get_state(),
                torch.Generator(device=dev).manual_seed(index_seed(3, index)).get_state())


@pytest.mark.cuda
def test_reacher_on_card_matches_cpu_path():
    """45 Reacher steps (short of the 50-step episode end) on the card
    against the CPU path from the same state and actions: observations and
    rewards to 1e-6."""
    _cuda()
    from border_tpu_torch.envs import make

    env = make("Reacher-v0")
    p = env.default_params
    g = torch.Generator().manual_seed(5)
    _, sc = env.reset_env(g, 256, p, torch.device("cpu"))
    sg = _to(sc, "cuda")
    for _ in range(45):
        a = torch.rand((256, 2), generator=g) * 2.4 - 1.2
        oc, sc, rc, tc, uc, _ = env.step_env(None, sc, a, p)
        og, sg, rg, tg, ug, _ = env.step_env(None, sg, a.cuda(), p)
        for k in oc:
            torch.testing.assert_close(og[k].cpu(), oc[k], rtol=1e-6, atol=1e-6, msg=k)
        torch.testing.assert_close(rg.cpu(), rc, rtol=1e-6, atol=1e-6)
        assert torch.equal(ug.cpu(), uc) and torch.equal(tg.cpu(), tc)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sac", "awac", "awac_softmax", "iql"])
def test_actor_critic_update_on_card_matches_cpu_path(name):
    """One float32 SAC, AWAC or IQL update with the same injected normal
    draws on the card (no TF32) and on the CPU: every metric and the td
    errors to rtol 1e-4, and the networks stay on the card."""
    _cuda()
    from border_tpu_torch.agents import AWAC, IQL, SAC, AWACConfig, IQLConfig, SACConfig
    from border_tpu_torch.core import spaces
    from border_tpu_torch.replay import TransitionBatch

    b, od, ad = 64, 8, 2
    agent, draws = {
        "sac": (SAC(SACConfig(actor_hidden=(64, 64), critic_hidden=(64, 64))), True),
        "awac": (AWAC(AWACConfig(actor_hidden=(64, 64), critic_hidden=(64, 64),
                                 lambda_=10.0)), True),
        "awac_softmax": (AWAC(AWACConfig(actor_hidden=(64,), critic_hidden=(64,),
                                         weight_mode="softmax")), True),
        "iql": (IQL(IQLConfig(actor_hidden=(64,), critic_hidden=(64,),
                              value_hidden=(64,))), False)}[name]
    obs_space = spaces.Box(-float("inf"), float("inf"), (od,), torch.float32)
    act_space = spaces.Box(-1.0, 1.0, (ad,), torch.float32)
    g = torch.Generator().manual_seed(6)
    batch = dict(obs=torch.randn((b, od), generator=g),
                 act=torch.rand((b, ad), generator=g) * 2 - 1,
                 next_obs=torch.randn((b, od), generator=g),
                 reward=torch.randn(b, generator=g),
                 terminated=torch.rand(b, generator=g) < 0.1,
                 truncated=torch.zeros(b, dtype=torch.bool))
    noise = tuple(torch.randn((b, ad), generator=g) for _ in range(2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for d in ("cpu", "cuda"):
            st = agent.init(0, obs_space, act_space, device=d)
            kw = {"noise": tuple(z.to(d) for z in noise)} if draws else {}
            st, m, td = agent.update(
                st, TransitionBatch(**{k: v.to(d) for k, v in batch.items()}), **kw)
            res[d] = ({k: v.item() for k, v in m.items()}, td.cpu(), st)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, v in res["cpu"][0].items():
        assert res["cuda"][0][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    torch.testing.assert_close(res["cuda"][1], res["cpu"][1], rtol=1e-4, atol=1e-5)
    st = res["cuda"][2]
    assert st.n_opts == 1 and next(st.critic_params.parameters()).is_cuda


@pytest.mark.cuda
def test_host_pong_device_ring_equals_the_host_obs_on_card():
    """HostEnvTrainer on the card over 8 C++ Pong envs: frame-only uploads
    and the device stack ring give the host's observation bitwise at every
    step (Pong has no lives), and the ring holds the frames pushed."""
    import numpy as np

    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs.native import NativeVecEnv
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import HostEnvTrainer, TrainerConfig

    _cuda()
    n = 8

    class Recording(NativeVecEnv):
        def reset(self):
            self.log = [super().reset()]
            return self.log[0]

        def step_final(self, actions):
            out = super().step_final(actions)
            self.log.append(out[0])
            return out

    env = Recording("Pong-v0", n, seed=1)
    agent = DQN(DQNConfig(model=lambda a: AtariCNN(a), lr=1e-4))
    cfg = TrainerConfig(max_opts=2, warmup_period=35 * n, opt_interval=n // 2,
                        batch_size=8, num_envs=n, steps_per_chunk=8, seed=0)
    # eager: the wrapped select reads each obs to the host, which a graph
    # cannot capture (the graphed twin is held to this one bitwise below)
    tr = HostEnvTrainer(env, agent, FrameReplayBuffer(64, n), cfg,
                        cuda_graphs=False)
    seen = []
    select = tr._select
    tr._select = lambda a, obs, g: (seen.append(obs.cpu()), select(a, obs, g))[1]
    launches = frame_gather.gather_frames.launches
    r = tr.train()
    torch.cuda.synchronize()
    assert r.opt_steps == 2 and frame_gather.gather_frames.launches == launches + 2
    assert r.buffer_state.frames.is_cuda and len(seen) == r.buffer_state.total + 1
    for i, obs in enumerate(seen):
        np.testing.assert_array_equal(obs.numpy(), env.log[i], err_msg=f"step {i}")
    # the ring's newest slot holds the newest pushed frame of every env
    p = (r.buffer_state.total - 1) % 64
    assert torch.equal(r.buffer_state.frames[:, p].cpu(), seen[-2][..., -1])


@pytest.mark.cuda
def test_async_trainer_actor_keeps_its_snapshot_on_card():
    """AsyncTrainer on the card with a sync interval no run reaches: every
    action is the initial parameters' greedy action while the learner's
    parameters move."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import AsyncTrainer, TrainerConfig

    _cuda()
    agent = DQN(DQNConfig(hidden=(16,), eps_start=0.0, eps_final=0.0))
    cfg = TrainerConfig(max_opts=24, warmup_period=64, opt_interval=16,
                        batch_size=16, num_envs=8, steps_per_chunk=8, seed=3,
                        sync_interval=10**9)
    # eager: the wrapped select records every step's state on the host
    tr = AsyncTrainer(make("CartPole-v1"), agent, ReplayBuffer(512), cfg,
                      cuda_graphs=False)
    initial = agent.init(3, tr.vec.observation_space, tr.vec.action_space).params
    acted = []
    select = agent.select_action
    agent.select_action = lambda state, obs, gen: (
        acted.append((state.params, obs.clone())), select(state, obs, gen))[1]
    r = tr.train()
    torch.cuda.synchronize()
    learner = r.agent_state.params
    assert len(acted) == 7 * 8 and next(learner.parameters()).is_cuda
    assert not all(torch.equal(p, q) for p, q in
                   zip(learner.parameters(), initial.parameters()))
    for module, obs in acted:
        assert module is tr._actor_params and module is not learner
        assert all(torch.equal(p, q) for p, q in
                   zip(module.parameters(), initial.parameters()))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [96, 100])
def test_flat_per_draws_at_batch_not_a_power_of_two_match_cpu_path(batch):
    """The sum tree's strata at a batch size that is not a power of two:
    the same priorities and the same injected uniforms give the same leaves
    and weights on the card as on the CPU (the stratum width is divided by
    a tensor, not multiplied by a Python number's reciprocal)."""
    _cuda()
    from border_tpu_torch.replay import PerConfig, ReplayBuffer, Transition

    bufs = {d: ReplayBuffer(1024, device=d, per=PerConfig(n_opts_final=100))
            for d in ("cpu", "cuda")}
    g = torch.Generator().manual_seed(3)
    z = torch.zeros(2)
    flag = torch.zeros((), dtype=torch.bool)
    example = Transition(z, torch.zeros((), dtype=torch.int32), z,
                         torch.zeros(()), flag, flag)
    states = {d: b.init(_to(example, d)) for d, b in bufs.items()}
    push = Transition(
        obs=torch.rand((1000, 2), generator=g),
        act=torch.zeros((1000,), dtype=torch.int32),
        next_obs=torch.rand((1000, 2), generator=g),
        reward=torch.rand((1000,), generator=g),
        terminated=torch.zeros((1000,), dtype=torch.bool),
        truncated=torch.zeros((1000,), dtype=torch.bool))
    # |td| over nine decades: leaves from ~1e-4 to ~6e1 wide
    td = 10.0 ** (torch.rand(1000, generator=g) * 9 - 6)
    for d, b in bufs.items():
        b.push(states[d], _to(push, d))
        b.update_priority(states[d], torch.arange(1000).to(d), td.to(d))
    for _ in range(64):
        u = torch.rand(batch, generator=g)
        got = bufs["cuda"].draw_per(states["cuda"], None, batch, n_opts=50,
                                    u=u.cuda())
        want = bufs["cpu"].draw_per(states["cpu"], None, batch, n_opts=50, u=u)
        assert torch.equal(got[0].cpu(), want[0])
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)


# -- CUDA graphs: the graphed chunk against the eager one --------------------

def _leaves_of(*states):
    """(path, leaf) pairs of states packed as a checkpoint packs them."""
    from border_tpu_torch.utils.checkpoint import pack_state

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from walk(v, f"{path}/{k}")
        else:
            yield path, x

    for i, s in enumerate(states):
        yield from walk(pack_state(s), str(i))


def _assert_bitwise(got, want):
    got, want = dict(_leaves_of(*got)), dict(_leaves_of(*want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if torch.is_tensor(w):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k


def _graphed_vs_eager(make_trainer, update_chunks=3, warm_chunks=1):
    """The same states and generator states through ``update_chunks``
    graphed chunks and as many eager ones (``cuda_graphs=False``): agent
    state (parameters, targets, optimizer moments and steps, counters),
    replay state, env state, both generators and every chunk's metrics
    equal bitwise, and so do the gather's launches and the torso's forwards
    counted.  Returns the graphed trainer, its final agent state, its gather
    launches and its torso forwards."""
    out = {}
    for graphs in (True, False):
        tr = make_trainer(graphs)
        assert tr.cuda_graphs is graphs
        ag, vec, buf = tr.init_states(0, 1)
        gen = tr._loop_generator(0)
        launches = frame_gather.gather_frames.launches
        torso = space_to_depth.launches
        for _ in range(warm_chunks):
            ag, vec, buf, _, _, _ = tr._chunk(ag, vec, buf, gen, False)
        chunks = []
        for _ in range(update_chunks):
            ag, vec, buf, metrics, ret, cnt = tr._chunk(ag, vec, buf, gen, True)
            chunks.append({**metrics, "ret": ret, "cnt": cnt})
        torch.cuda.synchronize()
        out[graphs] = (ag, vec, buf, gen, chunks,
                       frame_gather.gather_frames.launches - launches, tr,
                       space_to_depth.launches - torso)
    g, e = out[True], out[False]
    _assert_bitwise(g[:4], e[:4])
    for cg, ce in zip(g[4], e[4]):
        assert cg.keys() == ce.keys()
        for k in ce:
            assert torch.equal(cg[k], ce[k]), k
    assert g[5] == e[5]  # the gather's launches, counted per replay
    assert g[7] == e[7]  # the torso's forwards, counted per replay
    assert g[6]._graphs and all(loop.graph is not None
                                for loop in g[6]._graphs.values())
    return g[6], g[0], g[5], g[7]


def _pong_trainer(buffer_kw=None, agent=None, **cfg):
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    def build(graphs):
        # a hard target sync every 20 updates, ε and the rate decaying
        # within the run
        ag = agent() if agent else DQN(DQNConfig(
            model=lambda n: AtariCNN(n), lr=1e-3, lr_decay_steps=64,
            double_dqn=True, soft_update_interval=20, tau=1.0,
            eps_final_step=2_000))
        return Trainer(make("Pong-v0"), ag,
                       FrameReplayBuffer(64, 64, **(buffer_kw or {})),
                       TrainerConfig(**{**dict(
                           num_envs=64, steps_per_chunk=8, batch_size=32,
                           opt_interval=16, warmup_period=0), **cfg}),
                       cuda_graphs=graphs)
    return build


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sequential", "prefetch", "sample_batches"])
def test_graphed_uniform_pong_chunk_equals_eager_chunk_bitwise(order):
    """Uniform DQN on Pong (bf16 AtariCNN, union sampling through the
    gather kernel): three graphed chunks of 32 updates, crossing target
    syncs, ε and learning-rate decay, equal three eager ones bitwise; the
    gather's launches count one per update under replay too."""
    _cuda()
    cfg = {"sequential": {}, "prefetch": dict(prefetch_sample=True),
           "sample_batches": dict(updates_per_sample_batch=4)}[order]
    tr, ag, launches, torso = _graphed_vs_eager(_pong_trainer(**cfg))
    m = tr.updates_per_chunk
    # one gather a sample: M+1 samples a chunk when prefetching, M/4 of
    # four batches each in the sample-batch order
    samples = {"sequential": m, "prefetch": m + 1, "sample_batches": m // 4}
    assert ag.n_opts == 3 * m and launches == 3 * samples[order]
    assert int(ag.counts[0]) == ag.n_opts and ag.n_samples == 4 * 8 * 64
    # torso forwards in the space-to-depth layout: one an env step's act,
    # three a double-DQN update (target, online on next_obs and on obs),
    # the replayed ones added by every replay
    assert torso == 4 * 8 + 3 * ag.n_opts


@pytest.mark.cuda
def test_graphed_per_pong_chunk_equals_eager_chunk_bitwise():
    """PER on Pong (the sum tree's residency pushes, β annealing, priority
    write-back): graphed chunks equal eager ones bitwise."""
    from border_tpu_torch.replay import PerConfig

    _cuda()
    tr, ag, launches, _ = _graphed_vs_eager(
        _pong_trainer(dict(per=PerConfig(n_opts_final=64))))
    assert launches == ag.n_opts == 3 * tr.updates_per_chunk


@pytest.mark.cuda
def test_graphed_iqn_seaquest_chunk_equals_eager_chunk_bitwise():
    """IQN on Seaquest (the CNN's features, three τ draws an update)."""
    import functools

    from border_tpu_torch.agents import IQN, IQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    _cuda()

    def build(graphs):
        agent = IQN(IQNConfig(
            psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True),
            feature_dim=512, n_cos=64, hidden=(512,),
            sample_percents_pred="uniform8", sample_percents_tgt="uniform8",
            sample_percents_act="const32", lr=1e-4,
            soft_update_interval=20, tau=1.0, eps_final_step=2_000))
        return Trainer(make("Seaquest-v0"), agent, FrameReplayBuffer(64, 64),
                       TrainerConfig(num_envs=64, steps_per_chunk=8,
                                     batch_size=32, opt_interval=16,
                                     warmup_period=0), cuda_graphs=graphs)

    _graphed_vs_eager(build)


@pytest.mark.cuda
@pytest.mark.parametrize("n_step", [1, 3])
def test_graphed_flat_buffer_cartpole_chunk_equals_eager_chunk_bitwise(n_step):
    """DQN-MLP on CartPole through the flat ring (the device cursor and
    size, the ring wrapping within the run; n-step 3 too)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    _cuda()

    def build(graphs):
        agent = DQN(DQNConfig(hidden=(64, 64), lr=1e-3, lr_decay_steps=100,
                              soft_update_interval=10, tau=1.0,
                              eps_final_step=3_000))
        return Trainer(make("CartPole-v1"), agent,
                       ReplayBuffer(2048, n_step=n_step, stride=128),
                       TrainerConfig(num_envs=128, steps_per_chunk=8,
                                     batch_size=64, opt_interval=32,
                                     warmup_period=0), cuda_graphs=graphs)

    tr, ag, _, _ = _graphed_vs_eager(build, update_chunks=3)
    assert ag.n_samples == 4 * 8 * 128


@pytest.mark.cuda
def test_graphed_sac_pendulum_chunk_equals_eager_chunk_bitwise():
    """SAC on Pendulum: three optimizers (auto entropy coefficient), polyak
    targets, two normal draws an update."""
    from border_tpu_torch.agents import SAC, SACConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Trainer, TrainerConfig

    _cuda()

    def build(graphs):
        return Trainer(make("Pendulum-v1"),
                       SAC(SACConfig(actor_hidden=(64, 64),
                                     critic_hidden=(64, 64))),
                       ReplayBuffer(4096),
                       TrainerConfig(num_envs=32, steps_per_chunk=8,
                                     batch_size=64, opt_interval=8,
                                     warmup_period=0), cuda_graphs=graphs)

    _graphed_vs_eager(build)


def _offline_buffer(n=2048, obs_dim=6, act_dim=2, seed=0):
    """A flat buffer filled with seeded random transitions on the card."""
    from border_tpu_torch.replay import ReplayBuffer, Transition

    g = torch.Generator().manual_seed(seed)
    buf = ReplayBuffer(n)
    z = torch.zeros(obs_dim)
    flag = torch.zeros((), dtype=torch.bool)
    st = buf.init(_to(Transition(z, torch.zeros(act_dim), z, torch.zeros(()),
                                 flag, flag), "cuda"))
    buf.push(st, _to(Transition(
        obs=torch.randn((n, obs_dim), generator=g),
        act=torch.rand((n, act_dim), generator=g) * 2 - 1,
        next_obs=torch.randn((n, obs_dim), generator=g),
        reward=torch.rand((n,), generator=g),
        terminated=torch.rand((n,), generator=g) < 0.05,
        truncated=torch.zeros((n,), dtype=torch.bool)), "cuda"))
    return buf, st


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bc", "awac", "iql"])
def test_graphed_offline_chunk_equals_eager_chunk_bitwise(name):
    """OfflineTrainer: BC with the cosine learning-rate schedule, AWAC and
    IQL, three graphed chunks of 40 updates against three eager ones."""
    from border_tpu_torch.agents import (AWAC, AWACConfig, BC, BCConfig, IQL,
                                         IQLConfig)
    from border_tpu_torch.agents.common import cosine_decay_schedule
    from border_tpu_torch.core.spaces import Box
    from border_tpu_torch.train import OfflineTrainer, TrainerConfig

    _cuda()
    obs_space, act_space = Box(-10.0, 10.0, (6,)), Box(-1.0, 1.0, (2,))
    make_agent = {
        "bc": lambda: BC(BCConfig(lr=cosine_decay_schedule(1e-3, 100),
                                  hidden=(64, 64))),
        "awac": lambda: AWAC(AWACConfig(actor_hidden=(64, 64),
                                        critic_hidden=(64, 64))),
        "iql": lambda: IQL(IQLConfig(actor_hidden=(64, 64),
                                     critic_hidden=(64, 64))),
    }[name]
    out = {}
    for graphs in (True, False):
        agent = make_agent()
        buf, bst = _offline_buffer()
        st = agent.init(0, obs_space, act_space)
        tr = OfflineTrainer(agent, buf, TrainerConfig(batch_size=64),
                            updates_per_chunk=40, cuda_graphs=graphs)
        gen = torch.Generator(device="cuda").manual_seed(5)
        sums = []
        for _ in range(3):
            st, bst, s = tr._chunk(st, bst, gen)
            sums.append(s)
        torch.cuda.synchronize()
        out[graphs] = (st, bst, gen, sums)
    _assert_bitwise(out[True][:3], out[False][:3])
    for a, b in zip(out[True][3], out[False][3]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert out[True][0].n_opts == 120


@pytest.mark.cuda
def test_graphed_run_resumed_from_checkpoint_equals_uninterrupted(tmp_path):
    """Trainer.train() graphed, checkpointed after its second chunk, and a
    new trainer resumed from there: the same final state, bitwise, as the
    uninterrupted graphed run (the device counters are restored in place
    into the states the new graphs capture)."""
    import dataclasses

    from border_tpu_torch.utils import CheckpointManager

    _cuda()
    build = _pong_trainer(max_opts=96)
    want = build(True).train(seed=0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    tr = build(True)
    tr.checkpoint_manager, tr.checkpoint_interval = mgr, 64
    tr.config = dataclasses.replace(tr.config, max_opts=64)
    tr.train(seed=0)
    assert mgr.all_steps() == [64]
    got = build(True).train(seed=0, resume_from=mgr)
    assert got.opt_steps == want.opt_steps == 96
    _assert_bitwise((got.agent_state, got.buffer_state),
                    (want.agent_state, want.buffer_state))


@pytest.mark.cuda
def test_uncapturable_update_raises_and_does_not_fall_back():
    """An agent whose update reads a device value on the host: the graphed
    trainer raises GraphCaptureError naming the operator; it does not run
    the eager path instead."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.train.graphs import WARMUP, GraphCaptureError

    _cuda()

    class Syncing(DQN):
        def update(self, state, batch, gen=None):
            state, metrics, td = super().update(state, batch, gen)
            if float(metrics["loss"]) < 0:  # a host read: cannot be captured
                metrics["loss"] = -metrics["loss"]
            return state, metrics, td

    tr = _pong_trainer(agent=lambda: Syncing(DQNConfig(
        model=lambda n: AtariCNN(n))))(True)
    ag, vec, buf = tr.init_states(0, 1)
    gen = tr._loop_generator(0)
    ag, vec, buf, *_ = tr._chunk(ag, vec, buf, gen, False)
    with pytest.raises(GraphCaptureError, match="_local_scalar_dense"):
        tr._chunk(ag, vec, buf, gen, True)
    # the eager warm-up ran; the rest of the chunk did not, eagerly or not
    assert int(ag.counts[0]) == WARMUP < tr.updates_per_chunk


class _Cycle:
    """Holds ``held`` in a reference cycle: only the collector frees it."""

    def __init__(self, held):
        self.me, self.held = self, held


@pytest.mark.cuda
@pytest.mark.parametrize("guarded", [True, False])
def test_a_graph_the_collector_frees_inside_a_capture(guarded, monkeypatch):
    """ROADMAP C.6: a captured graph held only by a reference cycle, freed
    by a collection that starts while the Pendulum evaluation's step is
    being captured, invalidates that capture ('operation failed due to a
    previous error during capture', at whichever operator comes next).
    ``LoopGraph._capture`` collects before the capture and keeps the
    collector off during it: the evaluation captures, and its record is the
    eager evaluation's.  Without that guard (the capture as it was) the
    evaluation raises GraphCaptureError."""
    import contextlib
    import gc

    from border_tpu_torch.agents import SAC, SACConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.train import Evaluator, graphs

    _cuda()
    if not guarded:
        monkeypatch.setattr(graphs, "no_collection", contextlib.nullcontext)
    dead = []

    class Dropping(SAC):
        def select_action_eval(self, state, obs, gen=None):
            if dead and torch.cuda.is_current_stream_capturing():
                _Cycle(dead.pop())  # garbage at once, for the next collection
            return super().select_action_eval(state, obs, gen)

    agent = Dropping(SACConfig(actor_hidden=(32, 32), critic_hidden=(32, 32)))
    first = Evaluator(make("Pendulum-v1"), 4, 16)
    st = agent.init(0, first.vec.observation_space, first.vec.action_space)
    first.evaluate(agent, st)  # captures and replays its step's graph
    dead.append(first._graphs.pop("evaluation step").graph)
    ev = Evaluator(make("Pendulum-v1"), 4, 16)
    threshold = gc.get_threshold()
    gc.set_threshold(1)  # a collection at the next allocations
    try:
        if guarded:
            got = ev.evaluate(agent, st)[1]
        else:
            with pytest.raises(graphs.GraphCaptureError,
                               match="previous error during capture"):
                ev.evaluate(agent, st)
    finally:
        gc.set_threshold(*threshold)
    assert not dead  # dropped inside the capture
    if guarded:
        want = Evaluator(make("Pendulum-v1"), 4, 16,
                         cuda_graphs=False).evaluate(agent, st)[1]
        assert dict(got.items()) == dict(want.items())


# -- CUDA graphs: the host path, the evaluators, async, sharded ----------------

def _recording_native(n, env_id, seed):
    """A C++ env pool that keeps a copy of every action it is handed."""
    from border_tpu_torch.envs.native import NativeVecEnv

    class Recording(NativeVecEnv):
        acts: list

        def step_final(self, actions):
            self.acts.append(np.array(actions))
            return super().step_final(actions)

    env = Recording(env_id, n, seed=seed)
    env.acts = []
    return env


def _host_twins(build):
    """``build(graphs)`` → (trainer, recording env); both twins' train():
    final states, actions, counters, evaluations and the gather's launches
    equal, bitwise.  Returns the graphed trainer and its result."""
    out = {}
    for graphs in (True, False):
        tr, env = build(graphs)
        assert tr.cuda_graphs is graphs
        launches = frame_gather.gather_frames.launches
        r = tr.train()
        torch.cuda.synchronize()
        out[graphs] = (r, env.acts, frame_gather.gather_frames.launches - launches, tr)
    (g, g_acts, g_l, g_tr), (e, e_acts, e_l, _) = out[True], out[False]
    _assert_bitwise((g.agent_state, g.buffer_state), (e.agent_state, e.buffer_state))
    assert len(g_acts) == len(e_acts) > 0
    for i, (a, b) in enumerate(zip(g_acts, e_acts)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
    assert (g.opt_steps, g.env_steps, g.eval_history) == (
        e.opt_steps, e.env_steps, e.eval_history)
    assert g_l == e_l
    assert {"device step", "update"} <= set(g_tr._graphs) and all(
        loop.graph is not None for loop in g_tr._graphs.values())
    return g_tr, g, g_l


@pytest.mark.cuda
def test_graphed_host_pong_frame_mode_equals_eager_bitwise():
    """HostEnvTrainer over 8 C++ Pong envs in frame mode (the device stack
    ring): the warmup, 24 updates two an iteration with a hard target sync
    every 4, and two HostEvaluator evaluations, graphed against eager."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig

    _cuda()
    n = 8

    def build(graphs):
        env = _recording_native(n, "Pong-v0", 1)
        agent = DQN(DQNConfig(model=lambda a: AtariCNN(a), lr=1e-3,
                              double_dqn=True, soft_update_interval=4, tau=1.0,
                              eps_final_step=2_000))
        cfg = TrainerConfig(max_opts=24, warmup_period=35 * n, opt_interval=n // 2,
                            batch_size=8, num_envs=n, steps_per_chunk=8,
                            eval_interval=12, seed=0)
        ev = HostEvaluator("Pong-v0", n_episodes=2, max_steps=40,
                           cuda_graphs=graphs)
        return HostEnvTrainer(env, agent, FrameReplayBuffer(64, n), cfg,
                              evaluator=ev, cuda_graphs=graphs), env

    tr, r, launches = _host_twins(build)
    assert r.opt_steps == 24 and launches == 24 and len(r.eval_history) == 2
    assert r.buffer_state.total == r.buffer_state.counts[0].item() > 40


@pytest.mark.cuda
def test_graphed_host_cartpole_flat_mode_equals_eager_bitwise():
    """HostEnvTrainer over 16 C++ CartPole envs through the flat ring (the
    obs and the final obs uploaded, the obs copied inside the graph)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import HostEnvTrainer, HostEvaluator, TrainerConfig

    _cuda()
    n = 16

    def build(graphs):
        env = _recording_native(n, "CartPole-v1", 2)
        agent = DQN(DQNConfig(hidden=(64, 64), lr=1e-3, soft_update_interval=5,
                              tau=1.0, eps_final_step=500))
        cfg = TrainerConfig(max_opts=40, warmup_period=128, opt_interval=8,
                            batch_size=32, num_envs=n, steps_per_chunk=8,
                            eval_interval=20, seed=1)
        ev = HostEvaluator("CartPole-v1", n_episodes=4, max_steps=100,
                           cuda_graphs=graphs)
        return HostEnvTrainer(env, agent, ReplayBuffer(2048), cfg, evaluator=ev,
                              cuda_graphs=graphs), env

    tr, r, _ = _host_twins(build)
    assert r.opt_steps == 40 and r.buffer_state.size == r.env_steps


def _eval_records(ev, agent, st, indices):
    out = []
    for i in indices:
        _, rec = ev.evaluate(agent, st, eval_index=i)
        out.append(dict(rec.items()))
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("env_id, max_steps", [("Pong-v0", 61),
                                               ("CartPole-v1", 500)])
def test_graphed_evaluator_equals_eager_bitwise(env_id, max_steps):
    """Evaluator graphed (blocks of 8 replays, the last one shorter) and
    eager: evaluations 0, 1, 0 give the same records, and the same as a
    fresh evaluator's.  Pong runs into a cap that is not a multiple of 8;
    CartPole's episodes all end well before theirs (the early exit)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.train import Evaluator

    _cuda()
    pong = env_id == "Pong-v0"
    agent = DQN(DQNConfig(model=lambda a: AtariCNN(a)) if pong
                else DQNConfig(hidden=(32,)))
    evs = {g: Evaluator(make(env_id, **({"train": False} if pong else {})),
                        n_episodes=6, max_steps=max_steps, cuda_graphs=g)
           for g in (True, False)}
    st = agent.init(0, evs[True].vec.observation_space, evs[True].vec.action_space)
    got = {g: _eval_records(ev, agent, st, (0, 1, 0)) for g, ev in evs.items()}
    assert got[True] == got[False]
    assert got[True][0] == got[True][2] != got[True][1]
    fresh = Evaluator(make(env_id, **({"train": False} if pong else {})),
                      n_episodes=6, max_steps=max_steps)
    assert _eval_records(fresh, agent, st, (1,)) == [got[True][1]]
    assert evs[True]._graphs["evaluation step"].graph is not None
    if pong:
        assert got[True][0]["Episodes truncated"] == 6
    else:
        assert got[True][0]["Episodes truncated"] == 0
        assert max(r["Episode length"] for r in got[True]) < max_steps - 8


@pytest.mark.cuda
def test_graphed_host_evaluator_equals_eager_bitwise():
    """HostEvaluator on C++ Pong: the select replayed per step against the
    eager select, evaluations 0, 1, 0."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.core import spaces
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.train import HostEvaluator

    _cuda()
    agent = DQN(DQNConfig(model=lambda a: AtariCNN(a)))
    st = agent.init(0, spaces.Box(0, 255, (84, 84, 4), torch.uint8),
                    spaces.Discrete(6))
    evs = {g: HostEvaluator("Pong-v0", n_episodes=3, max_steps=45, cuda_graphs=g)
           for g in (True, False)}
    got = {g: _eval_records(ev, agent, st, (0, 1, 0)) for g, ev in evs.items()}
    assert got[True] == got[False] and got[True][0] == got[True][2]
    assert evs[True]._graphs["host evaluation select"].graph is not None


@pytest.mark.cuda
def test_graphed_async_trainer_equals_eager_and_resumes_bitwise(tmp_path):
    """AsyncTrainer on Pong: three update chunks with a policy sync after
    the second, graphed against eager (agent, ring, actor copy), then a
    graphed trainer resumed from the checkpoint after the second chunk
    against the uninterrupted graphed run."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import AsyncTrainer, TrainerConfig
    from border_tpu_torch.utils import CheckpointManager

    _cuda()

    def build(graphs, max_opts=96, manager=None):
        agent = DQN(DQNConfig(model=lambda n: AtariCNN(n), lr=1e-3,
                              soft_update_interval=20, tau=1.0,
                              eps_final_step=2_000))
        cfg = TrainerConfig(num_envs=64, steps_per_chunk=8, batch_size=32,
                            opt_interval=16, warmup_period=0, max_opts=max_opts,
                            sync_interval=40, seed=0)
        return AsyncTrainer(make("Pong-v0"), agent, FrameReplayBuffer(64, 64), cfg,
                            checkpoint_manager=manager,
                            checkpoint_interval=64 if manager else 0,
                            cuda_graphs=graphs)

    out = {}
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    for graphs in (True, False):
        tr = build(graphs, manager=mgr if graphs else None)
        launches = frame_gather.gather_frames.launches
        r = tr.train(seed=0)
        torch.cuda.synchronize()
        out[graphs] = (r, tr, frame_gather.gather_frames.launches - launches)
    (g, g_tr, g_l), (e, e_tr, e_l) = out[True], out[False]
    assert g.opt_steps == 96 and g_l == e_l == 96 and g_tr._last_sync == 64
    _assert_bitwise((g.agent_state, g.buffer_state, g_tr._actor_params),
                    (e.agent_state, e.buffer_state, e_tr._actor_params))
    assert g_tr._graphs and all(loop.graph is not None
                                for loop in g_tr._graphs.values())
    assert mgr.all_steps() == [64]
    res = build(True)
    got = res.train(seed=0, resume_from=mgr)
    assert got.opt_steps == 96
    _assert_bitwise((got.agent_state, got.buffer_state, res._actor_params),
                    (g.agent_state, g.buffer_state, g_tr._actor_params))


_NCCL_WORLD_OF_ONE = r"""
import copy, os, sys, tempfile
import torch
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.ops import frame_gather
from border_tpu_torch.parallel import ShardedTrainer, init_distributed, make_mesh
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import Trainer, TrainerConfig
from border_tpu_torch.utils import collectives
from border_tpu_torch.utils.checkpoint import pack_state

init_distributed("file://" + os.path.join(tempfile.mkdtemp(), "store"), 1, 0)
assert torch.distributed.get_backend() == "nccl"
cfg = TrainerConfig(num_envs=64, steps_per_chunk=8, batch_size=32,
                    opt_interval=16, warmup_period=0)
agent = lambda: DQN(DQNConfig(model=lambda n: AtariCNN(n), lr=1e-3,
                              soft_update_interval=20, tau=1.0))
env, mesh = make("Pong-v0"), make_mesh()
trs = {"plain": Trainer(env, agent(), FrameReplayBuffer(64, 64), cfg),
       "sharded": ShardedTrainer(env, agent(), FrameReplayBuffer(64, 64), cfg,
                                 mesh=mesh),
       "sharded_eager": ShardedTrainer(env, agent(), FrameReplayBuffer(64, 64),
                                       cfg, mesh=mesh, cuda_graphs=False)}
assert [t.cuda_graphs for t in trs.values()] == [True, True, False]
ag, vec, buf = trs["plain"].init_states(0, 1)
out = {}
for name, tr in trs.items():
    st = [copy.deepcopy(ag), tr.vec.reset(1), tr.buffer.init()]
    gen = torch.Generator(device="cuda").manual_seed(7)
    st[:] = tr._chunk(*st, gen, False)[:3]
    collectives.counts.clear()
    launches = frame_gather.gather_frames.launches
    losses = []
    for _ in range(3):
        *chunk, metrics, _, _ = tr._chunk(*st, gen, True)
        st[:] = chunk
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    out[name] = (st, losses, frame_gather.gather_frames.launches - launches,
                 dict(collectives.counts), gen.get_state())
m = 3 * trs["sharded"].updates_per_chunk
want = out["plain"]
for name in ("sharded", "sharded_eager"):
    st, losses, launches, counts, gen = out[name]
    assert losses == want[1], (name, losses, want[1])
    assert launches == m, (name, launches)
    assert torch.equal(gen, want[4]), name
    for i in (0, 2):
        a, b = pack_state(st[i]), pack_state(want[0][i])
        def walk(x, y, path):
            if isinstance(x, dict):
                assert x.keys() == y.keys(), path
                for k in x:
                    walk(x[k], y[k], path + "/" + str(k))
            elif torch.is_tensor(x):
                assert x.dtype == y.dtype and torch.equal(x, y), (name, path)
            else:
                assert x == y, (name, path)
        walk(a, b, str(i))
# the gradient all-reduces count one a replay, as eagerly: one per update
# and gradient dtype, besides each chunk's episode sums and metric mean
assert out["sharded"][3] == out["sharded_eager"][3], (out["sharded"][3],
                                                      out["sharded_eager"][3])
grads = sum(v for (op, _), v in out["sharded"][3].items() if op == "all_reduce")
assert grads > 2 * 3 and (grads - 2 * 3) % m == 0, out["sharded"][3]
assert trs["sharded"]._graphs["update"].collectives_each
torch.distributed.destroy_process_group()
print("NCCL_WORLD_OF_ONE_OK")
"""


@pytest.mark.cuda
def test_graphed_nccl_world_of_one_equals_eager_and_the_trainer_bitwise():
    """ShardedTrainer, a world of one over NCCL in a subprocess: three
    graphed update chunks (the gradient all-reduce captured in the update's
    graph) against the same world eager and against the graphed Trainer,
    bitwise; the all-reduces count one a replay."""
    import os
    import subprocess
    import sys

    _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", _NCCL_WORLD_OF_ONE], cwd=root,
                       env={**os.environ, "PYTHONPATH": root},
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0 and "NCCL_WORLD_OF_ONE_OK" in p.stdout, p.stderr[-4000:]


@pytest.mark.cuda
def test_uncapturable_host_step_and_evaluation_raise():
    """A select that reads a device value on the host, in the host path's
    device step and in the Evaluator's step: GraphCaptureError naming the
    operator, no eager fallback."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Evaluator, HostEnvTrainer, TrainerConfig
    from border_tpu_torch.train.graphs import GraphCaptureError

    _cuda()

    class Syncing(DQN):
        def select_action(self, state, obs, gen):
            act = super().select_action(state, obs, gen)
            return act if int(act.max()) >= 0 else -act  # a host read

        def select_action_eval(self, state, obs, gen=None):
            return self.select_action(state, obs, gen)

    tr = HostEnvTrainer("CartPole-v1", Syncing(DQNConfig(hidden=(16,))),
                        ReplayBuffer(512), TrainerConfig(
                            max_opts=4, warmup_period=64, opt_interval=8,
                            batch_size=16, num_envs=8, steps_per_chunk=4))
    with pytest.raises(GraphCaptureError, match="_local_scalar_dense"):
        tr.train()
    ev = Evaluator(make("CartPole-v1"), 4, 40)
    agent = Syncing(DQNConfig(hidden=(16,)))
    st = agent.init(0, ev.vec.observation_space, ev.vec.action_space)
    with pytest.raises(GraphCaptureError, match="_local_scalar_dense"):
        ev.evaluate(agent, st)
