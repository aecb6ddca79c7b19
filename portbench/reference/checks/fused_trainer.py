"""The comparison that decides ``correct`` for the fused trainer's driver.

What the program produced in set-up, through the window's own call (the
trainer's chunk), is judged here against the plain reference: the
configuration's game (:mod:`portbench.reference.games`, by ``env``) and
agent kind (:mod:`portbench.reference.kinds`, by ``agent.kind``).

1. **act and env step**: the reference replays the cell's envs from the seed's
   reset with the actions the program took (its answers, read only to
   judge what followed them) and must find, for every env and each of the
   first two chunks' steps, the same frame, reward, flags and episode age
   in the program's ring.  Exact: ``env_mismatch`` counts the differing
   entries.  Set-up acts before any update, so the reference also works
   out each action from the seed's weights and the loop's ε-draws:
   ``act_gap`` is the share of the greedy decisions in which the program
   chose another action (rounding flips near-ties).
2. **replay sample**: for each of the first six updates, the stacks the
   program's gather returned, its actions, rewards and flags, against the
   reference's own stacks of its own ring at the drawn (env, step); and
   every draw must lie in the documented draw range.  Exact:
   ``sample_mismatch``.
3. **agent update**: the reference starts from the seed's weights and
   follows the first six updates in float32 on its own batches (the
   program's draws of env and step, and whatever the kind's loss draws
   from the program's generator state at the update, worked out again).
   The program ran the first three eagerly (its graph's warm-up) and the
   next three as replays of its captured update, as the window runs
   every update.  Compared are each update's loss (``loss_gap``, the
   worst of the six), the first gradient as the optimizer got it, leaf
   by leaf (``grad_gap``: the median leaf's gap of norms;
   ``grad_gap_worst``: the worst leaf's; ``grad_flip``: the share of its
   elements with another sign), the parameters' change over the eager
   updates and over the replayed ones (``change_gap``, the worst leaf of
   either) and, with prioritized replay, the sum tree's total mass
   before updates 2 to 6 (``per_total_gap``).
4. **target copy**: the program's own count, after the window
   (``target_mismatch``, from the driver): the target network's elements
   that the update before a hard copy changed, and those that differ
   from the online network after the copy.  Exact.

A leaf's gap of norms is ``| ‖prog‖ − ‖ref‖ |`` over the larger of the
reference leaf's norm and the median leaf's.  The gradient is compared by
its median leaf: one leaf, the last convolution's bias, sums 25,088
output gradients a channel that cancel to a few hundredths of their
magnitudes, and bf16's rounding of those terms moves its norm by up to
half (PERF.md, the look).  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of ``change_gap`` (Adam
moves them by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import seeds, weights
from portbench.reference import games, kinds, precision, update

BELOW = {"bfloat16": "fp8", "float32": "tf32"}


def greedy_policy(cfg: dict, seed: int, device, mode: str = "fp32"):
    """The acting net's greedy action of ``[N, 4, 84, 84]`` stacks, at the
    seed's weights (set-up acts before any update)."""
    kind = kinds.find(cfg)
    w0 = weights.make(kind.shapes(cfg), seeds.weights(seed), device)
    rnd, rnd_head = rounders(cfg, mode)

    @torch.no_grad()
    def act(x):
        return kind.greedy(w0, x, cfg, rnd, rnd_head)

    return act


def epsilon(cfg: dict, n_samples: int) -> torch.Tensor:
    """ε after ``n_samples`` env steps: linear from ``eps_start`` to
    ``eps_final``, in float32."""
    a = cfg["agent"]
    frac = torch.tensor(n_samples, dtype=torch.float32) / torch.tensor(
        float(a["eps_final_step"]), dtype=torch.float32)
    return (frac.clamp(0.0, 1.0) * float(np.float32(a["eps_final"]) - np.float32(a["eps_start"]))
            + float(np.float32(a["eps_start"])))


def rollout(cfg: dict, act: torch.Tensor, seed: int, device,
            policies: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The reference ring of ``act.shape[1]`` steps: for each env and step,
    the newest frame seen before acting, the reward, the flags and the
    episode's age.  The envs take the program's actions; ``policies``
    (name → greedy policy) also give, under ``greedy.<name>``, the action
    each would have chosen, and ``explore`` marks the ε-draws (the loop's
    stream: a random action, then the test against ε, per step)."""
    n, t_steps = act.shape
    env = games.VectorEnv(cfg["env"], n, device)
    gen = torch.Generator(device=device).manual_seed(seeds.env(seed))
    loop = torch.Generator(device=device).manual_seed(seeds.loop(seed))
    st = env.reset(gen)
    policies = policies or {}
    out = {
        "frames": torch.empty((n, t_steps, games.H, games.W), dtype=torch.uint8,
                              device=device),
        "reward": torch.empty((n, t_steps), device=device),
        "terminated": torch.empty((n, t_steps), dtype=torch.bool, device=device),
        "truncated": torch.empty((n, t_steps), dtype=torch.bool, device=device),
        "age": torch.empty((n, t_steps), dtype=torch.int32, device=device),
        "act": act.to(device),
        "explore": torch.empty((n, t_steps), dtype=torch.bool, device=device),
        **{f"greedy.{k}": torch.empty((n, t_steps), dtype=torch.long, device=device)
           for k in policies},
    }
    act = out["act"]
    for t in range(t_steps):
        out["frames"][:, t] = st.frames[..., -1]
        out["age"][:, t] = st.episode_length
        obs = st.frames.permute(0, 3, 1, 2)
        for k, policy in policies.items():
            out[f"greedy.{k}"][:, t] = policy(obs)
        torch.randint(0, cfg["n_actions"], (n,), generator=loop, device=device,
                      dtype=torch.int32)
        out["explore"][:, t] = torch.rand((n,), generator=loop, device=device) < \
            epsilon(cfg, t * n).to(device)
        st, r, term, trunc = env.step(gen, st, act[:, t])
        out["reward"][:, t], out["terminated"][:, t] = r, term
        out["truncated"][:, t] = trunc
    return out


def env_mismatch(ring: dict, ref: dict) -> int:
    """Frames (each whole frame), rewards, flags and ages that differ."""
    frames = (ring["frames"].to(ref["frames"].device) != ref["frames"]
              ).flatten(2).any(dim=2).sum()
    rest = sum((ring[k].to(ref[k].device) != ref[k]).sum()
               for k in ("reward", "terminated", "truncated", "age"))
    return int(frames + rest)


def union_stacks(ring: dict, e: torch.Tensor, s: torch.Tensor, stack: int):
    """(obs, next_obs) ``[B, stack, 84, 84]`` of steps ``s`` of envs ``e``:
    the episode's last ``stack`` frames before acting and after, the
    episode's first frame repeated where it is younger than the stack."""
    js = torch.arange(stack + 1, device=e.device)
    age = ring["age"][e, s].long()
    idx = (s + 1)[:, None] - torch.minimum((stack - js)[None, :],
                                           (age + 1)[:, None])
    u = ring["frames"][e[:, None], idx]
    return u[:, :stack], u[:, 1:]


def draws(u: dict, capacity: int):
    ix = u["ix"].long()
    return ix // capacity, ix % capacity


def sample_mismatch(prog_updates: List[dict], ref: dict, cfg: dict,
                    wl: dict) -> int:
    """Entries of the program's first batches that differ from the
    reference's, and draws outside ``[stack, steps − 1)``."""
    stack, cap = cfg["torso"]["stack"], cfg["replay"]["capacity_per_env"]
    dev = ref["frames"].device
    t_steps = ref["frames"].shape[1]
    bad = 0
    for u in prog_updates:
        e, s = (x.to(dev) for x in draws(u, cap))
        out = (s < stack) | (s >= t_steps - 1)
        bad += int(out.sum())
        e, s = e[~out], s[~out]
        keep = (~out).cpu()
        obs, nxt = union_stacks(ref, e, s, stack)
        for mine, theirs in ((u["obs"], obs), (u["next_obs"], nxt)):
            mine = mine[keep].to(dev).permute(0, 3, 1, 2)
            bad += int((mine != theirs).flatten(2).any(dim=2).sum())
        for k in ("act", "reward", "terminated"):
            bad += int((u[k][keep].to(dev) != ref[k][e, s].to(u[k].dtype)).sum())
    first = prog_updates[0]["weight"]
    if first is not None:  # prioritized: every live leaf at the same priority
        bad += int((first != 1.0).sum())
    return bad


def rounders(cfg: dict, mode: str):
    """The torso's and the head's operand rounding: ``fp32``, or ``below``
    (each one precision step under what the configuration states)."""
    if mode == "below":
        return (precision.rounder(BELOW[cfg["torso"]["compute_dtype"]]),
                precision.rounder(BELOW[cfg["agent"]["head_dtype"]]))
    return precision.rounder(mode), precision.rounder(mode)


def act_gap(ring: dict, ref: dict, name: str = "ref") -> float:
    """The share of the greedy decisions (no ε-draw) in which ``ring``'s
    action is not the reference policy's."""
    greedy = ~ref["explore"]
    theirs = ref[f"greedy.{name}"]
    mine = ring["act"].to(theirs.device).long()
    return float((mine != theirs)[greedy].sum()) / max(int(greedy.sum()), 1)


def follow(cfg: dict, wl: dict, seed: int, ref_ring: dict, prog_updates: List[dict],
           device, mode: str = "fp32", half: bool = False,
           still: bool = False) -> dict:
    """The reference's first updates: ``losses``, ``grad1`` (the first
    gradient, by leaf), ``params`` (by the number of updates after which
    the program's were read), ``w0`` (the seed's weights) and, with
    prioritized replay, ``totals`` (the tree's mass before each update
    after the first).  The target network is the seed's weights until a
    hard copy (every ``target_interval`` updates).  ``mode`` ``below`` computes
    every product one precision step under the configuration's.  The
    planted faults: ``half`` (the loss's mean over half the batch),
    ``still`` (steps that leave the parameters and the tree unchanged)."""
    kind = kinds.find(cfg)
    w0 = weights.make(kind.shapes(cfg), seeds.weights(seed), device)
    params = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    target = {k: v.clone() for k, v in w0.items()}
    rnd, rnd_head = rounders(cfg, mode)
    opt = update.Adam(cfg["agent"]["lr"])
    stack, cap = cfg["torso"]["stack"], cfg["replay"]["capacity_per_env"]
    per = wl.get("per")
    t_steps = ref_ring["frames"].shape[1]
    prio = None
    if per is not None:
        prio = torch.zeros((ref_ring["frames"].shape[0], cap), dtype=torch.float32, device=device)
        prio[:, stack:t_steps - 1] = 1.0  # resident steps, at the first max
        prio = prio.reshape(-1)
    out = {"losses": [], "grad1": None, "params": {}, "w0": w0, "totals": []}
    interval = cfg["agent"]["target_interval"]
    with precision.exact_float32():
        for k, u in enumerate(prog_updates):
            e, s = (x.to(device) for x in draws(u, cap))
            obs, nxt = union_stacks(ref_ring, e, s, stack)
            b = {"obs": obs, "next_obs": nxt, "act": ref_ring["act"][e, s].long(),
                 "reward": ref_ring["reward"][e, s],
                 "terminated": ref_ring["terminated"][e, s]}
            if prio is not None:
                ix = (e * cap + s).long()
                if k:
                    out["totals"].append(float(prio.double().sum()))
                # the first draw's weights are all 1 (every live leaf at the
                # first max priority); later ones are the program's, read as
                # its draw: normalized by the smallest priority in the tree,
                # they scale with the smallest |TD| of the batches before,
                # which no precision pins down (PERF.md)
                b["weight"] = (torch.ones_like(b["reward"]) if k == 0
                               else u["weight"].to(device))
            b.update(kind.loss_draws(u, b, cfg, device))
            loss, td = kind.loss(params, target, b, cfg, rnd, rnd_head, half)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if not still:
                opt.step(params, grads)
            out["losses"].append(float(loss.detach()))
            if k == 0:
                out["grad1"] = {k2: v.detach().clone() for k2, v in grads.items()}
            if "params" in u:
                out["params"][k + 1] = {k2: v.detach().clone() for k2, v in params.items()}
            if not still and (k + 1) % interval == 0:
                target = {k2: v.detach().clone() for k2, v in params.items()}
            if prio is not None and not still:
                new = (td.abs() + per["eps"]) ** per["alpha"]
                prio.scatter_reduce_(0, ix, new.float(), "amax", include_self=False)
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The update's numbers of ``prog`` (the program's, or a control's)
    against the reference ``ref`` (both as :func:`follow` returns)."""
    by_step = [abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(prog["losses"], ref["losses"])]
    out = {"loss_gap": max(by_step)}
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    med = statistics.median(g_ref.values())
    by_leaf = [abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med) for k in g_ref]
    out["grad_gap"] = statistics.median(by_leaf)
    out["grad_gap_worst"] = max(by_leaf)
    # the share of elements whose first gradient has another sign: the
    # elements the first Adam step moves the other way.  A gap of norms is
    # second order in a small error and its sign varies by seed; this
    # count over millions of elements is first order and steady
    flips = sum(int((prog["grad1"][k].sign() != ref["grad1"][k].sign()).sum())
                for k in g_ref)
    out["grad_flip"] = flips / sum(v.numel() for v in ref["grad1"].values())
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    out["change_gap"] = max(_change_gap(prog, ref, a, b, moving)
                            for a, b in _segments(ref))
    if ref["totals"]:
        out["per_total_gap"] = max(abs(a - b) / b for a, b in zip(
            prog["totals"], ref["totals"]))
    return out


def _segments(ref: dict) -> list:
    """``(a, b)``: from after ``a`` updates (0: the seed's weights) to after
    ``b``, for each run of updates whose parameters were read."""
    ends = sorted(ref["params"])
    return list(zip([0] + ends[:-1], ends))


def _change_gap(prog: dict, ref: dict, a: int, b: int, moving: list) -> float:
    """The worst moving leaf's gap of norms of the change from after ``a``
    updates to after ``b``, over the larger of the reference leaf's and
    the median leaf's change."""
    def at(side, n):
        return ref["w0"] if n == 0 else side["params"][n]

    dev = ref["w0"][moving[0]].device
    d_ref = {k: float((at(ref, b)[k] - at(ref, a)[k]).double().norm()) for k in moving}
    d_prog = {k: float((at(prog, b)[k].to(dev) - at(prog, a)[k].to(dev)).double().norm())
              for k in moving}
    med_d = statistics.median(d_ref.values())
    return max(abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med_d) for k in moving)


def program_readings(obs: dict, device) -> dict:
    """The program's side in :func:`follow`'s form."""
    return {"losses": [u["loss"] for u in obs["updates"]],
            "grad1": {k: v.to(device) for k, v in obs["grad1"].items()},
            "params": {k + 1: {n: v.to(device) for n, v in u["params"].items()}
                       for k, u in enumerate(obs["updates"]) if "params" in u},
            "totals": [u["tree_total"] for u in obs["updates"][1:]
                       if u["tree_total"] is not None]}


def small(cfg: dict, wl: dict) -> None:
    """``cfg`` cut in place to a size a CPU test holds: 16 envs, a 128-step
    ring, 32-step chunks, batch 128 (64 at one sample a transition, so
    that set-up's second chunk makes the judged updates), a target copy
    every 8 updates, every width as published; ε reaches its floor within
    set-up, so most of its actions are greedy and judged."""
    cfg["replay"].update(num_envs=16, capacity_per_env=128, steps_per_chunk=32)
    cfg["agent"].update(batch_size=min(128, 64 * wl["replay_ratio"]),
                        eps_final_step=64, target_interval=8)


def numbers(obs: dict, cfg: dict, wl: dict, seed: int, device,
            controls: bool = False) -> Dict[str, Optional[float]]:
    """Every compared number of a run (``obs``: the driver's record of
    set-up).  ``controls``: also the control's and the planted faults'
    readings of the update's numbers, under ``control.``, ``half.`` and
    ``still.``."""
    policies = {"ref": greedy_policy(cfg, seed, device)}
    if controls:
        policies["control"] = greedy_policy(cfg, seed, device, "below")
    with precision.exact_float32():
        ref_ring = rollout(cfg, obs["ring"]["act"], seed, device, policies)
    out: Dict[str, Optional[float]] = {
        "env_mismatch": env_mismatch(obs["ring"], ref_ring),
        "sample_mismatch": sample_mismatch(obs["updates"], ref_ring, cfg, wl),
        "act_gap": act_gap(obs["ring"], ref_ring),
    }
    ref = follow(cfg, wl, seed, ref_ring, obs["updates"], device)
    out.update(gaps(program_readings(obs, device), ref))
    if controls:
        out["control.act_gap"] = act_gap({"act": ref_ring["greedy.control"]}, ref_ring)
        for name, kw in (("control", dict(mode="below")), ("half", dict(half=True)),
                         ("still", dict(still=True))):
            other = follow(cfg, wl, seed, ref_ring, obs["updates"], device, **kw)
            out.update({f"{name}.{k}": v for k, v in gaps(other, ref).items()})
    return out
