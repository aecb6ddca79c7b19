"""The comparison that decides ``correct`` for the flat-transition
trainer's driver.

What the program produced in set-up, through the window's own call (the
trainer's chunk), is judged against the plain reference: the
configuration's env (``reference/games/<env>.py``'s ``GAME``, a vector
observation and action) and agent kind (:mod:`portbench.reference.kinds`;
the kinds this driver runs also hold ``learner(w0, cfg)`` and
``update(learner, b, cfg, rnd, half, still)``, a whole update of a learner
with its own optimizers).

1. **env step**: the reference steps the cell's envs from the seed's
   reset with the actions the program took and must find, for every env
   and each of set-up's steps, the same observation, next observation,
   reward and flags in the program's ring (row ``step·envs + env``).  The
   envs reset as the port's vector env does: every step draws a candidate
   reset from the env's generator, taken where the episode ended.  Exact:
   ``env_mismatch`` counts the differing rows of each field.
2. **act**: the deterministic action of the first chunk's observations at
   the seed's weights (set-up acts before any update): ``act_gap``, the
   largest gap to the reference's over the action range.
3. **replay sample**: each of the first six batches against the
   reference's rows at the drawn indices, which must lie in the rows
   set-up wrote.  Exact: ``sample_mismatch``.
4. **agent update**: the reference starts from the seed's weights and
   follows the first six updates in float32 on its own rows at the
   program's indices, with the normal draws worked out again from the
   program's generator state at each update.  The program ran the first
   three eagerly (its graph's warm-up) and the next three as replays.
   Compared are every loss of each update (``loss_gap``, the worst), the
   first gradient as the optimizers got it, leaf by leaf (``grad_gap``:
   the median leaf's gap of norms; ``grad_gap_worst``; ``grad_flip``: the
   share of its elements with another sign), and the parameters' change
   over the eager updates and over the replayed ones (``change_gap``, the
   worst leaf of either).
5. **soft target update**: the program's own count after the window
   (``target_mismatch``, from the driver).  Exact.

A leaf's gap of norms is ``| ‖prog‖ − ‖ref‖ |`` over the larger of the
reference leaf's norm and the median leaf's.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of
``change_gap`` (Adam moves them by round-off alone).  The control (every
product in TF32, one step under the configuration's float32) and the
planted faults ``half`` (the critics' loss over half the batch) and
``still`` (Adam steps that move nothing) are read against the reference
with ``controls``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from portbench import seeds, weights
from portbench.reference import kinds, precision
from portbench.reference.games import find as find_env
from portbench.reference.games import select

FIELDS = ("obs", "act", "next_obs", "reward", "terminated", "truncated")
BELOW = {"float32": "tf32"}


def rollout(cfg: dict, act: torch.Tensor, envs: int, seed: int, device) -> dict:
    """The reference ring of the program's actions ``act`` ``[rows, A]``
    (row ``step·envs + env``), every field ``[rows, ...]``."""
    env = find_env(cfg["env"])()
    gen = torch.Generator(device=device).manual_seed(seeds.env(seed))
    st = env.reset(gen, envs, device)
    act = act.to(device).view(-1, envs, act.shape[-1])
    out: Dict[str, list] = {f: [] for f in FIELDS}
    for t in range(act.shape[0]):
        nxt, r, term, trunc = env.step(st, act[t])
        for f, v in zip(FIELDS, (env.obs(st), act[t], env.obs(nxt), r, term, trunc)):
            out[f].append(v)
        fresh = env.reset(gen, envs, device)
        st = select(term | trunc, fresh, nxt)
    return {f: torch.cat(v) for f, v in out.items()}


def _differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` and ``b`` that differ anywhere."""
    d = a.to(b.device) != b.to(a.dtype)
    return d.flatten(1).any(dim=1) if d.dim() > 1 else d


def env_mismatch(ring: dict, ref: dict) -> int:
    return sum(int(_differ(ring[f], ref[f]).sum()) for f in FIELDS)


def sample_mismatch(updates: List[dict], ref: dict) -> int:
    """Entries of the program's first batches that differ from the
    reference's rows, and draws outside the rows set-up wrote."""
    rows = ref["reward"].shape[0]
    bad = 0
    for u in updates:
        ix = u["ix"].long().to(ref["reward"].device)
        out = (ix < 0) | (ix >= rows)
        bad += int(out.sum())
        keep = ~out
        for f in FIELDS[:-1]:
            bad += int(_differ(u[f][keep.cpu()], ref[f][ix[keep]]).sum())
    return bad


def act_gap(mine: torch.Tensor, theirs: torch.Tensor, cfg: dict) -> float:
    env = find_env(cfg["env"])
    return float((mine.to(theirs.device) - theirs).abs().max()) / (env.act_high - env.act_low)


def rounder(cfg: dict, mode: str):
    """Every product's operand rounding: ``fp32``, or ``below`` (one
    precision step under the configuration's)."""
    return precision.rounder(BELOW[cfg["agent"]["compute_dtype"]] if mode == "below" else mode)


def greedy(cfg: dict, seed: int, obs: torch.Tensor, device, mode: str = "fp32"):
    kind = kinds.find(cfg)
    w0 = weights.make(kind.shapes(cfg), seeds.weights(seed), device)
    rnd = rounder(cfg, mode)
    with torch.no_grad():
        return kind.greedy(w0, obs.to(device), cfg, rnd, rnd)


def follow(cfg: dict, seed: int, ref_ring: dict, updates: List[dict], device,
           mode: str = "fp32", half: bool = False, still: bool = False) -> dict:
    """The reference's first updates: ``losses`` (each update's list),
    ``grad1`` (the first gradient, by leaf), ``params`` (by the number of
    updates after which the program's were read) and ``w0`` (the
    parameters the updates start from)."""
    kind = kinds.find(cfg)
    w0 = weights.make(kind.shapes(cfg), seeds.weights(seed), device)
    lrn = kind.learner(w0, cfg)
    start = {k: v.detach().clone() for k, v in lrn["params"].items()}
    rnd = rounder(cfg, mode)
    out = {"losses": [], "grad1": None, "params": {}, "w0": start}
    with precision.exact_float32():
        for k, u in enumerate(updates):
            ix = u["ix"].long().to(device)
            b = {f: ref_ring[f][ix] for f in FIELDS}
            b.update(kind.loss_draws(u, b, cfg, device))
            losses, grads = kind.update(lrn, b, cfg, rnd, half=half, still=still)
            out["losses"].append(losses)
            if k == 0:
                out["grad1"] = {n: g.detach().clone() for n, g in grads.items()}
            if "params" in u:
                out["params"][k + 1] = {n: v.detach().clone()
                                        for n, v in lrn["params"].items()}
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The update's numbers of ``prog`` (the program's, or a control's)
    against the reference ``ref`` (both as :func:`follow` returns)."""
    out = {"loss_gap": max(abs(a - b) / max(abs(b), 1e-12)
                           for ps, rs in zip(prog["losses"], ref["losses"])
                           for a, b in zip(ps, rs))}
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    med = statistics.median(g_ref.values())
    by_leaf = [abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med) for k in g_ref]
    out["grad_gap"] = statistics.median(by_leaf)
    out["grad_gap_worst"] = max(by_leaf)
    dev = ref["grad1"][next(iter(g_ref))].device
    flips = sum(int((prog["grad1"][k].to(dev).sign() != ref["grad1"][k].sign()).sum())
                for k in g_ref)
    out["grad_flip"] = flips / sum(v.numel() for v in ref["grad1"].values())
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    ends = sorted(ref["params"])
    out["change_gap"] = max(_change_gap(prog, ref, a, b, moving)
                            for a, b in zip([0] + ends[:-1], ends))
    return out


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
    return {"losses": [u["losses"] for u in obs["updates"]],
            "grad1": {k: v.to(device) for k, v in obs["grad1"].items()},
            "params": {k + 1: {n: v.to(device) for n, v in u["params"].items()}
                       for k, u in enumerate(obs["updates"]) if "params" in u}}


def small(cfg: dict, wl: dict) -> None:
    """``cfg`` cut in place to a size a CPU test holds: 16 envs, 32-step
    chunks, a 4,096-row ring, batch 128, every width as published."""
    cfg["replay"].update(num_envs=16, capacity=4096, steps_per_chunk=32)
    cfg["agent"].update(batch_size=128)


def numbers(obs: dict, cfg: dict, wl: dict, seed: int, device,
            controls: bool = False) -> Dict[str, Optional[float]]:
    """Every compared number of a run (``obs``: the driver's record of
    set-up).  ``controls``: also the control's and the planted faults'
    readings of the update's numbers, under ``control.``, ``half.`` and
    ``still.``."""
    with precision.exact_float32():
        ref_ring = rollout(cfg, obs["ring"]["act"], obs["envs"], seed, device)
        first = ref_ring["obs"][:obs["greedy"].shape[0]]
        out: Dict[str, Optional[float]] = {
            "env_mismatch": env_mismatch(obs["ring"], ref_ring),
            "sample_mismatch": sample_mismatch(obs["updates"], ref_ring),
            "act_gap": act_gap(obs["greedy"], greedy(cfg, seed, first, device), cfg),
        }
    ref = follow(cfg, seed, ref_ring, obs["updates"], device)
    out.update(gaps(program_readings(obs, device), ref))
    if controls:
        with precision.exact_float32():
            out["control.act_gap"] = act_gap(greedy(cfg, seed, first, device, "below"),
                                             greedy(cfg, seed, first, device), cfg)
        for name, kw in (("control", dict(mode="below")), ("half", dict(half=True)),
                         ("still", dict(still=True))):
            other = follow(cfg, seed, ref_ring, obs["updates"], device, **kw)
            out.update({f"{name}.{k}": v for k, v in gaps(other, ref).items()})
    return out
