"""The prioritized-replay sum tree's batched update and stratified descent
(the level loops of :class:`border_tpu_torch.replay.SumTree`).

``sum_tree_update(sum_tree, min_tree, max_priority, indices, priorities)``
writes ``K`` leaves and every ancestor of each in place;
``sum_tree_sample(sum_tree, u) -> leaves`` descends one lane a draw of
``u``.  The layout and the rules (a duplicated index keeps the largest of
its priorities, a zero priority marks a dead leaf, the descent never enters
a right subtree whose sum is zero) are :mod:`border_tpu_torch.replay.
sum_tree`'s.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/sum_tree.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``) on the current stream, one launch a call, or raises.  On a CPU
tensor it runs the plain version beside it (:func:`sum_tree_update_ref`,
:func:`sum_tree_sample_ref`): a few small torch ops a level of the tree,
which the kernels give bit for bit.  ``launches`` and ``captured`` count the
kernel launches as :func:`border_tpu_torch.ops.gather_frames` counts its
own: a graph's replay adds what its capture recorded.
"""

from __future__ import annotations

import ctypes

import torch

from border_tpu_torch.envs.pixel import true_div
from border_tpu_torch.ops import _build


def sum_tree_update_ref(sum_tree: torch.Tensor, min_tree: torch.Tensor,
                        max_priority: torch.Tensor, indices: torch.Tensor,
                        priorities: torch.Tensor) -> None:
    """Plain PyTorch version: the leaves by ``scatter_reduce_`` (``amax``,
    the old value taking no part), then per level a gather of both children
    and a scatter of their sum (``left + right``) and min."""
    if indices.numel() == 0:
        return
    capacity = sum_tree.numel() // 2
    depth = capacity.bit_length() - 1
    leaves = indices + capacity
    sum_tree.scatter_reduce_(0, leaves, priorities, "amax", include_self=False)
    p = sum_tree[leaves]
    min_tree[leaves] = torch.where(p > 0, p, float("inf"))
    shifts = torch.arange(1, depth + 1, device=leaves.device)[:, None]
    parents = leaves[None, :] >> shifts  # [depth, K]
    lefts = parents * 2
    rights = lefts + 1
    for par, left, right in zip(parents, lefts, rights):
        sum_tree[par] = sum_tree[left] + sum_tree[right]
        min_tree[par] = torch.minimum(min_tree[left], min_tree[right])
    torch.maximum(max_priority, priorities.max(), out=max_priority)


def sum_tree_sample_ref(sum_tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the mass points ``(i + u[i]) · total / B``,
    then all lanes a level a round: one paired read of both children, right
    where the mass reaches the left sum and the right sum is not zero."""
    capacity = sum_tree.numel() // 2
    b = u.shape[0]
    # divided by a tensor: CUDA multiplies by a Python divisor's
    # reciprocal, which strays from the CPU's division at batch sizes
    # that are not powers of two
    mass = (torch.arange(b, dtype=torch.float32, device=u.device) + u) * true_div(
        sum_tree[1], b)
    nodes = torch.ones((b,), dtype=torch.int64, device=u.device)
    pairs = sum_tree.view(capacity, 2)  # node n's children: pairs[n]
    for _ in range(capacity.bit_length() - 1):
        left_sum, right_sum = pairs[nodes].unbind(1)
        go_right = (mass >= left_sum) & (right_sum > 0)
        nodes = 2 * nodes + go_right
        mass = torch.where(go_right, mass - left_sum, mass)
    return nodes - capacity


def load() -> ctypes.CDLL:
    """The kernels' library, built first if missing (a CUDA tree's set-up
    calls it, so that no chunk pays for ``nvcc``)."""
    lib = _build.load("sum_tree")
    if not lib.border_sum_tree_update.argtypes:
        # without argtypes ctypes passes every Python int as a 32-bit int
        # and cuts the pointers
        lib.border_sum_tree_update.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.border_sum_tree_update.restype = ctypes.c_int
        lib.border_sum_tree_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.border_sum_tree_sample.restype = ctypes.c_int
        lib.border_sum_tree_error_string.argtypes = [ctypes.c_int]
        lib.border_sum_tree_error_string.restype = ctypes.c_char_p
    return lib


def _capacity(sum_tree: torch.Tensor) -> int:
    if sum_tree.dim() != 1 or sum_tree.dtype != torch.float32:
        raise ValueError(f"a tree is a 1-D float32 tensor, got "
                         f"{tuple(sum_tree.shape)} {sum_tree.dtype}")
    capacity = sum_tree.numel() // 2
    if capacity < 1 or sum_tree.numel() != 2 * capacity or capacity & (capacity - 1):
        raise ValueError(f"a tree holds 2 · capacity entries, capacity a power "
                         f"of two; got {sum_tree.numel()}")
    return capacity


def _vector(name: str, x: torch.Tensor, dtype: torch.dtype,
            device: torch.device) -> None:
    if x.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device} but the tree on {device}")


def _launched(fn, lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"sum-tree {what} kernel launch failed: "
                           + lib.border_sum_tree_error_string(err).decode())
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def sum_tree_update(sum_tree: torch.Tensor, min_tree: torch.Tensor,
                    max_priority: torch.Tensor, indices: torch.Tensor,
                    priorities: torch.Tensor) -> None:
    """Writes ``priorities[K]`` (float32, ≥ 0) at leaves ``indices[K]``
    (int64, in ``[0, capacity)``) and recomputes their ancestors in both
    trees and the running ``max_priority`` (a 0-dim float32), in place.
    ``indices`` and ``priorities`` may have any stride (a priority
    broadcast from one scalar has stride 0)."""
    capacity = _capacity(sum_tree)
    device = sum_tree.device
    if min_tree.shape != sum_tree.shape or min_tree.dtype != sum_tree.dtype:
        raise ValueError("the min tree must match the sum tree's shape and dtype")
    if min_tree.device != device or max_priority.device != device:
        raise ValueError(f"the min tree and max priority must be on {device}")
    if max_priority.dim() != 0 or max_priority.dtype != torch.float32:
        raise ValueError("max_priority must be a 0-dim float32 tensor")
    _vector("indices", indices, torch.int64, device)
    _vector("priorities", priorities, torch.float32, device)
    if priorities.shape != indices.shape:
        raise ValueError(f"{indices.numel()} indices but "
                         f"{priorities.numel()} priorities")
    if device.type == "cpu":
        sum_tree_update_ref(sum_tree, min_tree, max_priority, indices, priorities)
        return
    if device.type != "cuda":
        raise ValueError(f"no sum-tree kernel for {device}")
    if not (sum_tree.is_contiguous() and min_tree.is_contiguous()):
        raise ValueError("sum_tree_update needs contiguous trees")
    if indices.numel() == 0:
        return
    lib = load()
    with torch.cuda.device(device):
        err = lib.border_sum_tree_update(
            sum_tree.data_ptr(), min_tree.data_ptr(), max_priority.data_ptr(),
            indices.data_ptr(), indices.stride(0),
            priorities.data_ptr(), priorities.stride(0),
            indices.numel(), capacity, capacity.bit_length() - 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _launched(sum_tree_update, lib, err, "update")


def sum_tree_sample(sum_tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One leaf (int64) a draw of ``u[B]`` (float32 in ``[0, 1)``): stratum
    ``i`` of ``total / B``'s mass point ``(i + u[i]) · total / B``,
    located by a descent from the root."""
    capacity = _capacity(sum_tree)
    _vector("u", u, torch.float32, sum_tree.device)
    if sum_tree.device.type == "cpu":
        return sum_tree_sample_ref(sum_tree, u)
    if sum_tree.device.type != "cuda":
        raise ValueError(f"no sum-tree kernel for {sum_tree.device}")
    if not (sum_tree.is_contiguous() and u.is_contiguous()):
        raise ValueError("sum_tree_sample needs a contiguous tree and u")
    if sum_tree.data_ptr() % 8:
        raise ValueError("sum_tree_sample reads a node's children as one "
                         "8-byte pair: the tree must be 8-byte aligned")
    out = torch.empty(u.shape, dtype=torch.int64, device=u.device)
    if out.numel() == 0:
        return out
    lib = load()
    with torch.cuda.device(u.device):
        err = lib.border_sum_tree_sample(
            sum_tree.data_ptr(), u.data_ptr(), out.data_ptr(), u.numel(),
            capacity, capacity.bit_length() - 1,
            torch.cuda.current_stream().cuda_stream,
        )
    _launched(sum_tree_sample, lib, err, "descent")
    return out


sum_tree_update.launches = 0
sum_tree_update.captured = 0
sum_tree_sample.launches = 0
sum_tree_sample.captured = 0
