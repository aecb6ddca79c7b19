"""The Adam / AdamW step over a list of float32 CUDA tensors, and the
optimizers that take it.

``adam_step(params, grads, exp_avgs, exp_avg_sqs, steps, lr=..., done=...)``
computes, in place, what torch's capturable multi-tensor Adam computes
(``torch.optim.Adam(capturable=True)``): each tensor's step count on the
device, advanced by one, the moments, and the parameters; AdamW's decoupled
weight decay first where ``decoupled``.  The rate is a float32 tensor, read
on the device, so a CUDA graph replays the step with the rate it holds.

The wrapper launches the hand-written kernel in ``csrc/adam.cu`` (built
with ``nvcc`` at first use, bound with ``ctypes``) on the current stream:
one launch a step for up to 64 tensors, bit for bit torch's step.  It
raises on what the kernel does not take, CPU tensors included, and never
falls back.  Its plain version is torch's own capturable Adam, which the
card tests and ``chip_smoke.py`` hold it against; on the CPU
``make_optimizer`` builds torch's Adam and this module is not used.
``launches`` and ``captured`` count the kernel launches as
:func:`border_tpu_torch.ops.gather_frames` counts its own: a graph's replay
adds what its capture recorded.

:class:`KernelAdam` and :class:`KernelAdamW` are ``torch.optim.Adam`` and
``AdamW`` over CUDA parameters whose ``step()`` is one :func:`adam_step` a
parameter group.  Their state is torch's (``step``, ``exp_avg``,
``exp_avg_sq`` a parameter, made at its first step; ``state_dict``,
``load_state_dict``), so checkpoints, ``set_lr`` and readers of the moments
see no difference.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch

from border_tpu_torch.ops import _build

Tensors = Sequence[torch.Tensor]


def load() -> ctypes.CDLL:
    """The kernel's library, built first if missing."""
    lib = _build.load("adam")
    if not lib.border_adam_step.argtypes:
        # without argtypes ctypes passes every Python int as a 32-bit int
        # and cuts the pointers
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.border_adam_step.argtypes = [
            ctypes.c_int, ptrs, ptrs, ptrs, ptrs, ptrs,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.border_adam_step.restype = ctypes.c_int
        lib.border_adam_max_tensors.argtypes = []
        lib.border_adam_max_tensors.restype = ctypes.c_int
        lib.border_adam_error_string.argtypes = [ctypes.c_int]
        lib.border_adam_error_string.restype = ctypes.c_char_p
    return lib


def scratch(device) -> torch.Tensor:
    """A done-counter for :func:`adam_step` on ``device``: four zeroed
    bytes, which the launch's last block resets.  Steps that may overlap on
    the device (on two streams) need one each; an optimizer holds one a
    parameter group.  Made outside a CUDA graph capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("adam_step's done-counter is made outside a CUDA "
                           "graph capture (an optimizer makes its own at "
                           "construction)")
    return torch.zeros((), dtype=torch.int32, device=device)


def _check(params: Tensors, grads: Tensors, exp_avgs: Tensors,
           exp_avg_sqs: Tensors, steps: Tensors, lr, done) -> torch.device:
    n = len(params)
    if not len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(steps) == n:
        raise ValueError("adam_step needs as many gradients, moments and step "
                         "counts as parameters")
    device = params[0].device
    for name, xs in (("parameter", params), ("gradient", grads),
                     ("exp_avg", exp_avgs), ("exp_avg_sq", exp_avg_sqs),
                     ("step", steps)):
        for x in xs:
            if x.dtype != torch.float32:
                raise TypeError(f"adam_step takes float32 tensors, got a "
                                f"{x.dtype} {name}")
            if x.device != device:
                raise ValueError(f"a {name} on {x.device}, the first parameter "
                                 f"on {device}")
            if x.is_sparse:
                raise ValueError(f"adam_step takes no sparse {name}")
    for p, g, m, v, t in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"a parameter {tuple(p.shape)} with gradient "
                             f"{tuple(g.shape)} and moments {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
        if t.numel() != 1:
            raise ValueError(f"a step count has one element, got {t.numel()}")
    if device.type != "cuda":
        raise ValueError(f"adam_step runs on CUDA tensors, got {device} ones "
                         f"(on the CPU make_optimizer builds torch's Adam)")
    for x in (*params, *grads, *exp_avgs, *exp_avg_sqs):
        if not x.is_contiguous():
            raise ValueError("adam_step needs contiguous parameters, "
                             "gradients and moments")
    if not (torch.is_tensor(lr) and lr.dtype == torch.float32
            and lr.numel() == 1 and lr.device == device):
        raise ValueError(f"adam_step reads the rate on the device: a "
                         f"one-element float32 tensor on {device}")
    if not (torch.is_tensor(done) and done.dtype == torch.int32
            and done.numel() == 1 and done.device == device):
        raise ValueError(f"adam_step's done-counter is a one-element int32 "
                         f"tensor on {device} (ops.adam.scratch)")
    return device


def adam_step(params: Tensors, grads: Tensors, exp_avgs: Tensors,
              exp_avg_sqs: Tensors, steps: Tensors, *, lr, done: torch.Tensor,
              betas=(0.9, 0.999), eps: float = 1e-8,
              weight_decay: float = 0.0, decoupled: bool = False) -> None:
    """One Adam step, in place: ``steps`` (each a one-element float32
    count) advance by one, then the moments and the parameters as torch's
    capturable Adam moves them; with ``decoupled`` (AdamW) the parameters
    are first scaled by ``1 − lr·weight_decay``.  ``weight_decay`` without
    ``decoupled`` (Adam's L2 form) is not taken.  Every tensor is
    contiguous float32 on one CUDA device, ``lr`` a one-element float32
    tensor there and ``done`` a counter from :func:`scratch` that no step
    running at the same time uses."""
    if len(params) == 0:
        return
    if weight_decay != 0 and not decoupled:
        raise ValueError("adam_step takes weight decay only decoupled (AdamW)")
    device = _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr, done)
    beta1, beta2 = (float(b) for b in betas)
    lib = load()
    n = len(params)

    def addresses(xs):
        return (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs))

    with torch.cuda.device(device):
        err = lib.border_adam_step(
            n, addresses(params), addresses(grads), addresses(exp_avgs),
            addresses(exp_avg_sqs), addresses(steps),
            (ctypes.c_longlong * n)(*(p.numel() for p in params)),
            lr.data_ptr(), beta1, beta2, 1 - beta1, 1 - beta2, float(eps),
            float(weight_decay), int(weight_decay != 0 and decoupled),
            done.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("Adam kernel launch failed: "
                           + lib.border_adam_error_string(err).decode())
    k = math.ceil(n / lib.border_adam_max_tensors())
    if torch.cuda.is_current_stream_capturing():
        adam_step.captured += k
    else:
        adam_step.launches += k


adam_step.launches = 0
adam_step.captured = 0


def _check_group(group: dict, decoupled: bool) -> None:
    """Raises on a parameter group whose step :func:`adam_step` does not
    compute."""
    if group["weight_decay"] != 0 and not decoupled:
        raise ValueError("the Adam kernel takes weight decay only decoupled "
                         "(AdamW)")
    for key in ("amsgrad", "maximize", "fused", "differentiable"):
        if group.get(key):
            raise ValueError(f"the Adam kernel does not take {key}=True")
    if not group.get("capturable"):
        raise ValueError("the Adam kernel's optimizer is capturable: its step "
                         "count and rate live on the device")
    if not torch.is_tensor(group["lr"]):
        raise ValueError("the Adam kernel's optimizer takes its rate as a "
                         "float32 tensor")
    if any(torch.is_tensor(b) for b in group["betas"]):
        raise ValueError("the Adam kernel takes its betas as floats")


class _KernelStep:
    """``step()``: one :func:`adam_step` a parameter group, over the
    parameters that have a gradient, their state made at their first step
    as torch makes it.  A group is checked when it is added: float32
    parameters on one CUDA device, and a step the kernel computes; it gets
    its own done-counter there (a copy of the optimizer gets its own), and
    the library is built then, so that no chunk pays for ``nvcc``."""

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        try:
            device = self._kernel_device(self.param_groups[-1])
        except (TypeError, ValueError):
            self.param_groups.pop()
            raise
        load()
        # a group's own counter: no two groups' launches share one
        self.__dict__.setdefault("_done", []).append(scratch(device))

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        if "_done" not in self.__dict__:  # a deep copy, or unpickled
            self._done = [scratch(self._kernel_device(group))
                          for group in self.param_groups]

    def _kernel_device(self, group: dict) -> torch.device:
        _check_group(group, self._decoupled(group))
        for p in group["params"]:
            if p.dtype != torch.float32:
                raise TypeError(f"the Adam kernel takes float32 parameters, "
                                f"got a {p.dtype} one")
        devices = {p.device for p in group["params"]}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"the Adam kernel's parameter group is on one "
                             f"CUDA device, got {sorted(map(str, devices))}")
        return devices.pop()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group, done in zip(self.param_groups, self._done):
            decoupled = self._decoupled(group)
            _check_group(group, decoupled)
            params: List[torch.Tensor] = [p for p in group["params"]
                                          if p.grad is not None]
            for p in params:
                state = self.state[p]
                if len(state) == 0:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            states = [self.state[p] for p in params]
            adam_step(params, [p.grad for p in params],
                      [s["exp_avg"] for s in states],
                      [s["exp_avg_sq"] for s in states],
                      [s["step"] for s in states],
                      lr=group["lr"], done=done, betas=group["betas"],
                      eps=group["eps"], weight_decay=group["weight_decay"],
                      decoupled=decoupled)
        return loss

    def _decoupled(self, group: dict) -> bool:
        return (group.get("decoupled_weight_decay", False)
                or isinstance(self, torch.optim.AdamW))


class KernelAdam(_KernelStep, torch.optim.Adam):
    """``torch.optim.Adam(capturable=True)`` whose step is the kernel's."""


class KernelAdamW(_KernelStep, torch.optim.AdamW):
    """``torch.optim.AdamW(capturable=True)`` whose step is the kernel's."""
