"""Full-training-state checkpointing (≙ border_tpu/utils/checkpoint.py).

One checkpoint holds the agent state (online and target parameters, the
optimizer's moments and step counts, ``n_opts``/``n_samples``), the whole
replay state (ring, sum tree, ``total``), the vectorised env state, the
loop counters and the state of every ``torch.Generator`` the loop draws
from, so a resumed run continues bit-exactly where the saved one stood.

The JAX package hands its pytrees to orbax.  Here :func:`pack_state` turns a
state into plain nested dicts of tensors and Python scalars (a dataclass by
field, an ``nn.Module`` and an optimizer by ``state_dict``, a generator by
``get_state``), which ``torch.save`` writes and ``torch.load`` reads with
``weights_only=True``; :func:`unpack_state` copies them into a template
state of the same structure.  The same pair carries ``Agent.save``/``load``.

Layout: ``<directory>/<step>/state.pt``.  A save writes ``state.pt.tmp``,
syncs it and renames it, so a killed save leaves no half file under the
final name.  Tensors go to ``torch.save`` as they are: it copies one
storage at a time to the host, so a ring of several GB is never held twice
in host memory.  A restore maps the file into memory and copies each tensor
into the template's own storage, so the device never holds a second ring
either.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, List, Optional

import torch
from torch import nn

from border_tpu_torch.utils.device import DeviceLike, resolve_device

_FILE = "state.pt"


def pack_state(x: Any) -> Any:
    """``x`` as nested dicts of tensors and Python scalars (no copies)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: pack_state(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, nn.Module):
        return dict(x.state_dict())
    if isinstance(x, torch.optim.Optimizer):
        # the moments and step counts; the hyperparameters in param_groups
        # are configuration and come from the template on load
        return {i: dict(s) for i, s in x.state_dict()["state"].items()}
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, dict):
        return {k: pack_state(v) for k, v in x.items()}
    if x is None or torch.is_tensor(x) or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def unpack_state(template: Any, saved: Any, device: DeviceLike = "cpu") -> Any:
    """Put what :func:`pack_state` made back into ``template``.  Modules,
    optimizers, generators and tensors are loaded in place: a saved tensor
    is checked against the template's shape and copied into its storage, on
    the template's device and in its dtype.  A tensor the template has no
    place for goes to ``device``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        if (getattr(template, "counts", None) is not None
                and saved.get("counts") is None):
            # saved where the state holds no device counters (the CPU): they
            # are its host ints (border_tpu_torch.utils.counters)
            saved = {**saved, "counts": torch.tensor(
                [saved[n] for n in type(template).COUNTERS])}
        return type(template)(**{
            f.name: unpack_state(getattr(template, f.name), saved.get(f.name),
                                 device)
            for f in dataclasses.fields(template)
        })
    if isinstance(template, nn.Module):
        template.load_state_dict(saved)
        return template
    if isinstance(template, torch.optim.Optimizer):
        # cloned: load_state_dict keeps a tensor that already has the
        # parameter's device and dtype, and ``saved`` may map a file
        template.load_state_dict({
            "state": {i: {k: v.clone() if torch.is_tensor(v) else v
                          for k, v in s.items()}
                      for i, s in (saved or {}).items()},
            "param_groups": template.state_dict()["param_groups"],
        })
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved.cpu())
        return template
    if isinstance(template, dict):
        return {k: unpack_state(template.get(k), v, device)
                for k, v in saved.items()}
    if torch.is_tensor(template):
        if saved is None:
            raise ValueError("the checkpoint lacks a tensor the template has")
        if saved.shape != template.shape:
            raise ValueError(
                f"checkpoint tensor {tuple(saved.shape)} does not fit the "
                f"template's {tuple(template.shape)}"
            )
        with torch.no_grad():  # a leaf that requires grad (SAC's log α)
            template.copy_(saved)
        return template
    if isinstance(template, (bool, int, float)):
        return type(template)(saved)
    if torch.is_tensor(saved):
        return saved.to(device, copy=True)
    return saved


class CheckpointManager:
    """Step-numbered full-state checkpoints under ``directory``, the newest
    ``max_to_keep`` kept.  Whatever device wrote the file, ``restore`` loads
    each tensor onto its template's device, and onto ``device`` (``None`` =
    the GPU) where the template has none."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 device: DeviceLike = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.device = resolve_device(device)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _FILE)

    def all_steps(self) -> List[int]:
        """Steps with a complete checkpoint, ascending."""
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.isfile(self._path(int(d)))
        )

    def save(
        self,
        step: int,
        agent_state: Any,
        buffer_state: Any = None,
        vec_state: Any = None,
        key: Optional[torch.Generator] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """``key`` is the loop's generator; its state is what is saved."""
        state = pack_state({
            "agent_state": agent_state,
            "buffer_state": buffer_state,
            "vec_state": vec_state,
            "key": key,
            "extra": dict(extra or {}),
        })
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)
        steps = self.all_steps()
        for old in steps[: max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(os.path.dirname(self._path(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        agent_state: Any,
        buffer_state: Any = None,
        vec_state: Any = None,
        key: Optional[torch.Generator] = None,
        extra: Optional[dict] = None,
        step: Optional[int] = None,
    ) -> dict:
        """Restore into template states of the saved structure.  ``extra``
        gives defaults for keys the checkpoint lacks."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", mmap=True,
                           weights_only=True)
        template = {
            "agent_state": agent_state,
            "buffer_state": buffer_state,
            "vec_state": vec_state,
            "key": key,
        }
        out = {k: unpack_state(t, saved[k], self.device)
               for k, t in template.items()}
        out["extra"] = {**(extra or {}), **saved["extra"]}
        return out

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX manager's
        interface."""
