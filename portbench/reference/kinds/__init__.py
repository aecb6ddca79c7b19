"""The reference of each agent kind, one module per ``agent.kind`` of a
configuration (``kinds/<kind>.py``), found by that name.  Each holds:

- ``shapes(cfg)``: the parameters' names and shapes, in the order the
  benchmark's weights are drawn (:mod:`portbench.weights`);
- ``greedy(p, x, cfg, rnd, rnd_head)``: the greedy action of a batch of
  observations ``x`` at the parameters ``p``;
- ``loss_draws(u, b, cfg, device)``: the draws the loss of the judged update
  ``u`` takes from the program's generator state at that update (its
  ``gen_state`` and ``gen_offset``), as entries to add to the batch ``b``;
- ``loss(p, tgt, b, cfg, rnd, rnd_head, half=False)``: ``(loss,
  td_error)`` of the batch ``b`` at the online parameters ``p`` and the
  target's ``tgt``; ``half`` is the planted fault of
  :func:`portbench.reference.update.batch_mean`.

``rnd`` and ``rnd_head`` round the operands of the torso's and the head's
products (:mod:`portbench.reference.precision`).
"""

from __future__ import annotations

import importlib


def find(cfg: dict):
    """The reference module of the configuration's agent kind."""
    return importlib.import_module(f"{__name__}.{cfg['agent']['kind']}")
