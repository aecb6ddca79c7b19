"""The comparison that decides ``correct``, one module per driver
(``checks/<driver>.py``), found by the configuration's ``driver``: a check
reads what its driver records in ``observations()``.  Each has
``numbers(obs, cfg, wl, seed, device, controls=False)``: every compared
number of a run, and with ``controls`` also the control's and the planted
faults' readings, each under its side's name and a dot
(:mod:`portbench.calibrate` reads them); and ``small(cfg, wl)``, which
cuts the configuration in place to a size a CPU test holds
(``portbench/tests/``).  A check brings its own plain environment, or
finds it in :mod:`portbench.reference.games`.
"""

from __future__ import annotations

import importlib


def find(cfg: dict):
    """The check of the configuration's driver."""
    return importlib.import_module(f"{__name__}.{cfg['driver']}")
