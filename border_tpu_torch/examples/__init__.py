"""Runnable entry points of the port (≙ the JAX package's ``examples/``).

Each runs as ``python -m border_tpu_torch.examples.<name>`` with the JAX
example's options and defaults, plus ``--device`` (default ``cuda``; pass
``--device cpu`` to run on the CPU).  Each module is split into

- ``parser()``: the command line;
- ``build(args)``: the objects the run needs (env, agent, buffer, the
  ``TrainerConfig``, recorder, evaluator), as a ``dict``;
- ``run(args, objs)``: trains or plays, prints the JAX example's summary
  and returns the result;
- ``main(argv=None)``: ``run(args, build(args))``.

So a caller can cut a fixed setting (the pixel examples' 50,000-step
warmup) with ``dataclasses.replace`` on ``objs["config"]`` between
``build`` and ``run``.

The examples: ``dqn_pong`` (the main path), ``play_pong``,
``dqn_cartpole``, ``convert_policy``, ``iqn_seaquest``, ``async_dqn_pong``,
``dqn_pong_host``, ``dqn_cartpole_native``, ``sac_pendulum``,
``sac_reacher``, ``offline_pendulum_medium``, ``offline_fetch_reacher``,
``offline_pendulum``, ``dqn_gymnasium``, ``sac_gymnasium`` and
``sharded_dqn`` (multi-GPU: one rank per GPU, under ``torchrun``).
"""

import os
import tempfile


def tmp_path(name: str) -> str:
    """A default output path: ``name`` under the temporary directory (the
    JAX examples' ``/tmp/<name>``)."""
    return os.path.join(tempfile.gettempdir(), name)


def add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda, or cpu)")
