"""Elastic training: checkpoint-based crash recovery
(≙ border_tpu/train/elastic.py).

≙ SURVEY.md §5.3: the reference has NO failure handling — actor panics
silently lose the actor and there is no restart story (unwrap()s marked
"TODO: error handling" throughout border-async-trainer).  Because this
framework checkpoints the FULL training state (agent + optimizer + replay
+ env states + generators + counters, utils/checkpoint.py), recovery is simply
"restore the latest checkpoint and continue" — this module supplies the
supervisor loop that does so.

The port's resume is exact: a run that crashed and was resumed ends with
the agent state, the replay state and the counters of a run that never
crashed, bit for bit (``Trainer.train(resume_from=...)``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

from border_tpu_torch.train.trainer import TrainResult
from border_tpu_torch.utils.checkpoint import CheckpointManager
from border_tpu_torch.utils.device import DeviceLike

log = logging.getLogger(__name__)


class TrainingFailed(RuntimeError):
    """Raised when training keeps crashing past ``max_restarts``."""


def run_elastic(
    make_trainer: Callable[[CheckpointManager], Any],
    checkpoint_dir: str,
    max_restarts: int = 3,
    restart_delay_sec: float = 0.0,
    max_to_keep: int = 3,
    device: DeviceLike = None,
) -> TrainResult:
    """Run ``trainer.train()`` under crash supervision.

    ``make_trainer(ckpt_manager)`` must build a fresh Trainer wired to the
    given checkpoint manager (pass it as ``checkpoint_manager=`` with a
    nonzero ``checkpoint_interval``).  On any exception the supervisor
    rebuilds the trainer and resumes from the latest full-state checkpoint;
    a run that crashes before the first checkpoint restarts from scratch.
    Returns the completed TrainResult; raises :class:`TrainingFailed` after
    ``max_restarts`` consecutive failed attempts.  ``device`` is the
    checkpoint manager's (``None`` = the GPU), the trainer's own.
    """
    restarts = 0
    while True:
        mgr = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep,
                                device=device)
        try:
            # trainer construction stays under supervision: wiring a
            # checkpoint manager against a corrupt/partial checkpoint dir —
            # exactly the post-crash scenario — must count toward
            # max_restarts too
            trainer = make_trainer(mgr)
            resume = mgr if mgr.latest_step() is not None else None
            result = trainer.train(resume_from=resume)
            if restarts:
                log.info("elastic: completed after %d restart(s)", restarts)
            return result
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            log.exception(
                "elastic: training attempt %d crashed (latest checkpoint: %s)",
                restarts, mgr.latest_step(),
            )
            if restarts > max_restarts:
                raise TrainingFailed(
                    f"training crashed {restarts} times; giving up"
                )
            if restart_delay_sec:
                time.sleep(restart_delay_sec)
        finally:
            mgr.close()
