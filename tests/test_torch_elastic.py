"""The port's elastic crash recovery (``tests/test_elastic.py``'s cases),
and what the JAX test never asserted: the run that recovered from an
injected crash ends bitwise equal to a run that never crashed, in agent
state (networks, optimizer moments, counters), replay state and the loop's
counters, because the checkpoint holds every generator's state."""

import pytest
import torch

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Trainer, TrainerConfig, TrainingFailed, run_elastic
from border_tpu_torch.utils import CheckpointManager
from border_tpu_torch.utils.checkpoint import pack_state

# 8 envs x 8 steps a chunk / 8: 8 updates a chunk
CFG = TrainerConfig(
    max_opts=24,
    warmup_period=0,
    opt_interval=8,
    batch_size=16,
    num_envs=8,
    steps_per_chunk=8,
    eval_interval=10**9,
    seed=3,
)


def _trainer(mgr, cls=Trainer, interval=8):
    return cls(make("CartPole-v1"), DQN(DQNConfig(hidden=(8,))),
               ReplayBuffer(256, device="cpu"), CFG, checkpoint_manager=mgr,
               checkpoint_interval=interval, device="cpu")


def _crashing(crashes):
    """A Trainer class whose chunk raises after it ran, ``crashes`` times
    in all, once a checkpoint exists."""
    left = [crashes]

    class CrashingTrainer(Trainer):
        def _chunk(self, *args, **kwargs):
            out = super()._chunk(*args, **kwargs)
            if left[0] > 0 and self.checkpoint_manager.latest_step() is not None:
                left[0] -= 1
                raise RuntimeError("injected fault: actor died")
            return out

    return CrashingTrainer


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_bitwise(a, b):
    a, b = dict(_leaves(pack_state(a))), dict(_leaves(pack_state(b)))
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_elastic_recovers_from_injected_crash(tmp_path):
    attempts = []
    cls = _crashing(1)

    def make_trainer(mgr):
        attempts.append(mgr.latest_step())
        return _trainer(mgr, cls)

    res = run_elastic(make_trainer, str(tmp_path / "ckpt"), max_restarts=2,
                      device="cpu")
    assert res.opt_steps >= CFG.max_opts
    # first attempt started cold, the retry resumed from a real checkpoint
    assert attempts == [None, 8]
    assert all(torch.isfinite(p).all()
               for p in res.agent_state.params.parameters())


@pytest.mark.parametrize("crashes", [1, 2])
def test_recovered_run_is_bitwise_the_uninterrupted_one(tmp_path, crashes):
    whole = _trainer(CheckpointManager(str(tmp_path / "whole"), device="cpu"))
    want = whole.train()
    attempts = []
    cls = _crashing(crashes)

    def make_trainer(mgr):
        attempts.append(mgr.latest_step())
        return _trainer(mgr, cls)

    got = run_elastic(make_trainer, str(tmp_path / "elastic"),
                      max_restarts=crashes, device="cpu")
    # each crash comes in the chunk after the latest checkpoint, at 8
    assert attempts == [None] + [8] * crashes
    assert (got.opt_steps, got.env_steps) == (want.opt_steps, want.env_steps)
    assert (got.agent_state.n_opts, got.agent_state.n_samples) == (
        want.agent_state.n_opts, want.agent_state.n_samples)
    _assert_bitwise(got.agent_state, want.agent_state)
    _assert_bitwise(got.buffer_state, want.buffer_state)


def test_elastic_gives_up_after_max_restarts(tmp_path):
    class AlwaysCrash(Trainer):
        def _chunk(self, *a, **k):
            raise RuntimeError("hard fault")

    with pytest.raises(TrainingFailed):
        run_elastic(lambda mgr: _trainer(mgr, AlwaysCrash),
                    str(tmp_path / "ckpt"), max_restarts=1, device="cpu")


def test_trainer_construction_is_supervised(tmp_path):
    """A failure while building the trainer (a bad checkpoint directory
    after a crash) counts as an attempt, as in the JAX supervisor."""
    calls = []

    def make_trainer(mgr):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("checkpoint directory unreadable")
        return _trainer(mgr)

    res = run_elastic(make_trainer, str(tmp_path / "ckpt"), max_restarts=1,
                      device="cpu")
    assert len(calls) == 2 and res.opt_steps == CFG.max_opts
    with pytest.raises(TrainingFailed):
        run_elastic(lambda mgr: (_ for _ in ()).throw(OSError("gone")),
                    str(tmp_path / "ckpt2"), max_restarts=2, device="cpu")
