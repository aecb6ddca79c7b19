"""The SAC cell's own pieces: its FLOP count, and its check on the CPU with
the program broken underneath (half the batch in the critics' loss, Adam
steps that move nothing, a soft target update skipped or made a hard
copy, an altered env step or sample), each of which must come out not
correct."""

import contextlib
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests.test_portbench_check import readings, small

ROOT = Path(__file__).resolve().parents[2]
CELL = "sac-pendulum.replay8"


def _flops():
    path = ROOT / "portbench" / "flops" / "sac-pendulum.py"
    spec = importlib.util.spec_from_file_location("sac_pendulum_flops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sac_update_macs():
    m = _flops()
    cfg = json.loads((ROOT / "portbench" / "configs" / "sac-pendulum.json").read_text())
    # actor 3·256 + 256·256 + 2·256·1, a critic 4·256 + 256·256 + 256·1
    assert m.actor_macs(cfg) == m.critic_macs(cfg) == 66_816
    f = 66_816
    target = 3 * f  # the actor and both target critics on next_obs
    critics = 2 * (f + 2 * f - 4 * 256)  # forward and backward, no input gradient
    # the actor's sample, both critics' forward and input-gradient backward,
    # the actor's backward without its input gradient
    actor = f + 2 * f + 2 * f + 2 * f - 3 * 256
    td = 2 * f
    assert m.update_macs(cfg) == target + critics + actor + td == 1_199_872
    assert m.chunk_flops(cfg, 128) == 2 * (128 * 32 * f + 128 * 256 * 1_199_872)


def _fails(patch=contextlib.nullcontext()) -> list:
    with patch:
        got = readings(small(CELL))
    _, failed = run.verdict(got, run.cell_files(CELL)["limits"])
    return failed


def test_half_the_batch_left_out_of_the_critics_loss(monkeypatch):
    from border_tpu_torch.agents import sac

    real = sac.CRITIC_LOSSES["mse"]

    def half(pred, target):
        per = real(pred, target)
        h = per.shape[-1] // 2
        return torch.cat([per[..., :h], per[..., :h]], dim=-1)

    monkeypatch.setitem(sac.CRITIC_LOSSES, "mse", half)
    assert "loss_gap" in _fails()


@pytest.mark.parametrize("sound_steps", [0, 9])
def test_adam_steps_that_leave_the_state_unchanged(sound_steps, monkeypatch):
    """Every step, or those after the graph's eager warm-up (three updates
    of three steps each; replays on the card), move nothing."""
    real, calls = torch.optim.Adam.step, []

    def step(self, closure=None):
        calls.append(1)
        return real(self, closure) if len(calls) <= sound_steps else None

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    assert "change_gap" in _fails()


@pytest.mark.parametrize("fault", ["skipped", "hard copy"])
def test_a_soft_target_update_skipped_or_made_a_hard_copy(fault, monkeypatch):
    from border_tpu_torch.agents import common, sac

    def polyak(tau, online, target):
        if fault == "hard copy":
            common.polyak_update(1.0, online, target)

    monkeypatch.setattr(sac, "polyak_update", polyak)
    assert "target_mismatch" in _fails()


def test_a_torque_altered_where_the_env_steps(monkeypatch):
    from border_tpu_torch.envs import classic_control

    real = classic_control.Pendulum.step_env

    def step_env(self, gen, state, action, params):
        action = action.clone()
        action[0] = action[0] * 0.5
        return real(self, gen, state, action, params)

    monkeypatch.setattr(classic_control.Pendulum, "step_env", step_env)
    assert "env_mismatch" in _fails()


def test_a_row_altered_where_the_ring_is_sampled(monkeypatch):
    from border_tpu_torch.replay import buffer

    real = buffer.ReplayBuffer.sample_at

    def sample_at(self, state, idx, weight=None):
        batch = real(self, state, idx, weight)
        batch.reward = batch.reward.clone()
        batch.reward[0] += 1.0
        return batch

    monkeypatch.setattr(buffer.ReplayBuffer, "sample_at", sample_at)
    assert "sample_mismatch" in _fails()
