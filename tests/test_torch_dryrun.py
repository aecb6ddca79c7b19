"""The port's compile-and-train check (``border_tpu_torch/dryrun.py``)
against ``__graft_entry__.py``:

- ``entry()``'s forward equals the JAX ``entry()``'s on the same
  parameters (carried across by ``convert``), both in float32, at the
  tolerance ``tests/test_torch_models.py`` holds the Atari CNN to;
- ``assert_trained`` accepts and refuses the metric dicts that
  ``_assert_trained`` does;
- ``dryrun_multichip(2)`` on two gloo ranks on the CPU prints its five
  lines.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from border_tpu_torch import convert, dryrun

RTOL = ATOL = 1e-5  # tests/test_torch_models.py's, for AtariCNN in float32


def test_entry_is_the_flagship_forward_on_zero_frames():
    fn, (params, obs) = dryrun.entry(device="cpu")
    assert obs.shape == (8, 84, 84, 4) and obs.dtype == torch.uint8
    assert not obs.any()
    with torch.no_grad():
        q = fn(params, obs)
    assert q.shape == (8, 6) and torch.isfinite(q.float()).all()


def test_entry_forward_equals_the_jax_entry_forward(monkeypatch):
    import border_tpu.models as jax_models

    monkeypatch.setattr(jax_models, "AtariCNN", functools.partial(
        jax_models.AtariCNN, dtype=jnp.float32))
    jfn, (jparams, jobs) = graft.entry()
    fn, (params, obs) = dryrun.entry(dtype=torch.float32, device="cpu")
    assert tuple(jobs.shape) == tuple(obs.shape) and jobs.dtype == jnp.uint8
    ported = convert.atari_cnn_state_dict(jparams)
    assert ported.keys() == params.keys()
    x = np.random.default_rng(3).integers(0, 256, (8, 84, 84, 4), dtype=np.uint8)
    for frames in (np.zeros_like(x), x):
        want = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(frames)))
        with torch.no_grad():
            got = fn(ported, torch.from_numpy(frames))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 1e-3  # not a trivially zero output


@pytest.mark.parametrize("metrics", [
    {"loss": 0.5, "q_mean": 0.1, "epsilon": 1.0},
    {"loss": 0.0, "q_mean": 0.3},
    {"loss": 1e-3, "q_mean": 0.0},
    {"loss": 0.0, "q_mean": 0.0, "epsilon": 0.9},
    {"loss": 1e-13, "q_mean": -1e-13},
    {"q_mean": 0.0},
    {"epsilon": 0.5},
    {"loss": float("nan"), "q_mean": 0.2},
    {"loss": 0.4, "q_mean": float("inf")},
    {"loss": 0.4, "q_mean": 0.2, "epsilon": float("-inf")},
])
def test_assert_trained_accepts_and_refuses_as_the_jax_check(metrics):
    def outcome(check, ms):
        try:
            return "ok", check("tag", ms)
        except AssertionError:
            return "refused", None

    want = outcome(graft._assert_trained, {k: jnp.float32(v) for k, v in metrics.items()})
    got = outcome(dryrun.assert_trained, {k: torch.tensor(v) for k, v in metrics.items()})
    assert got[0] == want[0]
    if want[0] == "ok":
        assert got[1].keys() == want[1].keys()
        for k in want[1]:
            assert math.isclose(got[1][k], want[1][k], rel_tol=1e-6)


def test_dryrun_multichip_on_two_gloo_ranks_prints_five_lines(capsys):
    lines, launches = dryrun.dryrun_multichip(2, "cpu")
    assert capsys.readouterr().out.splitlines() == lines
    assert launches == 0  # the CPU gathers through the plain version
    heads = ["dryrun_multichip OK: 2 ranks", "dryrun_multichip pixel OK: 2 ranks",
             "dryrun_multichip dp×tp OK: mesh {'actors': 1, 'model': 2}",
             "dryrun_multichip pixel dp×tp OK: frame ring over 1 actors rank(s)",
             "dryrun_multichip sharded-async OK: 2 ranks"]
    assert len(lines) == 5
    for line, head in zip(lines, heads):
        assert line.startswith(head) and "metrics={" in line
