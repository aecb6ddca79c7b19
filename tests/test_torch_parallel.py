"""The port's process-group layer (``border_tpu_torch.parallel``'s
``init_distributed``, ``process_info``, ``make_mesh``), the agents'
gradient mean (``maybe_pmean``) and ``FrameReplayBuffer.with_num_envs``
against the JAX package's.

The data-parallel learner: JAX runs ``agent.update`` under ``shard_map`` on
n ∈ {2, 4} of the 8 virtual devices with ``axis_name`` set; the port runs
n spawned gloo ranks (``tests/helpers/torch_dist_worker.py``) from the same
converted state on the same per-rank batches (numpy, from a seed), with
each device's τ or noise draws recomputed from its key and injected.
After two updates every rank holds the same parameters, bitwise, and they
agree with JAX's to the tolerances of the single-device parity tests:
atol 1e-5 for DQN and IQN on MLPs (``test_torch_mlp``, ``test_torch_iqn``),
rtol 1e-4 / atol 1e-5 for SAC and IQL (``test_torch_sac``,
``test_torch_offline_agents``).  The Atari-CNN DQN runs with SGD, so its
step is linear in the gradient and ``test_torch_dqn``'s gradient tolerance
holds the step divided by the learning rate, the sum of two updates'
gradients: rtol 1e-4, and atol 2e-6, twice its 1e-6 for the two
(with Adam a gradient within rounding of zero steps by anything in ±lr).  Two
ranks also equal one process updating on their batches laid end to end,
to the same tolerances.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from border_tpu import agents as jagents
from border_tpu.agents.iqn import sample_taus as jax_sample_taus
from border_tpu.core import spaces as jspaces
from border_tpu.models import AtariCNN as JaxAtariCNN
from border_tpu.replay import FrameReplayBuffer as JaxFrameReplayBuffer
from border_tpu.replay import PerConfig as JaxPerConfig
from border_tpu.replay.buffer import TransitionBatch as JaxBatch
from border_tpu_torch import convert
from border_tpu_torch.parallel import (
    init_distributed,
    make_dp_tp_mesh,
    make_mesh,
    process_info,
)
from border_tpu_torch.replay import FrameReplayBuffer, PerConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dist_worker as W  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ["dqn_mlp", "dqn_cnn", "iqn", "sac", "iql"]
UPDATES = 2
ROWS = {"dqn_cnn": 4}  # rows of a rank's batch (else 8)
TOL = {"dqn_mlp": dict(atol=1e-5), "iqn": dict(atol=1e-5),
       "sac": dict(rtol=1e-4, atol=1e-5), "iql": dict(rtol=1e-4, atol=1e-5),
       "dqn_cnn": dict(rtol=1e-4, atol=2e-6)}
FIELDS = {"dqn_mlp": ("params", "target_params"),
          "dqn_cnn": ("params", "target_params"),
          "iqn": ("params", "target_params"),
          "sac": ("actor_params", "critic_params", "critic_target_params"),
          "iql": ("actor_params", "critic_params", "critic_target_params",
                  "value_params")}
CONVERT = {"dqn_mlp": convert.dqn_state, "dqn_cnn": convert.dqn_state,
           "iqn": convert.iqn_state, "sac": convert.sac_state,
           "iql": convert.iql_state}


# -- the process-group layer -------------------------------------------------------

def test_import_starts_neither_cuda_nor_a_process_group():
    code = ("import torch, torch.distributed as dist; "
            "import border_tpu_torch.parallel, border_tpu_torch.examples.sharded_dqn; "
            "print(torch.cuda.is_initialized(), dist.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False False"


def test_init_distributed_is_a_world_of_one_without_a_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert process_info()["process_count"] == 1  # before any group
    init_distributed(device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert process_info() == {"process_index": 0, "process_count": 1,
                                  "local_device_count": 1,
                                  "global_device_count": 1}
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("actors",) and mesh.size() == 1
        mesh = make_dp_tp_mesh(1, 1)
        assert mesh.mesh_dim_names == ("actors", "model")
        with pytest.raises(ValueError, match="shape is required"):
            make_mesh(("actors", "model"))
        with pytest.raises(ValueError, match=r"does not cover 1 devices"):
            make_mesh(("actors",), (2,))
    finally:
        dist.destroy_process_group()


def test_init_distributed_reads_the_launcher_environment(monkeypatch, tmp_path):
    """``torchrun``'s variables, here a world of one over a local port."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    init_distributed(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
    finally:
        dist.destroy_process_group()


def test_init_distributed_takes_the_backend_from_the_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BORDER_TPU_DIST_BACKEND", "gloo")
    init_distributed(device="cpu")
    try:
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_init_distributed_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


# -- FrameReplayBuffer.with_num_envs --------------------------------------------------

def _frame_buffer(package, per_=False, **kw):
    if package == "jax":
        return JaxFrameReplayBuffer(**kw, per=JaxPerConfig() if per_ else None)
    return FrameReplayBuffer(**kw, per=PerConfig() if per_ else None, device="cpu")


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("settings", [
    dict(capacity=16, num_envs=8, frame_hw=(12, 10), stack=3,
         sample_mode="slice", slice_group=2, sort_samples=False),
    dict(capacity=32, num_envs=8, stack=4, n_step=3, gamma=0.9,
         sample_mode="separate", sort_samples=True, per_=1),
    dict(capacity=16, num_envs=8, sample_mode="slice", slice_group=8),
])
def test_with_num_envs_keeps_every_setting(package, settings):
    """Both packages' shard copies carry every setting; a slice group wider
    than the shard is clamped to it (the JAX copy's ``min``), so a shard
    samples in the mode its buffer was built with."""
    buf = _frame_buffer(package, **settings)
    shard = buf.with_num_envs(4)
    assert shard.num_envs == 4
    for name in ("capacity", "frame_hw", "stack", "n_step", "gamma",
                 "sample_mode", "sort_samples", "per"):
        assert getattr(shard, name) == getattr(buf, name), name
    assert shard.slice_group == min(buf.slice_group, 4)
    if buf.per is not None:  # the shard's tree covers its own columns
        assert shard.tree.capacity == 4 * buf.capacity
    if package == "port":
        assert shard.device == buf.device


def test_with_num_envs_per_needs_a_power_of_two():
    buf = FrameReplayBuffer(16, 8, per=PerConfig(), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        buf.with_num_envs(3)


# -- the data-parallel learner against JAX's shard_map ------------------------------

def _jax_case(case):
    """The JAX agent and spaces of a case (``torch_dist_worker.port_case``
    builds the port's)."""
    vec = lambda n: jspaces.Box(-np.inf, np.inf, (n,), jnp.float32)  # noqa: E731
    box2 = jspaces.Box(-1.0, 1.0, (2,), jnp.float32)
    if case == "dqn_mlp":
        return (jagents.DQN(jagents.DQNConfig(hidden=(16, 12), lr=1e-3,
                                              double_dqn=True, tau=0.5,
                                              max_grad_norm=0.5)),
                vec(5), jspaces.Discrete(3))
    if case == "dqn_cnn":
        return (jagents.DQN(jagents.DQNConfig(
            model=functools.partial(JaxAtariCNN, dtype=jnp.float32),
            optimizer="sgd", lr=1e-2, double_dqn=True, tau=0.5)),
            jspaces.Box(0, 255, (84, 84, 4), jnp.uint8), jspaces.Discrete(6))
    if case == "iqn":
        return (jagents.IQN(jagents.IQNConfig(feature_dim=16, n_cos=8,
                                              hidden=(12,), tau=0.5)),
                vec(5), jspaces.Discrete(3))
    if case == "sac":
        return (jagents.SAC(jagents.SACConfig(actor_hidden=(16, 12),
                                              critic_hidden=(16, 12),
                                              ent_coef_mode="auto",
                                              ent_lr=1e-2)),
                vec(6), box2)
    return (jagents.IQL(jagents.IQLConfig(actor_hidden=(16, 12),
                                          critic_hidden=(16, 12),
                                          value_hidden=(12,))),
            vec(6), box2)


def _batch(case, rng, b):
    if case == "dqn_cnn":
        obs = lambda: rng.integers(0, 256, (b, 84, 84, 4), dtype=np.uint8)  # noqa: E731
        act = rng.integers(0, 6, b, dtype=np.int32)
    elif case in ("dqn_mlp", "iqn"):
        obs = lambda: rng.normal(size=(b, 5)).astype(np.float32)  # noqa: E731
        act = rng.integers(0, 3, b, dtype=np.int32)
    else:
        obs = lambda: rng.normal(size=(b, 6)).astype(np.float32)  # noqa: E731
        act = rng.uniform(-1, 1, (b, 2)).astype(np.float32)
    return dict(obs=obs(), act=act, next_obs=obs(),
                reward=rng.normal(size=b).astype(np.float32),
                terminated=rng.random(b) < 0.25, truncated=np.zeros(b, bool))


def _draws(case, jagent, key, b):
    """A device's τ or noise draws of a JAX update with ``key``."""
    if case == "iqn":
        c = jagent.config
        ks = jax.random.split(key, 3)
        return {f"taus{i}": np.array(jax_sample_taus(s, k, b)) for i, (s, k) in
                enumerate(zip((c.sample_percents_pred, c.sample_percents_tgt,
                               c.sample_percents_act), ks))}
    if case == "sac":
        return {f"noise{i}": np.array(jax.random.normal(k, (b, 2)))
                for i, k in enumerate(jax.random.split(key))}
    return {}


def _jax_dp(jagent, jst, batches, keys, n):
    """``UPDATES`` updates under shard_map over n devices (gradients
    pmean-ed over the ``actors`` axis)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("actors",))
    jagent.axis_name = "actors"
    try:
        fn = jax.jit(shard_map(
            lambda s, b, k: jagent.update(s, b, k[0])[0], mesh=mesh,
            in_specs=(P(), P("actors"), P("actors")), out_specs=P(),
            check_vma=False))
        for b, k in zip(batches, keys):
            jst = fn(jst, b, k)
    finally:
        jagent.axis_name = None
    return jst


def _prepare(case, n, tmp):
    """The JAX run, the port's start state and the ranks' data on disk;
    returns (the port's start state, the JAX end state)."""
    tagent, tos, tas = W.port_case(case)
    jagent, jos, jas = _jax_case(case)
    jst0 = jagent.init(jax.random.PRNGKey(0), jos, jas)
    tst0 = CONVERT[case](tagent, jst0, tos, tas, device="cpu")
    state_dir = os.path.join(tmp, f"{case}_state")
    tagent.save(tst0, state_dir)
    b = ROWS.get(case, 8)
    rng = np.random.default_rng(11)
    data, jbatches, jkeys = {}, [], []
    for k in range(UPDATES):
        keys = jax.random.split(jax.random.PRNGKey(100 + k), n)
        rows = []
        for r in range(n):
            d = _batch(case, rng, b)
            rows.append(d)
            data.update({f"r{r}_k{k}_{f}": v for f, v in d.items()})
            data.update({f"r{r}_k{k}_{f}": v for f, v in
                         _draws(case, jagent, keys[r], b).items()})
        cat = {f: np.concatenate([d[f] for d in rows]) for f in rows[0]}
        jbatches.append(JaxBatch(**{f: jnp.asarray(v) for f, v in cat.items()},
                                 weight=jnp.ones(n * b, jnp.float32),
                                 ix_sample=jnp.arange(n * b, dtype=jnp.int32)))
        jkeys.append(keys)
    np.savez(os.path.join(tmp, f"{case}_data.npz"), **data)
    return tst0, _jax_dp(jagent, jst0, jbatches, jkeys, n)


def _want(case, tst0, jst):
    """The JAX end state in the port's layout, ``<field>/<key>``."""
    out = {}
    for f in FIELDS[case]:
        for k, v in convert.net_state_dict(getattr(tst0, f), getattr(jst, f)).items():
            out[f"{f}/{k}"] = v.numpy()
    if case == "sac":
        out["log_alpha"] = np.asarray(jst.log_alpha)
    return out


def _dp_results(tmp_path_factory, n):
    tmp = str(tmp_path_factory.mktemp(f"dp{n}"))
    starts, wants, tasks = {}, {}, []
    for case in CASES:
        tst0, jst = _prepare(case, n, tmp)
        starts[case], wants[case] = W.state_arrays(tst0), _want(case, tst0, jst)
        args = {"case": case, "state_dir": os.path.join(tmp, f"{case}_state"),
                "data": os.path.join(tmp, f"{case}_data.npz"), "updates": UPDATES}
        tasks.append([case, "dp_update", args])
        if n == 2:
            tasks.append([f"{case}_single", "dp_update", {**args, "single": True}])
    W.launch(tmp, n, tasks, timeout=300)
    return {"start": starts, "want": wants,
            "got": lambda task_id: W.results(tmp, task_id, n)}


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _dp_results(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return _dp_results(tmp_path_factory, 4)


def _assert_close(case, got, want, start, what):
    assert set(want) <= set(got)
    lr = {"dqn_cnn": 1e-2}.get(case)
    for k, w in want.items():
        g = got[k]
        if lr is not None:  # SGD: the step over lr is the summed gradient
            g, w = (g - start[k]) / lr, (w - start[k]) / lr
        np.testing.assert_allclose(g, w, err_msg=f"{what} {case} {k}", **TOL[case])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_data_parallel_update_matches_jax_shard_map(request, case, n):
    res = request.getfixturevalue(f"dp{n}")
    ranks = res["got"](case)
    for r in ranks[1:]:  # replicated by the gradient mean
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    _assert_close(case, ranks[0], res["want"][case], res["start"][case], "JAX")
    moved = max(np.abs(ranks[0][k] - v).max() for k, v in res["start"][case].items()
                if k in res["want"][case])
    assert moved > 1e-4, "the updates did not move the parameters"


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process_on_the_concatenated_batch(dp2, case):
    (single, _), (ranks, _) = dp2["got"](f"{case}_single"), dp2["got"](case)
    _assert_close(case, ranks, single, dp2["start"][case], "single process")
