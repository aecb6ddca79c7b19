"""The port's learning gate (``border_tpu_torch/learning.py``) against the
JAX harness (``benchmarks/learning.py``) and ``bench.py --gate``:

- every one of the 15 gate configs builds field for field as the JAX one
  (objects only: nothing is initialised at full width, a Pong ring is
  3.7 GB);
- the port's ``gate()`` prints ``bench.py --gate``'s JSON line, on the
  committed JAX artifacts and on crafted directories;
- ``run`` writes an artifact with the JAX artifact's keys on tiny CPU runs
  of ``cartpole`` and ``bc_offline``;
- the converted IQL corpus loads as the Minari-format HDF5 file does.
"""

import dataclasses
import functools
import importlib.util
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from border_tpu_torch import learning
from border_tpu_torch.agents.common import lr_at

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # beside other test processes, torch's intra-op threads contend for the
    # cores (the BC update is 256 wide)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_learning():
    spec = importlib.util.spec_from_file_location(
        "learning_gate", ROOT / "benchmarks" / "learning.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(v) -> bool:
    return isinstance(v, (bool, int, float, str, tuple, type(None)))


def _same_fields(ours, theirs, what, skip=()):
    """Every plain field of ``theirs`` (a JAX object) has the same value in
    ``ours``; callables and sub-configs are compared by the caller."""
    names = [f.name for f in dataclasses.fields(theirs)] if dataclasses.is_dataclass(
        theirs) else list(vars(theirs))
    compared = 0
    for n in names:
        v = getattr(theirs, n)
        if n in skip or not _plain(v):
            continue
        assert getattr(ours, n) == v, f"{what}.{n}: {getattr(ours, n)!r} != {v!r}"
        compared += 1
    return compared


def _same_env(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    for k, v in vars(theirs).items():
        if _plain(v) and hasattr(ours, k):
            assert getattr(ours, k) == v, k
    if hasattr(theirs, "env"):
        _same_env(ours.env, theirs.env)


def _same_agent(agent, jagent):
    c, jc = agent.config, jagent.config
    assert type(c).__name__ == type(jc).__name__
    assert _same_fields(c, jc, type(c).__name__) >= 3
    for f in dataclasses.fields(jc):
        v = getattr(jc, f.name)
        if f.name == "model" and v is not None:
            assert type(getattr(c, f.name)(6)).__name__ == type(v(6)).__name__
        elif isinstance(v, functools.partial):
            p = getattr(c, f.name)
            assert (p.func.__name__, p.keywords) == (v.func.__name__, v.keywords)
        elif f.name == "lr" and callable(v):  # BC's cosine decay
            for k in (0, 1, 3_000, 6_000, 11_999, 12_000):
                assert lr_at(c.lr, k) == pytest.approx(float(v(k)), rel=1e-6, abs=1e-12)


def _same_buffer(buf, jbuf):
    assert type(buf).__name__ == type(jbuf).__name__
    assert _same_fields(buf, jbuf, "buffer", skip=("use_pallas", "slot_pad",
                                                   "frame_rows", "frame_pad")) >= 3
    assert (buf.per is None) == (jbuf.per is None)
    if jbuf.per is not None:
        _same_fields(buf.per, jbuf.per, "per")


def _same_evaluator(ev, jev):
    assert type(ev).__name__ == type(jev).__name__
    assert (ev.n_episodes, ev.max_steps) == (jev.n_episodes, jev.max_steps)
    if hasattr(jev, "vec"):
        _same_env(ev.vec.env, jev.vec.env)
    if hasattr(jev, "ref_min"):
        assert (ev.ref_min, ev.ref_max) == (jev.ref_min, jev.ref_max)


@pytest.mark.parametrize("config", list(learning.TARGETS))
def test_gate_config_is_the_jax_one_field_for_field(config):
    jl = _jax_learning()
    assert learning.TARGETS == jl.TARGETS
    assert learning.N_FINAL_EVALS == jl.N_FINAL_EVALS
    assert learning.OFFLINE_CONFIGS == jl.OFFLINE_CONFIGS
    if config in learning.OFFLINE_CONFIGS:
        md, agent, cfg, ev, eval_env, meta = learning.build_offline(config, 3, "cpu")
        jmd, jagent, jcfg, jev, jeval_env, jmeta = jl._build_offline(config, 3)
        assert meta == jmeta
        assert md.dataset_id == jmd.dataset_id
        assert (md.ref_min, md.ref_max) == (jmd.ref_min, jmd.ref_max)
        assert md.data.obs.shape == np.asarray(jmd.data.obs).shape
        _same_env(eval_env, jeval_env)
        envs = ()
    else:
        env, agent, buf, cfg, ev, meta = learning.build(config, 3, "cpu")
        jenv, jagent, jbuf, jcfg, jev, jmeta = jl._build(config, 3)
        assert meta == jmeta
        _same_buffer(buf, jbuf)
        envs = (env, jenv)
        if isinstance(jenv, str):
            assert env == jenv
        else:
            _same_env(env, jenv)
    assert [f.name for f in dataclasses.fields(jcfg)] == [
        f.name for f in dataclasses.fields(cfg)]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _same_agent(agent, jagent)
    _same_evaluator(ev, jev)
    for e in envs:
        if hasattr(e, "close"):
            e.close()


def test_pendulum_host_needs_gymnasium(monkeypatch):
    """pendulum_host steps Gymnasium's Pendulum as the JAX config does; with
    no gymnasium it raises (the numpy stand-in only when asked for)."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError):
        learning.build("pendulum_host", 0, "cpu")


def test_pendulum_host_on_numpy_pendulum_when_asked(monkeypatch, tmp_path):
    """``pendulum_env="numpy"`` (``--pendulum-env numpy``) builds
    pendulum_host over NumpyPendulum without gymnasium, the config otherwise
    the same, and the artifact's env field names it; the option is
    pendulum_host's only."""
    from border_tpu_torch.envs.py_env import NumpyPendulum

    monkeypatch.setitem(sys.modules, "gymnasium", None)
    env, agent, buf, cfg, ev, meta = learning.build("pendulum_host", 0, "cpu",
                                                    pendulum_env="numpy")
    assert all(isinstance(e, NumpyPendulum) for e in env.envs) and len(env.envs) == 32
    assert cfg == learning.host_config("pendulum_host", "cpu", make_env=lambda n, s: None)[3]
    assert meta["env"] == learning.PENDULUM_ENVS["numpy"][1] != learning.PENDULUM_ENVS[
        "gymnasium"][1]
    env.close()
    calls = []
    monkeypatch.setattr(learning, "run", lambda *a, **k: calls.append((a, k))
                        or learning.GateRun({}, None, None))
    out = str(tmp_path / "p.json")
    assert learning.main(["pendulum_host", "--pendulum-env", "numpy", "--cpu",
                          "--out", out]) == 0
    assert calls == [(("pendulum_host", 0, out),
                      {"max_opts": None, "device": "cpu", "pendulum_env": "numpy"})]
    with pytest.raises(SystemExit):
        learning.main(["pendulum", "--pendulum-env", "numpy"])


# -- the gate -------------------------------------------------------------------
def _bench_gate(art_parent: Path):
    """``bench.py --gate`` over ``art_parent/artifacts`` (bench.py reads the
    directory beside it; the gate path exits before it imports jax)."""
    if art_parent != ROOT:
        shutil.copy(ROOT / "bench.py", art_parent / "bench.py")
    out = subprocess.run([sys.executable, str(art_parent / "bench.py"), "--gate"],
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout.strip().splitlines()[-1]


def _ours(art_dir, capsys):
    rc = learning.gate(str(art_dir))
    return rc, capsys.readouterr().out.strip().splitlines()[-1]


def test_gate_on_the_committed_jax_artifacts_is_bench_gate(capsys):
    rc, line = _ours(ROOT / "artifacts", capsys)
    assert (rc, line) == _bench_gate(ROOT)
    assert rc == 0 and json.loads(line)["value"] == 1


def _artifact(seed, finals, target=18.0):
    d = {"env": "Pong-v0", "target": target, "seed": seed,
         "curve": [{"opt_steps": 2000, "best": 3.0}, {"opt_steps": 4000, "best": 19.5}]}
    if finals is not None:
        d["final_evals"] = finals
    return d


@pytest.mark.parametrize("case", ["two_seeds", "no_final_evals", "one_failing",
                                  "all_pass"])
def test_gate_on_crafted_artifacts_is_bench_gate(case, tmp_path, capsys):
    art = tmp_path / "artifacts"
    art.mkdir()
    seeds = {"two_seeds": [[19.0] * 5, [20.0] * 5],
             "no_final_evals": [[19.0] * 5, None, [20.0] * 5],
             "one_failing": [[19.0] * 5, [17.0, 18.0, 17.5, 17.9, 20.0], [20.0] * 5],
             "all_pass": [[18.0] * 5, [19.0, 21.0, 18.0, 18.0, 17.0], [21.0] * 5]}[case]
    for s, finals in enumerate(seeds):
        Path(learning.artifact_path("pong", s, str(art))).write_text(
            json.dumps(_artifact(s, finals)))
    (art / "cartpole_curve.json").write_text(json.dumps(_artifact(0, [250.0] * 5, 200.0)))
    rc, line = _ours(art, capsys)
    assert (rc, line) == _bench_gate(tmp_path)
    pong = json.loads(line)["results"]["pong"]
    assert pong["status"] == {"two_seeds": "MISSING_SEEDS", "no_final_evals": "FAIL",
                              "one_failing": "FAIL", "all_pass": "pass"}[case]
    assert rc == 1  # the other configs have no seeds


# -- tiny runs through run() ------------------------------------------------------
def _jax_keys(config):
    with open(ROOT / "artifacts" / f"{config}_curve.json") as f:
        d = json.load(f)
    return set(d), set(d["curve"][-1]), set(d["config"])


def _check_artifact(config, out, r, n_points):
    with open(out) as f:
        art = json.load(f)
    assert art == r.artifact
    keys, point_keys, config_keys = _jax_keys(config)
    assert keys <= set(art) and {"device", "duration_sec"} <= set(art)
    assert point_keys <= set(art["curve"][-1])
    assert set(art["config"]) == config_keys
    assert art["device"] == "cpu" and art["seed"] == 1
    assert art["target"] == learning.TARGETS[config]
    finals = art["final_evals"]
    assert len(finals) == learning.N_FINAL_EVALS.get(config, 5)
    assert all(map(math.isfinite, finals))
    assert art["final_median"] == round(float(np.median(finals)), 2)
    # the evaluations, then the certification's point
    assert len(art["curve"]) == n_points + 1
    return art


def test_cartpole_runs_through_run_and_certifies(tmp_path, monkeypatch):
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import Evaluator

    build = learning.build

    def small(config, seed, device):
        env, agent, buf, cfg, ev, meta = build(config, seed, device)
        cfg = cfg.replace(num_envs=8, warmup_period=64, batch_size=32,
                          eval_interval=16)
        buf = ReplayBuffer(capacity=1024, n_step=3, stride=8, device=device)
        return env, agent, buf, cfg, Evaluator(env, 2, 20, device=device), meta

    monkeypatch.setattr(learning, "build", small)
    out = tmp_path / "cartpole_curve_seed1.json"
    r = learning.run("cartpole", 1, str(out), max_opts=48, device="cpu")
    assert r.result.opt_steps == 48 and len(r.result.eval_history) == 3
    art = _check_artifact("cartpole", out, r, 3)
    assert art["config"] == {"max_opts": 48, "num_envs": 8, "batch_size": 32,
                             "opt_interval": 16}


def test_bc_offline_runs_through_run_and_certifies(tmp_path, monkeypatch):
    from border_tpu_torch.data import NormalizedEvaluator

    build = learning.build_offline

    def small(config, seed, device, max_opts):
        md, agent, cfg, ev, eval_env, meta = build(config, seed, device, max_opts)
        ev = NormalizedEvaluator(eval_env, n_episodes=4, max_steps=10,
                                 ref_min=md.ref_min, ref_max=md.ref_max,
                                 device=device)
        return md, agent, cfg.replace(eval_interval=10), ev, eval_env, meta

    monkeypatch.setattr(learning, "build_offline", small)
    monkeypatch.setattr(learning, "OFFLINE_UPDATES_PER_CHUNK", 10)
    out = tmp_path / "bc_offline_curve_seed1.json"
    r = learning.run("bc_offline", 1, str(out), max_opts=20, device="cpu")
    assert r.result.opt_steps == 20
    # the cosine horizon is the run's own max_opts
    assert lr_at(r.trainer.agent.config.lr, 20) == 0.0
    art = _check_artifact("bc_offline", out, r, 2)
    assert art["config"] == {"max_opts": 20, "batch_size": 256}
    assert art["dataset"] == "fetch-reacher-medium-v0"


def test_certification_scores_the_best_checkpoint_on_the_fresh_indices(
        tmp_path, monkeypatch):
    """The in-training evaluations take indices 0, 1, ...; the certification
    reloads the best checkpoint and scores it on the JAX harness's fresh
    indices, ``10_000 + 7 i`` for ``N_FINAL_EVALS`` (10 for bc_offline),
    and ``final_evals`` are those scores."""
    from border_tpu_torch.data import NormalizedEvaluator, normalized_score

    source = (ROOT / "benchmarks" / "learning.py").read_text()
    assert source.count("eval_index=10_000 + 7 * i") == 2
    build = learning.build_offline
    seen, refs = [], []

    def small(config, seed, device, max_opts):
        md, agent, cfg, ev, eval_env, meta = build(config, seed, device, max_opts)
        refs.extend((md.ref_min, md.ref_max))
        ev = NormalizedEvaluator(eval_env, n_episodes=4, max_steps=10,
                                 ref_min=md.ref_min, ref_max=md.ref_max,
                                 device=device)
        evaluate = ev.evaluate

        def recording(agent, agent_state, eval_index=0):
            out = evaluate(agent, agent_state, eval_index=eval_index)
            seen.append((eval_index, out[0]))
            return out

        ev.evaluate = recording
        return md, agent, cfg.replace(eval_interval=10), ev, eval_env, meta

    monkeypatch.setattr(learning, "build_offline", small)
    monkeypatch.setattr(learning, "OFFLINE_UPDATES_PER_CHUNK", 10)
    r = learning.run("bc_offline", 0, str(tmp_path / "bc.json"), max_opts=20,
                     device="cpu")
    fresh = [10_000 + 7 * i for i in range(learning.N_FINAL_EVALS["bc_offline"])]
    assert [i for i, _ in seen] == [0, 1] + fresh
    assert r.artifact["final_evals"] == [
        round(float(normalized_score(s, *refs)), 2) for _, s in seen[2:]]


def test_main_writes_the_gate_named_artifact_and_gates(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(learning, "ARTIFACTS", str(tmp_path))
    calls = []
    monkeypatch.setattr(learning, "run", lambda *a, **k: calls.append((a, k))
                        or learning.GateRun({"seed": a[1]}, None, None))
    assert learning.main(["pong", "--seed", "2", "--max-opts", "40000", "--cpu"]) == 0
    assert calls == [(("pong", 2, str(tmp_path / "pong_curve_seed2.json")),
                      {"max_opts": 40_000, "device": "cpu"})]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"seed": 2}
    assert learning.main(["gate"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["results"]["pong"] == {"status": "MISSING_SEEDS", "seeds": 0,
                                       "seeds_required": 3}


# -- the IQL corpus without h5py ------------------------------------------------------
def test_converted_iql_corpus_equals_the_hdf5_load():
    pytest.importorskip("h5py")
    from border_tpu_torch.data import GoalDictConverter, MinariDataset

    conv = GoalDictConverter(keys=learning.OFFLINE_KEYS)
    npz = MinariDataset.load_local(learning.IQL_CORPUS, learning.IQL_CORPUS_DIR, conv)
    h5 = MinariDataset._from_minari_hdf5(
        learning.IQL_CORPUS, str(ROOT / "artifacts" / "datasets" / "minari_format"
                                 / learning.IQL_CORPUS / "data" / "main_data.hdf5"),
        conv)
    for f in dataclasses.fields(npz.data):
        a, b = getattr(npz.data, f.name), getattr(h5.data, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert len(npz.data) == 25_000 and npz.data.obs.shape == (25_000, 8)
    assert (npz.ref_min, npz.ref_max, npz.behavior_return, npz.env_name) == (
        h5.ref_min, h5.ref_max, h5.behavior_return, h5.env_name)
    # the JAX loader never sees it: not under artifacts/datasets/ itself
    assert not (ROOT / "artifacts" / "datasets" / f"{learning.IQL_CORPUS}.npz").exists()


def test_hdf5_to_local_writes_the_corpus_layout(tmp_path):
    pytest.importorskip("h5py")
    from border_tpu_torch.data.minari import hdf5_to_local

    src = (ROOT / "artifacts" / "datasets" / "minari_format" / learning.IQL_CORPUS
           / "data" / "main_data.hdf5")
    out = hdf5_to_local(str(src), str(tmp_path))
    assert out == str(tmp_path / f"{learning.IQL_CORPUS}.npz")
    with np.load(out) as ours, np.load(Path(learning.IQL_CORPUS_DIR)
                                       / f"{learning.IQL_CORPUS}.npz") as committed:
        assert sorted(ours.files) == sorted(committed.files)
        assert all(np.array_equal(ours[k], committed[k]) for k in ours.files)
    with open(tmp_path / f"{learning.IQL_CORPUS}.json") as f:
        meta = json.load(f)
    assert {k: meta[k] for k in ("dataset_id", "env", "n_transitions")} == {
        "dataset_id": learning.IQL_CORPUS, "env": "ReacherGoal-v0",
        "n_transitions": 25_000}
