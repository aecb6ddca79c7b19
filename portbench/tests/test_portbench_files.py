"""The benchmark's data: BENCHMARK.json, every configuration, traffic and
limits file, each part of a cell found by its name (and named nowhere
else), the FLOP and byte counts."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from portbench.reference import checks, games, kinds

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [json.loads((ROOT / c["file"]).read_text()) for c in BENCH["configs"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["moves"] == "env_steps_per_s" for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    c = cfg(w["config"])
    assert c["name"] == w["config"]
    json.loads((HERE / "workloads" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert {"env_mismatch", "sample_mismatch"} <= set(limits)
    assert limits["env_mismatch"] == 0 and limits["sample_mismatch"] == 0
    assert (HERE / "drivers" / f"{c['driver']}.py").exists()
    assert (HERE / "agents" / f"{c['agent']['kind']}.py").exists()
    load(HERE / "flops" / f"{w['config']}.py")
    kind = kinds.find(c)
    assert all(callable(getattr(kind, f)) for f in ("shapes", "greedy", "loss_draws", "loss"))
    check = checks.find(c)
    assert callable(check.numbers) and callable(check.small)
    if getattr(check, "games", None) is games:  # a check that plays reference/games
        assert games.find(c["env"])().n_actions == c["n_actions"]
    assert w["chips"] == 1


def _spoken(name: str) -> str:
    """How a source names a kind, a driver or an env id (a game by its
    name, without the version)."""
    return name.split("-v")[0].lower()


# every agent kind, game and driver of a configuration
FOUND_BY_NAME = sorted({x for c in CONFIGS for x in (c["agent"]["kind"], c["env"], c["driver"])})


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_only_the_files_found_by_a_name_say_it(path):
    """A source names an agent kind, a game or a driver only where it is
    found by that name (``agents/<kind>.py``, ``reference/kinds/<kind>.py``,
    ``drivers/<driver>.py``, ``reference/checks/<driver>.py``,
    ``reference/games/<env>.py``), or by the name of a configuration that
    has it (``flops/<config>.py``): the harness, the weights and the shared
    reference name none, so a configuration joins by new files alone."""
    allowed = {path.stem}
    for c in CONFIGS:
        if c["name"] == path.stem:
            allowed |= {c["agent"]["kind"], c["env"], c["driver"]}
    text = path.read_text().lower()
    said = [n for n in FOUND_BY_NAME if n not in allowed and _spoken(n) in text]
    assert not said, said


def test_the_names_found_by_name():
    assert {"dqn", "iqn", "Pong-v0", "Seaquest-v0", "fused_trainer"} <= set(FOUND_BY_NAME)
    shared = [HERE / p for p in ("run.py", "calibrate.py", "weights.py", "reference/nets.py",
                                 "reference/update.py", "reference/precision.py",
                                 "reference/games/__init__.py", "reference/kinds/__init__.py",
                                 "reference/checks/__init__.py")]
    assert set(shared) <= set(SOURCES)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(load(HERE / "metrics" / f"{metric}.py").read)


def test_config_files_name_their_source():
    for entry in BENCH["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        assert c["source"] == entry["source"] and c["reduced"] == entry["reduced"]
        if "torso" in c:  # the Nature torso over a 2^20-frame ring
            assert c["torso"]["conv"] == [[32, 8, 4], [64, 4, 2], [64, 3, 1]]
            assert c["torso"]["fc"] == 512
            r = c["replay"]
            assert r["num_envs"] * r["capacity_per_env"] == 2 ** 20
        widths = ("conv", "fc", "feature_dim", "n_cos", "hidden")
        assert not set(c["reduced"]) & set(widths)
        assert set(c["reduced"]) <= set(c)
        assert all(f"{k}:" in c["assumed"]["reduced"] for k in c["reduced"])


def test_nature_dqn_forward_macs():
    m = load(HERE / "flops" / "dqn-nature-pong.py")
    pong = cfg("dqn-nature-pong")
    # conv0 20·20·32·8·8·4 + conv1 9·9·64·4·4·32 + conv2 7·7·64·3·3·64
    # + fc0 3136·512 + fc1 512·6
    assert m.forward_macs(pong) == 3_276_800 + 2_654_208 + 1_806_336 + 1_605_632 + 3_072
    assert m.forward_macs(pong) == 9_346_048
    # an update: online forward and backward (no input gradient for conv0),
    # double DQN's online forward and the target forward on next_obs
    assert m.update_macs(pong) == 512 * (5 * 9_346_048 - 3_276_800)
    assert m.chunk_flops(pong, 512) == 2 * (32 * 1024 * 9_346_048
                                            + 512 * m.update_macs(pong))


def test_iqn_update_macs():
    m = load(HERE / "flops" / "iqn-seaquest.py")
    sq = cfg("iqn-seaquest")
    psi = 9_346_048 - 3_072 + 512 * 512
    per_fraction = 64 * 512 + 512 * 512 + 512 * 6
    assert m.forward_macs(sq, 32) == psi + 32 * per_fraction
    # N = N' = 64 fractions for the prediction and the target, K = 32 acting
    online = psi + 64 * per_fraction
    backward = 2 * online - 3_276_800 - 64 * 64 * 512
    # the target's ψ(next_obs) once, at the 32 acting and 64 target fractions
    target = psi + 96 * per_fraction
    assert m.update_macs(sq) == 256 * (online + backward + target)


def test_gather_bytes():
    m = load(HERE / "metrics" / "frame_gather_roofline.py")
    assert m.gather_bytes(512, 5, 84 * 84) == 36_136_960
    assert m.gather_bytes(256, 5, 84 * 84) == 18_068_480


def test_metric_readers_read_nothing_from_nothing():
    ctx = {"events": {}, "chunk_trace": {}, "env_trace": {}}
    for name in ("device_idle_frac", "env_step_ms", "update_ms",
                 "launches_per_update", "frame_gather_roofline"):
        assert load(HERE / "metrics" / f"{name}.py").read(dict(ctx)) is None, name


def test_run_budget_fits_the_full_benchmark():
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    """Without the program beside it (or without a card) a run exits with
    another code than 0 and prints nothing on standard output."""
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", BENCH["workloads"][0]["name"],
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
