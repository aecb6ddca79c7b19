"""The check that decides ``correct``, driven on the CPU at a small size:
each cell's path as its run drives it (set-up's two chunks through the
trainer's chunk, then the comparison with the plain reference), and the
same with the timed path broken underneath, which must come out not
correct, as must the control (the reference one precision step below
the configuration's) in the program's place.

Card-only: a whole run of a cell, window and trace included."""

import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.reference import checks

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 4242  # above 32 signed bits, as the driver's are
CPU = torch.device("cpu")


def small(cell: str) -> dict:
    """The cell's files at the size a CPU test holds, as the check of its
    driver cuts it (every width as published)."""
    f = run.cell_files(cell)
    checks.find(f["cfg"]).small(f["cfg"], f["wl"])
    return f


def readings(f: dict, controls: bool = False) -> dict:
    torch.manual_seed(0)
    drv = run.build(f, SEED, CPU)
    obs = drv.observations()
    target_mismatch = drv.target_check()
    drv.free()
    out = checks.find(f["cfg"]).numbers(obs, f["cfg"], f["wl"], SEED, CPU,
                                        controls=controls)
    out["target_mismatch"] = target_mismatch
    return out


@functools.lru_cache(maxsize=None)
def sound(cell: str) -> dict:
    torch.set_num_threads(2)
    return readings(small(cell), controls=True)


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_path_is_correct(cell):
    got = sound(cell)
    checks, failed = run.verdict(got, run.cell_files(cell)["limits"])
    assert not failed, checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The update's own numbers catch the control, not only the acting."""
    got = sound(cell)
    control = {k.split(".", 1)[1]: v for k, v in got.items() if k.startswith("control.")}
    control.update(env_mismatch=0, sample_mismatch=0, target_mismatch=0)
    _, failed = run.verdict(control, run.cell_files(cell)["limits"])
    assert "grad_flip" in failed, control


def test_a_kind_joins_by_new_files_alone(tmp_path):
    """A copy of the benchmark takes a new agent kind (DQN's builder and
    reference under another name), a configuration that names it and a
    cell for it as new files and new entries of ``BENCHMARK.json``, no file
    that was there edited; the copied harness runs the cell and reads what
    the cell it copies reads."""
    import os
    import shutil

    base_cell, kind, config = "dqn-pong.replay8", "twin", "twin-pong"
    here, copy = ROOT / "portbench", tmp_path / "portbench"
    shutil.copytree(here, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = {w["name"]: w for w in bench["workloads"]}[base_cell]
    entry = {c["name"]: c for c in bench["configs"]}[base["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    base_kind = cfg["agent"]["kind"]
    cfg["name"], cfg["agent"]["kind"] = config, kind
    new = {
        f"agents/{kind}.py": (here / "agents" / f"{base_kind}.py").read_text(),
        f"reference/kinds/{kind}.py":
            (here / "reference" / "kinds" / f"{base_kind}.py").read_text(),
        f"configs/{config}.json": json.dumps(cfg),
        f"flops/{config}.py": (here / "flops" / f"{base['config']}.py").read_text(),
        f"limits/{config}.replay8.json": (here / "limits" / f"{base_cell}.json").read_text(),
    }
    for rel, text in new.items():
        assert not (copy / rel).exists(), rel
        (copy / rel).write_text(text)
    bench["configs"].append(dict(entry, name=config, file=f"portbench/configs/{config}.json"))
    bench["workloads"].append(dict(base, name=f"{config}.replay8", config=config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, portbench; from portbench.tests import test_portbench_check as t; "
            f"assert portbench.__file__.startswith({str(copy)!r}), portbench.__file__; "
            f"print(json.dumps(t.sound({config + '.replay8'!r})))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == sound(base_cell)
    assert all(p.read_bytes() == b for p, b in before.items())


def _fails(cell: str, patch) -> list:
    with patch:
        got = readings(small(cell))
    checks, failed = run.verdict(got, run.cell_files(cell)["limits"])
    return failed


@pytest.mark.parametrize("cell", ["dqn-pong.replay8", "iqn-seaquest.replay8"])
@pytest.mark.parametrize("sound_steps", [0, 3])
def test_a_step_that_leaves_the_state_unchanged(cell, sound_steps, monkeypatch):
    """Every step, or those after the graph's eager warm-up (replays on
    the card), leave the parameters and the optimizer's state as they were."""
    real, calls = torch.optim.Adam.step, []

    def step(self, closure=None):
        calls.append(1)
        return real(self, closure) if len(calls) <= sound_steps else None

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    assert "change_gap" in _fails(cell, _nothing())


@pytest.mark.parametrize("cell", ["dqn-pong.replay8", "iqn-seaquest.replay8"])
@pytest.mark.parametrize("fault", ["never", "every update"])
def test_a_target_copy_at_the_wrong_updates(cell, fault, monkeypatch):
    from border_tpu_torch.agents import common

    kind = run.cell_files(cell)["cfg"]["agent"]["kind"]
    agent = __import__(f"border_tpu_torch.agents.{kind}", fromlist=["x"])

    def polyak(n_opts, interval, tau, online, target):
        if fault == "every update":
            common.polyak_update(tau, online, target)

    monkeypatch.setattr(agent, "periodic_polyak", polyak)
    assert "target_mismatch" in _fails(cell, _nothing())


def _half(loss_fn):
    """A per-sample loss whose second half is replaced by its first: the
    batch's mean is then the mean over half of it."""
    def half(*a, **kw):
        per = loss_fn(*a, **kw)
        h = per.shape[0] // 2
        return torch.cat([per[:h], per[:h]] + ([per[h:h + 1]] if per.shape[0] % 2 else []))
    return half


def test_half_the_batch_left_out_dqn(monkeypatch):
    from border_tpu_torch.agents import dqn
    monkeypatch.setitem(dqn.CRITIC_LOSSES, "smooth_l1", _half(dqn.CRITIC_LOSSES["smooth_l1"]))
    assert _fails("dqn-pong.replay8", _nothing())


def test_half_the_batch_left_out_iqn(monkeypatch):
    from border_tpu_torch.agents import iqn
    monkeypatch.setattr(iqn, "quantile_huber_loss", _half(iqn.quantile_huber_loss))
    assert _fails("iqn-seaquest.replay8", _nothing())


@pytest.mark.parametrize("cell", ["dqn-pong.replay8", "iqn-seaquest.replay8"])
def test_a_frame_altered_where_the_env_makes_it(cell, monkeypatch):
    from border_tpu_torch.envs import pixel

    real = pixel.PixelEnv.step_env

    def step_env(self, gen, state, action, params):
        obs, st, *rest = real(self, gen, state, action, params)
        st.frames[0, 0, 0, -1] ^= 1
        return (st.frames, st, *rest)

    monkeypatch.setattr(pixel.PixelEnv, "step_env", step_env)
    assert "env_mismatch" in _fails(cell, _nothing())


@pytest.mark.parametrize("cell", ["dqn-pong.replay8", "dqn-pong.per"])
def test_a_stack_altered_where_the_gather_makes_it(cell, monkeypatch):
    from border_tpu_torch.replay import frame_buffer

    real = frame_buffer.gather_frames

    def gather(frames, idx):
        out = real(frames, idx).clone()
        out[0, 0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(frame_buffer, "gather_frames", gather)
    assert "sample_mismatch" in _fails(cell, _nothing())


def _nothing():
    import contextlib
    return contextlib.nullcontext()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's trainer runs its graphs and "
                    "the gather kernel there")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_whole_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed",
         str(SEED), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
