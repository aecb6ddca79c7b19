"""The port's ShardedTrainer and ShardedAsyncTrainer (≙ border_tpu/parallel/
sharded.py, async_sharded.py) on gloo process groups on the CPU, the
counterparts of ``test_sharded.py``, ``test_sharded_pixel.py`` and
``test_async_trainer.py``'s sharded cases.

- a world of one rank (in this process) equals the plain Trainer bitwise,
  one env chunk and one update chunk from identical states and generators,
  on the flat and the frame buffer, and ShardedAsyncTrainer equals
  AsyncTrainer so;
- two spawned ranks (``tests/helpers/torch_dist_worker.py``, one launch
  for the module, a timeout so a deadlock fails instead of hanging): every
  agent family trains with its parameters bitwise equal across the ranks,
  the frame ring's env axis is partitioned, the summed fill drives the
  warmup, and the loop generator's draws differ across the ranks;
- the ``sharded_dqn`` example through ``main(argv)`` at a tiny size.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.parallel import ShardedAsyncTrainer, ShardedTrainer, make_mesh
from border_tpu_torch.replay import FrameReplayBuffer, ReplayBuffer
from border_tpu_torch.train import AsyncTrainer, Trainer, TrainerConfig
from border_tpu_torch.utils.checkpoint import pack_state

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dist_worker as W  # noqa: E402

WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_same(a, b):
    a, b = dict(_leaves(pack_state(a))), dict(_leaves(pack_state(b)))
    assert a.keys() == b.keys()
    for k in a:
        same = torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]
        assert same, k


def _pair(kind, plain_cls, sharded_cls):
    if kind == "frame":
        env = make("Pong-v0")
        agent = lambda: DQN(DQNConfig(  # noqa: E731
            model=lambda n: AtariCNN(n, dtype=torch.float32), lr=1e-4))
        buffer = lambda: FrameReplayBuffer(32, 4, device="cpu")  # noqa: E731
        cfg = TrainerConfig(num_envs=4, steps_per_chunk=8, batch_size=4,
                            opt_interval=8, warmup_period=0, sync_interval=2)
    else:
        env = make("CartPole-v1")
        agent = lambda: DQN(DQNConfig(hidden=(16,), max_grad_norm=1.0))  # noqa: E731
        buffer = lambda: ReplayBuffer(128, device="cpu")  # noqa: E731
        cfg = TrainerConfig(num_envs=4, steps_per_chunk=8, batch_size=8,
                            opt_interval=4, warmup_period=0, sync_interval=2)
    plain = plain_cls(env, agent(), buffer(), cfg, device="cpu")
    sharded = sharded_cls(env, agent(), buffer(), cfg, mesh=make_mesh(),
                          device="cpu")
    return plain, sharded


@pytest.mark.parametrize("kind, classes", [
    ("flat", (Trainer, ShardedTrainer)),
    ("frame", (Trainer, ShardedTrainer)),
    ("flat", (AsyncTrainer, ShardedAsyncTrainer)),
])
def test_world_of_one_equals_the_trainer_bitwise(world_of_one, kind, classes):
    plain, sharded = _pair(kind, *classes)
    assert sharded.local_envs == 4 and sharded.local_batch == plain.config.batch_size
    agent_state, vec_state, buf_state = plain.init_states(0, 1)
    states = {"plain": (agent_state, vec_state, buf_state),
              "sharded": (copy.deepcopy(agent_state), sharded.vec.reset(1),
                          copy.deepcopy(buf_state))}
    out = {}
    for name, tr in (("plain", plain), ("sharded", sharded)):
        a, v, b = states[name]
        gen = torch.Generator().manual_seed(7)
        ep = []
        for warmed in (False, True):  # an env chunk, then one with updates
            a, v, b, metrics, ep_ret, ep_cnt = tr._dispatch(a, v, b, gen, warmed)
            ep.append((ep_ret, ep_cnt))
        out[name] = a, v, b, metrics, ep
    (pa, pv, pb, pm, pep), (sa, sv, sb, sm, sep) = out["plain"], out["sharded"]
    assert pa.n_opts == sa.n_opts == plain.updates_per_chunk
    _assert_same(pa, sa)
    _assert_same(pb, sb)
    assert torch.equal(pv.obs, sv.obs)
    for k in pm:
        assert torch.equal(torch.as_tensor(pm[k]), torch.as_tensor(sm[k])), k
    for (r0, c0), (r1, c1) in zip(pep, sep):
        assert torch.equal(r0, r1) and torch.equal(c0, c1)


def test_config_must_divide_the_axis(world_of_one):
    env = make("CartPole-v1")
    cfg = TrainerConfig(num_envs=4, batch_size=8)
    tr = ShardedTrainer(env, DQN(), ReplayBuffer(64, device="cpu"), cfg,
                        device="cpu")
    assert tr.n_dev == 1 and tr.agent.axis_group is tr.group
    with pytest.raises(ValueError, match="buffer.num_envs"):
        ShardedTrainer(make("Pong-v0"), DQN(), FrameReplayBuffer(8, 2, device="cpu"),
                       cfg, device="cpu")


# -- two ranks -------------------------------------------------------------------

TRAIN_KINDS = ["dqn_per", "sac", "iqn", "awac", "iql", "bc", "pong"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    tasks = [["chunk_dqn", "sharded_chunk", {"kind": "dqn"}],
             ["chunk_pong", "sharded_chunk",
              {"kind": "pong", "cfg": {"steps_per_chunk": 8}}],
             *[[f"train_{k}", "sharded_train",
                {"kind": k, "cfg": {"steps_per_chunk": 8} if k == "pong" else {}}]
               for k in TRAIN_KINDS],
             ["async_dqn", "sharded_train",
              {"kind": "dqn", "async": True, "cfg": {"max_opts": 8}}],
             ["async_pong", "sharded_train",
              {"kind": "pong", "async": True,
               "cfg": {"max_opts": 2, "steps_per_chunk": 8}}],
             ["warmup", "sharded_train",
              {"kind": "dqn", "cfg": {"warmup_period": 12}}]]
    W.launch(tmp, WORLD, tasks, timeout=300)
    return lambda task_id: W.results(tmp, task_id, WORLD)


def _params_equal_across_ranks(ranks):
    keys = [k for k in ranks[0] if "/" in k or k == "log_alpha"]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_sharded_chunk_runs_and_params_replicated(two_ranks):
    ranks = two_ranks("chunk_dqn")
    _params_equal_across_ranks(ranks)
    for r in ranks:
        assert int(r["n_opts"]) > 0 and np.isfinite(float(r["loss"]))
        assert all(np.isfinite(v).all() for k, v in r.items() if "/" in k)
        # each rank's ring got steps_per_chunk x local_envs transitions
        assert int(r["local_envs"]) == 2 and int(r["size"]) == 4 * 2
        assert int(r["fill_sum"]) == WORLD * int(r["size"])
    # the env shards reset from per-rank seeds
    assert not np.array_equal(ranks[0]["obs0"], ranks[1]["obs0"])


def test_sharded_pixel_dqn_frame_buffer(two_ranks):
    """AtariCNN + frame-dedup replay: the ring's env axis is partitioned,
    the shards fill, the warmup reads the fill summed over the shards."""
    ranks = two_ranks("chunk_pong")
    _params_equal_across_ranks(ranks)
    for r in ranks:
        assert int(r["buffer_num_envs"]) == int(r["local_envs"]) == 2
        assert tuple(r["frames_shape"]) == (2, 32, 84, 84)
        assert int(r["total"]) == 8 and int(r["n_opts"]) > 0
        assert int(r["fill_sum"]) == WORLD * 2 * (8 - 4 - 1)


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_sharded_train_keeps_parameters_replicated(two_ranks, kind):
    ranks = two_ranks(f"train_{kind}")
    _params_equal_across_ranks(ranks)
    want = 2 if kind == "pong" else 4
    assert all(int(r["opt_steps"]) >= want and int(r["env_steps"]) > 0
               for r in ranks)


@pytest.mark.parametrize("kind", ["dqn", "pong"])
def test_sharded_async_trainer(two_ranks, kind):
    ranks = two_ranks(f"async_{kind}")
    _params_equal_across_ranks(ranks)
    assert int(ranks[0]["opt_steps"]) >= (2 if kind == "pong" else 8)


def test_summed_fill_drives_the_warmup(two_ranks):
    """4 envs, 2 a rank, 4 steps a chunk, warmup 12: the shards hold 8
    each after the first chunk, 16 together, so the second chunk updates
    (a rank's own fill would wait a chunk more: 64 env steps, not 48)."""
    ranks = two_ranks("warmup")
    assert [int(r["env_steps"]) for r in ranks] == [48, 48]
    assert [int(r["opt_steps"]) for r in ranks] == [4, 4]


def test_sharded_update_noise_distinct_across_ranks(two_ranks):
    """The loop generator, which SAC's update draws its noise from, is
    seeded per rank: its draws differ across the ranks."""
    ranks = two_ranks("chunk_dqn")
    rows = {tuple(r["noise"].ravel()) for r in ranks}
    assert len(rows) == WORLD


# -- the example -----------------------------------------------------------------

def test_sharded_dqn_example_main(capsys):
    from border_tpu_torch.examples import sharded_dqn

    res = sharded_dqn.main(["--max-opts", "8", "--envs-per-device", "4",
                            "--device", "cpu"])
    assert res.opt_steps == 8 and res.env_steps == 9 * 4 * 32
    assert not dist.is_initialized()  # main leaves no group behind
    assert capsys.readouterr().out.startswith("devices=1  samples/s=")
