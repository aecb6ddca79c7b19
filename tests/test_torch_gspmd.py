"""The port's GSPMDTrainer (≙ border_tpu/parallel/gspmd.py) on four spawned
gloo ranks on the CPU, the counterparts of ``test_gspmd.py`` and
``test_gspmd_hlo.py``.

- numerics: a 2×2 (dp×tp) run, a 4×1 and a 1×4 one (the last with global
  norm clipping across the model group) on CartPole, a 2×2 one on a
  prioritized flat ring and a 2×2 Pong one on a prioritized frame ring
  (the float32 AtariCNN, SGD) end at the unsharded Trainer's parameters,
  to rtol 1e-4 / atol 1e-5 (the order of reductions differs);
- partitioning: each rank holds ``out/tp`` rows of every sharded weight and
  of its Adam moments, ``num_envs/dp`` env rows and, on the pixel path,
  ``num_envs/dp`` columns of the frame ring; one update's collectives,
  counted per group: the gathers of the column-parallel forwards and the
  input-gradient sums of their backward ride ``model``, the gradient mean
  and the metrics ``actors``.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.parallel import GSPMDTrainer, make_dp_tp_mesh, make_mesh
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import ReplayBuffer
from border_tpu_torch.train import Trainer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dist_worker as W  # noqa: E402

WORLD = 4
# (mesh, case of torch_dist_worker.gspmd_case, agent settings)
RUNS = {"2x2": ([2, 2], "cartpole", {}), "4x1": ([4, 1], "cartpole", {}),
        "1x4": ([1, 4], "cartpole", {"max_grad_norm": 0.5}),
        "2x2_per": ([2, 2], "cartpole_per", {}),
        "2x2_pixel_per": ([2, 2], "pong_per", {})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd")
    tasks = [*[[f"train_{k}", "gspmd_train", {"mesh": m, "kind": c, "agent": a}]
               for k, (m, c, a) in RUNS.items()],
             ["parts", "gspmd_parts", {}],
             ["parts_pixel", "gspmd_parts", {"pixel": True}]]
    W.launch(tmp, WORLD, tasks, timeout=300)
    return lambda task_id: W.results(tmp, task_id, WORLD)


@pytest.mark.parametrize("run", list(RUNS))
def test_gspmd_matches_unsharded_numerics(four_ranks, run):
    """Same seeds: the dp×tp-partitioned run computes the unsharded
    Trainer's training trajectory, up to reduction order (with PER the
    replicated tree is fed the TD errors gathered over ``actors``)."""
    _, kind, agent_kw = RUNS[run]
    env, agent, buffer, cfg = W.gspmd_case(kind, **agent_kw)
    plain = Trainer(env, agent, buffer, cfg, device="cpu").train()
    ranks = four_ranks(f"train_{run}")
    for r in ranks:
        assert int(r["opt_steps"]) == plain.opt_steps == cfg.max_opts
        for k, v in plain.agent_state.params.state_dict().items():
            np.testing.assert_allclose(r[f"full/{k}"], v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    init = agent.init(cfg.seed, env.observation_space(None),
                      env.action_space(None), device="cpu")
    step = max((p.detach() - plain.agent_state.params.state_dict()[k]).abs().max()
               for k, p in init.params.state_dict().items())
    assert step > 10 * 1e-5  # the runs moved well beyond the tolerance


def test_gspmd_states_are_sharded(four_ranks):
    ranks = four_ranks("parts")
    tp, dp = 2, 2
    full = {"layers.0.weight": (32, 4), "layers.0.bias": (32,),
            "layers.1.weight": (32, 32), "layers.1.bias": (32,),
            "out.weight": (2, 32), "out.bias": (2,)}
    for r in ranks:
        for k, shape in full.items():
            sharded = k.endswith("weight")
            assert bool(r[f"sharded/{k}"]) == sharded, k
            want = (shape[0] // tp, *shape[1:]) if sharded else shape
            assert tuple(r[f"shape/{k}"]) == want, k
        # the Adam moments follow their parameters
        assert [tuple(r[f"adam/{i}"]) for i in range(6)] == [
            tuple(r[f"shape/{k}"]) for k in full]
        assert int(r["env_rows"]) == 8 // dp
        assert np.isfinite(float(r["loss"]))


def test_gspmd_collectives_per_group(four_ranks):
    """One DQN update on the 2×2 mesh: the two forwards (target on
    next_obs, online on obs) gather each of the 3 column-parallel layers
    over ``model`` and the backward sums the input gradients of the 2
    layers after the first there (8); over ``actors`` the gradient mean
    and the metrics' mean (2).  The flat ring is replicated, so sampling
    talks to no group."""
    for r in four_ranks("parts"):
        assert int(r["count/model"]) == 2 * 3 + 2
        assert int(r["count/actors"]) == 2


def test_gspmd_pixel_frame_ring_sharded(four_ranks):
    """The frame ring's env axis is sharded over ``actors``; the AtariCNN's
    five layers are column-parallel; the chunk runs with a finite loss.
    One update: 2 forwards × 5 gathers and 4 input-gradient sums over
    ``model``; over ``actors`` the batch assembled from the ring's shards
    (obs, next_obs, act, reward, terminated, truncated), the gradient mean
    and the metrics' mean."""
    for r in four_ranks("parts_pixel"):
        assert tuple(r["frames_shape"]) == (4, 16, 84, 84)
        assert int(r["total"]) == 4 and int(r["env_rows"]) == 4
        assert np.isfinite(float(r["loss"]))
        assert tuple(r["shape/conv0.weight"]) == (16, 4, 8, 8)
        assert tuple(r["shape/fc0.weight"]) == (256, 3136)
        assert tuple(r["shape/fc1.weight"]) == (3, 512)
        assert tuple(r["shape/fc0.bias"]) == (512,)
        assert int(r["count/model"]) == 2 * 5 + 4
        assert int(r["count/actors"]) == 6 + 2


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_gspmd_mesh_and_config_checks(world_of_one, tmp_path):
    with pytest.raises(ValueError, match="dp×tp = 2 != 1 devices"):
        make_dp_tp_mesh(1, 2)
    env, cfg = make("CartPole-v1"), W._gspmd_cfg()
    with pytest.raises(ValueError, match="'actors','model'"):
        GSPMDTrainer(env, DQN(), ReplayBuffer(64, device="cpu"), cfg,
                     mesh=make_mesh(), device="cpu")
    with pytest.raises(ValueError, match="saves no models"):
        GSPMDTrainer(env, DQN(), ReplayBuffer(64, device="cpu"), cfg,
                     recorder=BufferedRecorder(model_dir=str(tmp_path)),
                     device="cpu")
    tr = GSPMDTrainer(env, DQN(), ReplayBuffer(64, device="cpu"), cfg,
                      device="cpu")
    assert (tr.dp, tr.tp) == (1, 1) and tr.agent.axis_group is tr.actors_group
