"""The port's ``TacEx-Grasp-Lift-Uipc-v0`` and ``-Uipc-Depth-v0`` (a 16x16
compression image embedded in each pad's inner face) against the JAX
package: the registry (all 17 ids, the new ones with the JAX cfg defaults),
one step of each id from a carried-over pressed state at 2 envs with
``_torch_coupled``'s tolerances (the images in mm within 1e3 x the gel's),
and the masked reset of a dropped cube. The two ids share one jitted JAX
coupled solve.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_bins import setup_torch
from _torch_coupled import COMP_ATOL, N, check_obs, check_step, one_step, port_state
from tacex_tpu.envs.base import _REGISTRY as registry_j
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.base import _REGISTRY as registry_t
from tacex_tpu_torch.envs.grasp_lift.env import GraspLiftState

setup_torch()

ENV_ID = "TacEx-Grasp-Lift-Uipc-v0"
DEPTH_ID = "TacEx-Grasp-Lift-Uipc-Depth-v0"
COUPLED_IDS = [
    ENV_ID,
    "TacEx-Grasp-Lift-Uipc-Depth-v0",
    "TacEx-Grasp-Lift-Uipc-Tactile-v0",
    "TacEx-Factory-PegInsert-Uipc-v0",
    "TacEx-Factory-PegInsert-Uipc-Depth-v0",
]


def test_every_jax_id_is_registered():
    assert sorted(registry_t) == sorted(registry_j) and len(registry_t) == 17


@pytest.mark.parametrize("env_id", COUPLED_IDS)
def test_coupled_ids_registered_with_the_jax_defaults(env_id):
    cfg_t, cfg_j = registry_t[env_id][1](), registry_j[env_id][1]()
    fields_t = {f.name for f in dataclasses.fields(cfg_t)}
    assert fields_t == {f.name for f in dataclasses.fields(cfg_j)}
    for name in sorted(fields_t):
        assert getattr(cfg_t, name) == getattr(cfg_j, name), name
    assert cfg_t.max_episode_length == cfg_j.max_episode_length


@pytest.fixture(scope="module")
def stepped():
    return one_step(ENV_ID)


def test_state_carries_over(stepped):
    _, env_t, _, _, st_j = stepped
    st_t = port_state(env_t, st_j)
    assert isinstance(st_t, GraspLiftState)
    np.testing.assert_array_equal(st_t.gel.x.numpy(), np.asarray(st_j.gel.x))
    np.testing.assert_array_equal(st_t.cube.q.numpy(), np.asarray(st_j.cube.q))
    assert st_t.episode_length.dtype == torch.int32 and st_t.sensor.traj_count.shape == (2 * N,)


def test_one_step_matches_jax(stepped):
    check_step(stepped, "cube")
    check_obs(stepped)
    _, _, out_j, out_t, _ = stepped
    np.testing.assert_allclose(out_t[5]["cube_z"].numpy(), np.asarray(out_j[5]["cube_z"]), atol=1e-5, rtol=0)
    assert out_t[1]["proprio_obs"].shape == (N, 12)


def test_dropped_cube_terminates_and_resets(stepped):
    """A cube below ``drop_z`` ends its episode; the masked reset puts it back
    near the start and zeroes the env's bookkeeping, and leaves the other env."""
    _, env_t, out_j, _, _ = stepped
    st = port_state(env_t, out_j[0])
    q = st.cube.q.clone()
    q[0, 0, 2] = env_t.cfg.drop_z - 0.002
    st = dataclasses.replace(st, cube=dataclasses.replace(st.cube, q=q))
    st2, obs, rew, term, trunc, info = env_t.step(st, torch.zeros((N, 2)))
    assert term.tolist() == [True, False] and not trunc.any()
    assert int(st2.episode_length[0]) == 0 and int(st2.episode_length[1]) == int(st.episode_length[1]) + 1
    assert abs(float(st2.cube.q[0, 0, 2])) < 1e-3 and float(st2.squeeze[0]) == 0.0
    assert torch.equal(st2.gel.x[0], env_t.rig.rest_points) and float(rew[0]) < -5.0
    assert float(info["log"]["drop_penalty"]) == -env_t.cfg.w_drop / N


def test_reset_all_staggers_the_episodes():
    env = tenvs.make(ENV_ID, num_envs=64, device="cpu")
    st, obs = env.reset_all(env.init_state())
    ep = st.episode_length
    assert ep.dtype == torch.int32 and int(ep.min()) >= 0 and int(ep.max()) < env.cfg.max_episode_length
    assert len(set(ep.tolist())) > 10
    xy = st.cube.q[:, 0, :2]
    assert float(xy.abs().max()) <= env.cfg.reset_xy_noise and float(xy.std()) > 0.0
    assert obs["proprio_obs"].shape == (64, 12) and bool(torch.isfinite(obs["proprio_obs"]).all())


def test_depth_id_one_step_matches_jax():
    stepped = one_step(DEPTH_ID)
    check_step(stepped, "cube")
    check_obs(stepped)
    env_j, env_t, out_j, out_t, _ = stepped
    vis = np.asarray(out_j[1]["vision_obs"])
    assert vis.shape == (N, 16, 16, 2) and out_t[1]["proprio_obs"].shape == (N, 6)
    assert vis.max() > 0.3, "the cube does not press the gel"
    # the embedded grid's rest x, bound once in numpy on both sides
    np.testing.assert_allclose(env_t.rig.rest_x.numpy().reshape(-1), np.asarray(env_j._embed_rest_x).reshape(-1),
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(out_t[5]["grip"].numpy(), vis.mean((1, 2)), atol=COMP_ATOL)
