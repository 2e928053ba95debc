"""The port's UIPC ball-rolling task ``TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0``
against the JAX package: registration, the gel and its marker binding, and
one step from a carried-over pressed state at 2 envs with the tolerances of
``_torch_uipc`` (state, reward, marker flow as sets, the tactile image under
the bin rule).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bins import setup_torch
from _torch_uipc import PRESS, check_markers, check_step, check_tactile, one_step, pair
from tacex_tpu.envs.base import _REGISTRY as registry_j
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.ball_rolling.convert import state_from_numpy
from tacex_tpu_torch.envs.ball_rolling.env_uipc import UipcBallRollingState
from tacex_tpu_torch.envs.base import _REGISTRY as registry_t
from test_torch_env import _tree_to_numpy

setup_torch()

ENV_ID = "TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0"
UIPC_IDS = [ENV_ID, "TacEx-Ball-Rolling-Uipc-Textured-v0"]


@pytest.mark.parametrize("env_id", UIPC_IDS)
def test_uipc_ids_registered_with_the_jax_defaults(env_id):
    cfg_t, cfg_j = registry_t[env_id][1](), registry_j[env_id][1]()
    for name in ("num_envs", "obs_mode", "with_markers", "sim_dt", "camera_resolution", "vision_obs_shape",
                 "gel_resolution", "gel_embed_surface", "gel_youngs_modulus_pa", "gel_poisson_ratio"):
        assert getattr(cfg_t, name) == getattr(cfg_j, name), name
    assert (cfg_t.num_envs, cfg_t.gel_resolution) == (16, "low")
    env = tenvs.make(env_id, num_envs=2, device="cpu", gel_resolution="mid", gel_embed_surface=(9, 7))
    assert env._grid_shape == (21, 17) and env.embed.shape == (9, 7)
    assert env.gel.cfg.newton_max_iter == 4 and env.gel.cfg.cg_iters == 16 and env.gel.cfg.d_hat == 5e-4


def test_registered_gel_and_marker_flow():
    """The registered "low" gel: 297 vertices, 960 tets, 234 surface
    vertices, its 99 mount-face vertices attached; the marker flow bound to
    the contact face as in JAX."""
    env_j, env_t, _, _ = pair(ENV_ID)
    mesh = env_t.gel_mesh
    assert (mesh.num_vertices, len(mesh.tets), len(mesh.surface_verts)) == (297, 960, 234)
    assert env_t.gel.attachment_verts.shape == (99,)
    np.testing.assert_array_equal(env_t.gel.attachment_verts.numpy(), np.asarray(env_j.gel.attachment_verts))
    np.testing.assert_array_equal(env_t._contact_grid_ids.numpy(), np.asarray(env_j._contact_grid_ids).reshape(-1))
    # the JAX env meshes through its C++ runtime where built, which orders the
    # surface triangles otherwise (and rounds the points within 2e-9 m): a
    # marker on a shared edge binds to another triangle, at the same point
    assert env_t.marker_flow.num_bound == env_j.marker_flow.num_bound > 0
    np.testing.assert_allclose(env_t.marker_flow.init_pts.numpy(), np.asarray(env_j.marker_flow.init_pts), atol=1e-8)


@pytest.fixture(scope="module")
def stepped():
    return one_step(ENV_ID)


def test_state_carries_over(stepped):
    _, _, _, _, st_j = stepped
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    assert isinstance(st_t, UipcBallRollingState)
    np.testing.assert_array_equal(st_t.gel.x.numpy(), np.asarray(st_j.gel.x))
    np.testing.assert_array_equal(st_t.base.ball_pos.numpy(), np.asarray(st_j.base.ball_pos))


def test_one_step_matches_jax(stepped):
    check_step(stepped)


def test_marker_flow_matches_jax_as_sets(stepped):
    check_markers(stepped)


def test_tactile_image_matches_jax(stepped):
    check_tactile(stepped)


def test_curriculum_reads_the_total_before_the_step(stepped):
    """The JAX UIPC env updates the curriculum from the episode totals before
    the step's reward is added. With the totals set so that the mean crosses
    the goal curriculum's threshold only with this step's reward, the two
    orders give different levels: the port's is JAX's."""
    env_j, env_t, step_j, _ = pair(ENV_ID)
    _, _, out_j, _, st_j = stepped
    reward = np.asarray(out_j[2])
    thr = env_j.cfg.curriculum_cfg["goal_randomization_range"]["threshold"]
    total = jnp.asarray(thr - reward / 2.0, jnp.float32)
    st_j = dataclasses.replace(st_j, base=dataclasses.replace(st_j.base, total_episode_rew=total))
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    out_j = step_j(st_j, jnp.asarray(PRESS))
    out_t = env_t.step(st_t, torch.from_numpy(PRESS))
    level_j = np.asarray(out_j[0].base.curriculum)
    np.testing.assert_array_equal(out_t[0].base.curriculum.numpy(), level_j)
    np.testing.assert_allclose(out_t[2].numpy(), reward, atol=1e-5)
    before, after = float(np.mean(np.asarray(total))), float(np.mean(np.asarray(total) + reward))
    assert (before > thr) != (after > thr), (before, after)
    assert level_j[0] == int(before > thr), "the JAX env read the totals after the step"


def test_step_physics_only_is_the_step_physics():
    """``step_physics_only`` advances the arm, the ball and the gel as
    ``step`` does, and stops before the tactile frame."""
    env = tenvs.make(ENV_ID, num_envs=2, device="cpu", action_noise=0.0)
    st, _ = env.reset_all(env.init_state())
    a = torch.from_numpy(PRESS)
    phys = env.step_physics_only(st, a)
    full, *_ = env.step(st, a)
    for name in ("ball_pos", "ball_lin", "ball_ang"):
        assert torch.equal(getattr(phys.base, name), getattr(full.base, name)), name
    assert torch.equal(phys.gel.x, full.gel.x) and torch.equal(phys.base.arm.q, full.base.arm.q)
    assert phys.base.sensor is st.base.sensor
    assert int(phys.base.episode_length[0]) == 1
    assert dataclasses.is_dataclass(phys) and isinstance(phys, UipcBallRollingState)
