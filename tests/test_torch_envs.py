"""The rgb, depth and privileged ball-rolling tasks of the port against JAX.

Each id takes one step at 4 envs from the JAX env's post-reset state (carried
over by ``state_from_numpy``) under the same numpy action, with no action
noise, no observation noise and no domain randomization; no env may finish,
so no reset draws random numbers. Tolerances are those of
``test_torch_env.py`` (1e-5, and its ``TOL`` where f32 cannot reach that).
The two IK-reset ids are in ``test_torch_envs_ik.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_envs import N, action, assert_one_step_matches_jax, compare_state, pair
from tacex_tpu import envs as jenvs
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.ball_rolling.convert import state_from_numpy
from test_torch_env import ATOL, _tree_to_numpy

setup_torch()

PRIVILEGED = "TacEx-Ball-Rolling-Privileged-v0"
RIGID_IDS = [
    "TacEx-Ball-Rolling-Taxim-Fots-v0",
    "TacEx-Ball-Rolling-Tactile-RGB-v0",
    "TacEx-Ball-Rolling-Tactile-Depth-v1",
    PRIVILEGED,
    "TacEx-Ball-Rolling-Privileged-Reset-with-IK-v0",
    "TacEx-Ball-Rolling-Privileged-Without-Reaching-v0",
]


def test_all_six_rigid_ids_are_registered():
    from tacex_tpu.envs.base import _REGISTRY as registry_j
    from tacex_tpu_torch.envs.base import _REGISTRY as registry_t

    # every ball-rolling id of the JAX package is registered; the six rigid
    # ones are those without the soft (Uipc) gel pad
    ball_t = sorted(k for k in registry_t if k.startswith("TacEx-Ball-Rolling-"))
    assert ball_t == sorted(k for k in registry_j if k.startswith("TacEx-Ball-Rolling-"))
    assert [k for k in ball_t if "Uipc" not in k] == sorted(RIGID_IDS)
    for env_id in RIGID_IDS:
        cfg_t, cfg_j = registry_t[env_id][1](), registry_j[env_id][1]()
        for name in ("obs_mode", "reset_mode", "reset_ik_height", "with_markers", "action_space", "vision_obs_shape"):
            assert getattr(cfg_t, name) == getattr(cfg_j, name), (env_id, name)
    with pytest.raises(ValueError, match="camera_rgb"):
        tenvs.make(PRIVILEGED, num_envs=2, device="cpu", obs_mode="camera_rgb")
    with pytest.raises(ValueError, match="reset_mode"):
        tenvs.make(PRIVILEGED, num_envs=2, device="cpu", reset_mode="ik")


@pytest.mark.parametrize("env_id", RIGID_IDS[1:4])
def test_one_step_matches_jax(env_id):
    assert_one_step_matches_jax(env_id)


def test_step_physics_only_matches_jax():
    env_j, env_t, st_j = pair(PRIVILEGED)
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    a = action(env_j)
    st_j = env_j.step_physics_only(st_j, jnp.asarray(a))
    before = st_t
    st_t = env_t.step_physics_only(st_t, torch.from_numpy(a))
    compare_state(st_t, st_j)
    assert torch.equal(st_t.goal_pos, before.goal_pos) and int(st_t.episode_length[0]) == 1


@pytest.mark.parametrize(
    "env_id,shape", [("TacEx-Ball-Rolling-Tactile-RGB-v0", (12, 16, 3)), ("TacEx-Ball-Rolling-Tactile-Depth-v1", (12, 20, 1))]
)
def test_resized_vision_obs_matches_jax(env_id, shape):
    """``vision_obs_shape`` smaller than the camera: the observation is the
    antialiased linear resize that ``jax.image.resize`` gives."""
    env_j, env_t, st_j = pair(env_id, vision_obs_shape=shape)
    rng = np.random.default_rng(1)
    sensor_out = {
        "tactile_rgb": rng.uniform(0, 1, (N, 24, 32, 3)).astype(np.float32),
        "camera_depth": rng.uniform(0.02, 0.03, (N, 24, 32, 1)).astype(np.float32),
    }
    obs_j, _ = jax.jit(lambda s, o: env_j._observations(s, sensor_out=o))(st_j, {k: jnp.asarray(v) for k, v in sensor_out.items()})
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    obs_t = env_t._observations(st_t, sensor_out={k: torch.from_numpy(v) for k, v in sensor_out.items()})
    assert obs_t["vision_obs"].shape == (N,) + shape
    np.testing.assert_allclose(obs_t["vision_obs"].numpy(), np.asarray(obs_j["vision_obs"]), atol=1e-6)
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)


def test_observation_noise_is_drawn_once():
    env = tenvs.make(PRIVILEGED, num_envs=2048, device="cpu", obs_noise_std=0.01)
    st, _ = env.reset_all(env.init_state())
    clean = env._observations(st)["proprio_obs"]
    noisy = env._observations(st, noise=True)["proprio_obs"]
    assert abs(float((noisy - clean).std()) - 0.01) < 5e-4
