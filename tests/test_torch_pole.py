"""``TacEx-Pole-Balancing-Base-v0`` in the port against the JAX env: one
step at 4 envs from the JAX env's post-reset state, with no action or
observation noise, under the same numpy action.

Tolerances: state, proprio obs and reward 1e-5, the pole's velocities 1e-4
relative to their largest value (a tip impulse with Baumgarte correction,
and through the rod's inverse inertia, ~1e3 1/(kg m^2), on contact depths
that carry the f32 noise of a ~0.5 m world pose), the depth image 1e-5 m
(where a ray grazes the pole's capsule, the square root of a near-zero
discriminant turns that noise into a few 1e-6 m).
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu import envs as jenvs
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.convert import state_from_numpy
from tacex_tpu_torch.envs.pole_balancing.env import PoleBalancingState

setup_torch()

ENV_ID = "TacEx-Pole-Balancing-Base-v0"
N = 4
ATOL = 1e-5


def _tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def test_one_step_matches_jax():
    kw = dict(num_envs=N, action_noise=0.0, obs_noise_std=0.0)
    env_j, env_t = jenvs.make(ENV_ID, **kw), tenvs.make(ENV_ID, device="cpu", **kw)
    action = np.random.default_rng(0).uniform(-0.3, 0.3, (N, 6)).astype(np.float32)

    def reset_step(state, a):
        state, _ = env_j.reset_all(state)
        return state, env_j.step(state, a)

    st0_j, (st_j, obs_j, rew_j, term_j, trunc_j, info_j) = jax.jit(reset_step)(
        env_j.init_state(jax.random.PRNGKey(0)), jnp.asarray(action)
    )
    st0_t = state_from_numpy(PoleBalancingState, _tree(st0_j), device="cpu")
    # the port's own reset gives the same state (it draws nothing)
    st0_own, obs0_t = env_t.reset_all(env_t.init_state())
    for f in ("pole_pos", "pole_quat", "actions"):
        np.testing.assert_allclose(getattr(st0_own, f).numpy(), getattr(st0_t, f).numpy(), atol=ATOL, err_msg=f)
    assert obs0_t["vision_obs"].shape == (N, 32, 32, 1)

    st_t, obs_t, rew_t, term_t, trunc_t, info_t = env_t.step(st0_t, torch.from_numpy(action))
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    tree = _tree(st_j)
    for f in ("q", "qd", "q_target"):
        np.testing.assert_allclose(getattr(st_t.arm, f).numpy(), tree["arm"][f], atol=ATOL, err_msg=f)
    for f in ("pole_pos", "pole_quat", "actions", "prev_actions"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(), tree[f], atol=ATOL, err_msg=f)
    for f in ("pole_lin", "pole_ang"):
        v = tree[f]
        np.testing.assert_allclose(getattr(st_t, f).numpy(), v, atol=1e-4 * max(1.0, float(np.abs(v).max())), err_msg=f)
    np.testing.assert_array_equal(st_t.episode_length.numpy(), tree["episode_length"])
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=ATOL)
    np.testing.assert_allclose(info_t["log"]["full_reward"].numpy(), np.asarray(info_j["log"]["full_reward"]), atol=ATOL)
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)
    np.testing.assert_allclose(obs_t["vision_obs"].numpy(), np.asarray(obs_j["vision_obs"]), atol=1e-5)
    assert obs_t["proprio_obs"].shape == (N, 14)
    # the pole's tip is in front of the camera, and it pushed on the gel
    assert (np.asarray(obs_j["vision_obs"]) < 0.029).any()
    assert float(np.abs(tree["pole_lin"][:, 2]).max()) > 0.0
