"""Shared helpers of the ball-rolling env parity tests (``test_torch_envs*.py``)."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_bins import assert_bin_rule, lut_spread
from tacex_tpu import envs as jenvs
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.ball_rolling.convert import state_from_numpy
from test_torch_env import ATOL, TOL, _compare_state, _jax_gradients, _overrides, _tree_to_numpy

N = 4


@functools.lru_cache(maxsize=None)
def pair(env_id, **kw):
    """(JAX env, port env, the JAX env's post-reset state) at ``N`` envs with
    no noise and no domain randomization.

    The JAX side runs eagerly (``reset_all`` here, ``step`` in
    ``assert_one_step_matches_jax``): op by op, a process compiles each
    primitive once for all ids, where a jit of an id's reset or step costs
    5-10 s on the CPU and is not shared between ids."""
    env_j = jenvs.make(env_id, **_overrides(), **kw)
    env_t = tenvs.make(env_id, device="cpu", **_overrides(), **kw)
    st_j, _ = env_j.reset_all(env_j.init_state(jax.random.PRNGKey(0)))
    return env_j, env_t, st_j


def action(env_j) -> np.ndarray:
    """Small random motions under a steady press."""
    a = np.random.default_rng(0).uniform(-0.02, 0.02, (N, env_j.cfg.action_space)).astype(np.float32)
    a[:, 2] -= 0.05
    return a


def compare_state(st_t, st_j) -> None:
    """``test_torch_env``'s state comparison; the ball's quaternion, which
    that file's steps barely turn, gets the tolerance its angular velocity's
    implies (half a step of ``TOL['ball_ang']``) on top of 1e-5."""
    tree = _tree_to_numpy(st_j)
    quat = tree.pop("ball_quat")
    _compare_state(st_t, tree)
    ang = max(1.0, float(np.abs(tree["ball_ang"]).max()))
    np.testing.assert_allclose(st_t.ball_quat.numpy(), quat, atol=ATOL + 0.5 / 60.0 * TOL["ball_ang"] * ang)


def assert_one_step_matches_jax(env_id) -> None:
    env_j, env_t, st_j = pair(env_id)
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    assert st_t.actions.shape == (N, env_j.cfg.action_space)
    a = action(env_j)
    st_j, obs_j, rew_j, term_j, trunc_j, info_j = env_j.step(st_j, jnp.asarray(a))
    st_t, obs_t, rew_t, term_t, trunc_t, info_t = env_t.step(st_t, torch.from_numpy(a))
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    if env_j.cfg.reset_mode == "ik_above":
        # the tool restarts 2 cm above the ball, beyond the 1.5 cm limit: every
        # env finishes at once, and its reset draws differ between the frameworks
        assert np.asarray(term_j).all()
    else:
        assert not np.any(np.asarray(term_j) | np.asarray(trunc_j)), "an env finished: its reset draws differ"
        compare_state(st_t, st_j)
        assert set(obs_t) == set(obs_j)
        np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=ATOL)
    indent_j = np.asarray(info_j["indentation_depth"])
    np.testing.assert_allclose(info_t["indentation_depth"].numpy(), indent_j, atol=TOL["indentation_depth"])
    for k, v in info_j["log"].items():
        np.testing.assert_allclose(info_t["log"][k].numpy(), np.asarray(v), atol=TOL.get(k, ATOL), err_msg=k)

    mode = env_j.cfg.obs_mode
    if mode == "privileged":
        assert obs_t["proprio_obs"].shape == (N, 14)
    elif mode == "depth":
        assert obs_t["vision_obs"].shape == (N, 24, 32, 1)
        # metres: the f32 noise of the 0.35 m camera pose
        np.testing.assert_allclose(obs_t["vision_obs"].numpy(), np.asarray(obs_j["vision_obs"]), atol=1e-6)
    else:
        assert (indent_j > 0).all(), "an env lost contact: the tactile path was not exercised"
        calib = env_t.sensor.calib
        nb = calib.sensor_params.num_bins
        spread = lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb)
        gm_j, gd_j = _jax_gradients(env_j, st_j)
        held = assert_bin_rule(obs_t["vision_obs"], obs_j["vision_obs"], gm_j, gd_j, nb, spread, edge_bins=0.05)
        assert held > 0.2
