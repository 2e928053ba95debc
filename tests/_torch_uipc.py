"""Shared helpers of the UIPC ball-rolling parity tests (``test_torch_uipc_*.py``).

Both envs run at 2 envs with no action noise, no observation noise and no
domain randomization. The JAX env resets and takes ``PRESS_STEPS`` steps of
a steady press (one jit of ``reset_all`` and one of ``step`` an id, shared
through ``pair``), so the gel is in contact with the ball; the port starts
from that state, carried over by ``state_from_numpy``, and both take one
more step under the same action.

Tolerances: the base state, reward, proprio obs and indentation as
``test_torch_env.py`` (1e-5, and its ``TOL`` where f32 cannot reach that at
~0.35 m from the origin); the gel within ``GEL_ATOL`` and ``GEL_V_ATOL`` (the
CG drift of two f32 solves, ``test_torch_soft_ipc.py``); the marker flow,
compared as sets (the two frameworks draw different subsample orders),
within what that drift moves a marker in the image, fx / z x GEL_ATOL =
0.18 px. The tactile image: the port's frame of JAX's post-step gel under
the bin rule of ``_torch_bins`` (inputs equal up to the f32 rounding of the
pose: ``EDGE_BINS``); the step's own image, whose gel differs by the CG
drift (a 4e-6 m height difference moves a 0.59 mm-pixel gradient by up to
half a magnitude bin), within the LUT spread everywhere and to 1e-4 on at
least 90% of the pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_bins import assert_bin_rule, lut_spread
from _torch_envs import compare_state
from tacex_tpu import envs as jenvs
from tacex_tpu.core import maths as jmaths
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.core import maths
from tacex_tpu_torch.envs.ball_rolling.convert import state_from_numpy
from test_torch_env import ATOL, TOL, _tree_to_numpy

N = 2
PRESS_STEPS = 2
# the tool descends 1.5 and 1.1 mm a step: the compared step presses the
# gel from ~1.3 and ~1.0 mm of indentation to ~2.0 and ~1.5 mm
PRESS = np.array([[0.0, 0.0, -0.03, 0.0, 0.0, 0.0], [0.01, -0.01, -0.0225, 0.0, 0.0, 0.02]], np.float32)
# gel positions: the CG drift of two f32 solves (test_torch_soft_ipc.py), in
# metres at ~0.35 m from the origin; velocities: that over dt
GEL_ATOL = 1.5e-5
GEL_V_ATOL = 60.0 * GEL_ATOL
MARKER_ATOL = 340.0 / 0.0285 * GEL_ATOL
EDGE_BINS = 0.05


def overrides(**kw):
    events = jenvs.ball_rolling.BallRollingEnvCfg().events_cfg
    return dict(num_envs=N, action_noise=0.0, obs_noise_std=0.0, events_cfg={**events, "enabled": False}, **kw)


@functools.lru_cache(maxsize=None)
def pair(env_id, **kw):
    """(JAX env, port env, jitted JAX step, the JAX state after the press)."""
    env_j = jenvs.make(env_id, **overrides(**kw))
    env_t = tenvs.make(env_id, device="cpu", **overrides(**kw))
    st_j, _ = jax.jit(env_j.reset_all)(env_j.init_state(jax.random.PRNGKey(0)))
    step_j = jax.jit(env_j.step)
    for _ in range(PRESS_STEPS):
        st_j = step_j(st_j, jnp.asarray(PRESS))[0]
    return env_j, env_t, step_j, st_j


def one_step(env_id, **kw):
    """One step of both envs from the pressed JAX state: (env_j, env_t,
    JAX outputs, port outputs, the JAX state before the step)."""
    env_j, env_t, step_j, st_j = pair(env_id, **kw)
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    out_j = step_j(st_j, jnp.asarray(PRESS))
    out_t = env_t.step(st_t, torch.from_numpy(PRESS))
    return env_j, env_t, out_j, out_t, st_j


def grid_cam_jax(env, state):
    """The JAX env's camera-frame contact surface of ``state`` (post-physics)."""
    tool_pos, tool_quat = env._tool_pose(state.base.arm.q)
    cam_pos, cam_quat = env._camera_pose(tool_pos, tool_quat)
    if env.embed is not None:
        grid_world = env.embed.positions(state.gel.x)
    else:
        grid_world = state.gel.x[:, env._contact_grid_ids.reshape(-1)]
    return jmaths.quat_apply_inverse(cam_quat[:, None], grid_world - cam_pos[:, None])


def gradients_jax(env, state):
    """The JAX env's tactile gradients of ``state``'s frame (post-physics)."""
    n = state.gel.x.shape[0]
    gh, gw = env.embed.shape if env.embed is not None else env._contact_grid_ids.shape
    res_w, res_h = env.cfg.camera_resolution
    depth = jax.image.resize(grid_cam_jax(env, state)[..., 2].reshape(n, gh, gw), (n, res_h, res_w), method="linear")
    sensor = env.sensor
    hm = sensor.height_map_from_depth(depth)
    shifted = joptical.shift_height_map(hm, sensor.compute_indentation_depth(hm))
    deformed, _ = joptical.compute_gel_deformation(sensor.calib, shifted)
    return joptical.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm)


def marker_sets(flow) -> np.ndarray:
    """(N, 2, K, 2) flows -> per env, the distinct markers as rows
    (u0, v0, u, v) sorted by their initial pixel: the two frameworks draw
    different subsample orders and pad with different last markers."""
    flow = np.asarray(flow)
    out = []
    for f in flow:
        rows = np.concatenate([f[0], f[1]], -1)  # (K, 4)
        keys, first = np.unique(np.round(rows[:, :2], 2), axis=0, return_index=True)  # sorted by (u0, v0)
        out.append(rows[first])
    return np.stack(out)


def check_step(stepped) -> None:
    env_j, env_t, out_j, out_t, _ = stepped
    st_j, obs_j, rew_j, term_j, trunc_j, info_j = out_j
    st_t, obs_t, rew_t, term_t, trunc_t, info_t = out_t
    assert not np.any(np.asarray(term_j) | np.asarray(trunc_j)), "an env finished: its reset draws differ"
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    tree = _tree_to_numpy(st_j)
    compare_state(st_t.base, st_j.base)
    np.testing.assert_allclose(st_t.gel.x.numpy(), tree["gel"]["x"], atol=GEL_ATOL)
    np.testing.assert_allclose(st_t.gel.v.numpy(), tree["gel"]["v"], atol=GEL_V_ATOL)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=ATOL)
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)
    indent_j = np.asarray(info_j["indentation_depth"])
    assert (indent_j > 0.5).all() and (indent_j < 4.0).all(), indent_j
    np.testing.assert_allclose(info_t["indentation_depth"].numpy(), indent_j, atol=TOL["indentation_depth"])
    for k, v in info_j["log"].items():
        np.testing.assert_allclose(info_t["log"][k].numpy(), np.asarray(v), atol=TOL.get(k, ATOL), err_msg=k)


def check_markers(stepped) -> None:
    _, env_t, out_j, out_t, _ = stepped
    flow_j, flow_t = np.asarray(out_j[5]["marker_flow"]), out_t[5]["marker_flow"].numpy()
    assert flow_t.shape == flow_j.shape == (N, 2, 128, 2)
    sets_j, sets_t = marker_sets(flow_j), marker_sets(flow_t)
    assert sets_t.shape == sets_j.shape and sets_j.shape[1] > 50
    np.testing.assert_allclose(sets_t[..., :2], sets_j[..., :2], atol=1e-3)
    np.testing.assert_allclose(sets_t[..., 2:], sets_j[..., 2:], atol=MARKER_ATOL)
    assert np.abs(sets_j[..., 2:] - sets_j[..., :2]).max() > 1.0, "no marker moved under the press"


def frame_on_jax_state(stepped):
    """The port's sensor output and camera-frame contact surface of JAX's
    post-step state (its gel and poses carried over)."""
    _, env_t, out_j, _, st0_j = stepped
    tree = _tree_to_numpy(out_j[0])
    tool_pos, tool_quat = env_t._tool_pose(torch.from_numpy(tree["base"]["arm"]["q"]))
    _, _, _, grid_cam, depth = env_t.contact_surface(torch.from_numpy(tree["gel"]["x"]), tool_pos, tool_quat)
    ball_quat = torch.from_numpy(tree["base"]["ball_quat"])
    rel_yaw = maths.yaw_from_quat(maths.quat_mul(maths.quat_conjugate(tool_quat), ball_quat))
    sensor0 = state_from_numpy(_tree_to_numpy(st0_j), device="cpu").base.sensor
    _, out = env_t.sensor.update(sensor0, depth, obj_yaw=rel_yaw)
    return out, grid_cam


def check_tactile(stepped, vision_on_jax_state=None) -> None:
    """``vision_on_jax_state(sensor_out, grid_cam)`` gives the port's vision
    obs of JAX's post-step state; by default its tactile RGB."""
    env_j, env_t, out_j, out_t, _ = stepped
    gm_j, gd_j = jax.jit(lambda s: gradients_jax(env_j, s))(out_j[0])
    calib = env_t.sensor.calib
    nb = calib.sensor_params.num_bins
    spread = lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb)
    vis_j = np.asarray(out_j[1]["vision_obs"])
    assert vis_j.shape == out_t[1]["vision_obs"].shape == (N, 24, 32, 3)
    out, grid_cam = frame_on_jax_state(stepped)
    vis = out["tactile_rgb"] if vision_on_jax_state is None else vision_on_jax_state(out, grid_cam)
    held = assert_bin_rule(vis, vis_j, gm_j, gd_j, nb, spread, edge_bins=EDGE_BINS)
    assert held > 0.5
    err = np.abs(out_t[1]["vision_obs"].numpy() - vis_j).max(-1)
    assert err.max() <= spread + 1e-4, err.max()
    assert (err <= 1e-4).mean() >= 0.9, (err <= 1e-4).mean()
