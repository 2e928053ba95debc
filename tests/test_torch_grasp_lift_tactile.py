"""The port's ``TacEx-Grasp-Lift-Uipc-Tactile-v0`` (the full GelSight stack
on both pads: one sensor over 2N pad-major 32x32 images through the pyramid
and LUT-shade kernels' plain versions, FOTS markers drawn in) against the
JAX package: one step from a carried-over pressed state at 2 envs.

Tolerances: the state, reward and proprio as ``_torch_coupled``. The
tactile image: the port's frame of JAX's post-step state under the bin
rule of ``_torch_bins`` (its inputs equal JAX's up to the f32 rounding of
the depth: ``EDGE_BINS``, and the 32x32 gel's ``FINGER_NOISE_FLOOR``); the
step's own image and vision obs, whose gel differs by the CG drift, within
the LUT's spread everywhere and to 1e-4 on at least 90% of the pixels. The
marker motion of JAX's state to 1e-3 px; the step's own within what the
drift moves the FOTS dilation: ``MARKER_ATOL``. The committed policy is
``test_torch_coupled_policies.py``'s.
"""

import numpy as np

import jax

from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, lut_spread, setup_torch
from _torch_coupled import N, check_step, one_step, port_state
from tacex_tpu.sensors.gelsight.taxim import optical as joptical

setup_torch()

ENV_ID = "TacEx-Grasp-Lift-Uipc-Tactile-v0"
EDGE_BINS = 0.05
MARKER_ATOL = 0.05


def _stepped():
    return one_step(ENV_ID)


def _pad_major(x):
    """(N, 2, ...) -> (2N, ...) pad-major, the sensor's layout."""
    x = np.asarray(x)
    return np.concatenate([x[:, 0], x[:, 1]], 0)


def _jax_gradients(env, state):
    """The JAX env's tactile gradients of ``state``'s frame."""
    sensor = env.sensor
    depth = env._pad_sensor_depth(env._pad_compression(state.gel.x, state.squeeze))
    hm = sensor.height_map_from_depth(depth)
    shifted = joptical.shift_height_map(hm, sensor.compute_indentation_depth(hm))
    deformed, _ = joptical.compute_gel_deformation(sensor.calib, shifted)
    return joptical.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm)


def _port_frame_of_jax_state(stepped):
    """The port's sensor output of JAX's post-step state (its gel, squeeze,
    lift and cube carried over; the sensor state from before the step)."""
    _, env_t, out_j, _, st0_j = stepped
    st = port_state(env_t, out_j[0])
    comp = env_t._pad_compression(st.gel.x, st.squeeze)
    pos, yaw = env_t._cube_pose_in_pads(st)
    sensor0 = port_state(env_t, st0_j).sensor
    return env_t.sensor.update(sensor0, env_t._pad_sensor_depth(comp), obj_yaw=yaw, obj_pos_mm=pos)[1]


def test_one_step_matches_jax():
    stepped = _stepped()
    check_step(stepped, "cube")
    _, _, out_j, out_t, _ = stepped
    assert tuple(out_t[1]["vision_obs"].shape) == np.asarray(out_j[1]["vision_obs"]).shape == (N, 32, 32, 6)
    np.testing.assert_allclose(out_t[1]["proprio_obs"].numpy(), np.asarray(out_j[1]["proprio_obs"]), atol=1.5e-2)
    for name in ("traj_start", "traj_curr", "traj_count"):
        np.testing.assert_allclose(getattr(out_t[0].sensor, name).numpy(), np.asarray(getattr(out_j[0].sensor, name)),
                                   atol=1e-3, err_msg=name)


def test_tactile_image_matches_jax():
    stepped = _stepped()
    env_j, env_t, out_j, out_t, _ = stepped
    gm_j, gd_j = jax.jit(lambda s: _jax_gradients(env_j, s))(out_j[0])
    calib = env_t.sensor.calib
    nb = calib.sensor_params.num_bins
    spread = lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb)
    rgb_j = _pad_major(out_j[5]["tactile_rgb"])
    assert rgb_j.shape == (2 * N, 32, 32, 3)
    out = _port_frame_of_jax_state(stepped)
    held = assert_bin_rule(out["tactile_rgb"].numpy(), rgb_j, np.asarray(gm_j), np.asarray(gd_j), nb, spread,
                           edge_bins=EDGE_BINS, noise_floor=FINGER_NOISE_FLOOR)
    assert held > 0.5
    assert (np.tan(np.asarray(gm_j, np.float64)) > 1e-2).mean() > 0.05, "the cube leaves no mark on the pads"
    for got, want in ((_pad_major(out_t[5]["tactile_rgb"]), rgb_j),
                      (out_t[1]["vision_obs"].numpy(), np.asarray(out_j[1]["vision_obs"]))):
        err = np.abs(got - want).max(-1)
        assert err.max() <= spread + 1e-4, err.max()
        assert (err <= 1e-4).mean() >= 0.9, (err <= 1e-4).mean()


def test_marker_motion_matches_jax():
    stepped = _stepped()
    _, _, out_j, out_t, _ = stepped
    mm_j = _pad_major(out_j[5]["marker_motion"])
    out = _port_frame_of_jax_state(stepped)
    np.testing.assert_allclose(out["marker_motion"].numpy(), mm_j, atol=1e-3, rtol=0)
    np.testing.assert_allclose(_pad_major(out_t[5]["marker_motion"].numpy()), mm_j, atol=MARKER_ATOL, rtol=0)
    assert np.abs(mm_j[:, 1] - mm_j[:, 0]).max() > 0.1, "no marker moved under the press"
