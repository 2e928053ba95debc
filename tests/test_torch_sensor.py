"""Parity of the port's FOTS marker model and GelSightSensor with JAX.

Tolerances: marker sampling indices exact, FOTS fields and sensor outputs to
1e-5 (sums of Gaussian-weighted displacements in f32), tactile RGB under the
bin rule of ``_torch_bins``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _reference_oracle import sphere_height_map
from _torch_bins import assert_bin_rule, lut_spread, setup_torch
from tacex_tpu.sensors.gelsight import sensor as jsensor_mod
from tacex_tpu.sensors.gelsight import sensor_cfg as jcfg
from tacex_tpu.sensors.gelsight.fots import marker_motion as jfots
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch.sensors.gelsight import sensor as tsensor_mod
from tacex_tpu_torch.sensors.gelsight import sensor_cfg as tcfg
from tacex_tpu_torch.sensors.gelsight.fots import marker_motion as tfots

setup_torch()

T = lambda a: torch.tensor(np.asarray(a))
J = jnp.asarray


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


class TestFots:
    def test_marker_grid_and_sampling_indices_are_exact(self):
        for cfg_j, cfg_t in ((jfots.FOTSMarkerCfg(), tfots.FOTSMarkerCfg()),
                             (jcfg.FOTSMarkerSimulatorCfg().to_marker_cfg(), tcfg.FOTSMarkerSimulatorCfg().to_marker_cfg())):
            grid_j = np.asarray(jfots.init_marker_grid(cfg_j))
            grid_t = tfots.init_marker_grid(cfg_t).numpy()
            np.testing.assert_array_equal(grid_t, grid_j)
            for scale, hw in (((0.1, 0.1), (24, 32)), ((1.0, 1.0), (240, 320)), ((0.137, 0.21), (33, 45))):
                my, mx = tfots.marker_sample_index(T(grid_t), hw, scale)
                ref_x = np.clip((grid_j[:, 0] * np.float32(scale[0])).astype(np.int32), 0, hw[1] - 1)
                ref_y = np.clip((grid_j[:, 1] * np.float32(scale[1])).astype(np.int32), 0, hw[0] - 1)
                np.testing.assert_array_equal(mx.numpy(), ref_x)
                np.testing.assert_array_equal(my.numpy(), ref_y)

    @pytest.mark.parametrize("scale", [(0.1, 0.1), (1.0, 1.0)])
    def test_marker_motion(self, scale):
        rng = np.random.default_rng(0)
        cfg_j, cfg_t = jfots.FOTSMarkerCfg(), tfots.FOTSMarkerCfg()
        h, w = (24, 32) if scale[0] < 1 else (240, 320)
        n = 4
        depth = rng.uniform(0, 1.5, (n, h, w)).astype(np.float32)
        mask = rng.random((n, h, w)) < 0.5
        mask[3] = False  # no contact: markers stay on the grid
        start = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        curr = (start + rng.uniform(-0.5, 0.5, (n, 3))).astype(np.float32)
        valid = np.array([True, False, True, True])
        grid = np.asarray(jfots.init_marker_grid(cfg_j))
        out_t = tfots.marker_motion(cfg_t, T(depth), T(mask), T(start), T(curr), T(valid), T(grid), scale)
        motion_j = jax.jit(lambda *a: jfots.marker_motion(cfg_j, *a, sample_scale=scale))
        out_j = motion_j(J(depth), J(mask), J(start), J(curr), J(valid), J(grid))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
        np.testing.assert_array_equal(out_t.numpy()[3], grid)

        flow_t = tfots.marker_flow(T(grid), out_t)
        flow_j = jfots.marker_flow(J(grid), out_j)
        np.testing.assert_allclose(flow_t.numpy(), np.asarray(flow_j), atol=1e-5)

    @pytest.mark.parametrize("radius,hw", [(0.45, (24, 32)), (2.0, (60, 80))])
    def test_draw_marker_image(self, radius, hw):
        rng = np.random.default_rng(1)
        cfg_j = jfots.FOTSMarkerCfg(marker_dot_radius_px=radius)
        cfg_t = tfots.FOTSMarkerCfg(marker_dot_radius_px=radius)
        markers = rng.uniform(-2, max(hw) + 2, (3, 99, 2)).astype(np.float32)
        markers[0, :5] = np.round(markers[0, :5])  # dots centred on pixels
        img_t = tfots.draw_marker_image(cfg_t, T(markers), hw=hw).numpy()
        img_j = np.asarray(jfots.draw_marker_image(cfg_j, J(markers), hw=hw))
        np.testing.assert_allclose(img_t, img_j, atol=1e-6)
        assert img_t.min() < 0.5


def _press_depth(n, hw, frame):
    """(n, h, w) camera depth (m) of a sphere pressing the gel, like the
    verify recipe's press, moving a little between frames."""
    h, w = hw
    pix = 0.0295 * 640 / w
    out = []
    for i in range(n):
        c = (h / 2.0 + i + 0.7 * frame, w / 2.0 - 1.5 * i + 0.9 * frame)
        z = sphere_height_map(h, w, radius_mm=4.0, pixmm=pix, center=c)
        out.append(0.0285 + (z - z.min()) / 1000.0 - (0.0012 + 0.0003 * i + 0.0002 * frame))
    out = np.stack(out).astype(np.float32)
    out[-1] = 0.0289  # last env: nothing within reach
    return out


@pytest.mark.parametrize("camera_res", [(32, 24), (64, 48)])
def test_sensor_update_two_frames(camera_res):
    tactile_res = (32, 24)
    n = 3
    cfg_j = jcfg.gelsight_mini_cfg(camera_resolution=camera_res, tactile_img_res=tactile_res)
    cfg_t = tcfg.gelsight_mini_cfg(camera_resolution=camera_res, tactile_img_res=tactile_res)
    sen_j = jsensor_mod.GelSightSensor(cfg_j, num_envs=n)
    sen_t = tsensor_mod.GelSightSensor(cfg_t, num_envs=n, device="cpu")
    st_j, st_t = sen_j.init_state(), sen_t.init_state()
    update_j = jax.jit(sen_j.update)
    nb = sen_t.calib.sensor_params.num_bins
    spread = lut_spread(sen_t.calib.poly_lut.numpy(), sen_t.calib.features.numpy(), nb)
    hw = (camera_res[1], camera_res[0])
    yaw = np.array([0.0, 0.1, -0.2], np.float32)
    for frame in range(2):
        depth = _press_depth(n, hw, frame)
        st_j, out_j = update_j(st_j, J(depth), obj_yaw=J(yaw * frame))
        st_t, out_t = sen_t.update(st_t, T(depth), obj_yaw=T(yaw * frame))
        for key in ("height_map", "camera_depth", "indentation_depth", "marker_motion"):
            np.testing.assert_allclose(_np(out_t[key]), np.asarray(out_j[key]), atol=1e-5, err_msg=key)
        for f in dataclasses.fields(st_t):
            np.testing.assert_allclose(_np(getattr(st_t, f.name)), np.asarray(getattr(st_j, f.name)), atol=1e-5)
        assert (np.asarray(out_j["indentation_depth"])[:-1] > 0).all()

        # the JAX sensor's gradients, recomputed from its height map
        hm = J(np.asarray(out_j["height_map"]))
        if hw != (tactile_res[1], tactile_res[0]):
            hm = jax.image.resize(hm, (n, tactile_res[1], tactile_res[0]), method="linear")
        shifted = joptical.shift_height_map(hm, out_j["indentation_depth"])
        deformed, _ = joptical.compute_gel_deformation(sen_j.calib, shifted)
        gm_j, gd_j = joptical.generate_normals(sen_j.calib, -deformed / sen_j.calib.sensor_params.pixmm)
        held = assert_bin_rule(out_t["tactile_rgb"], out_j["tactile_rgb"], gm_j, gd_j, nb, spread)
        assert held > 0.3
    assert (st_t.traj_count.numpy()[:-1] == 2).all()


def test_sensor_update_object_pose_variant():
    """``obj_pos_mm`` given: the FOTS contact centre is the object's position
    in the sensor frame, not the contact-mask centroid. The object moves
    between the frames, so the second frame shears the markers."""
    n, res = 3, (32, 24)
    cfg_j = jcfg.gelsight_mini_cfg(camera_resolution=res, tactile_img_res=res)
    cfg_t = tcfg.gelsight_mini_cfg(camera_resolution=res, tactile_img_res=res)
    sen_j = jsensor_mod.GelSightSensor(cfg_j, num_envs=n)
    sen_t = tsensor_mod.GelSightSensor(cfg_t, num_envs=n, device="cpu")
    st_j, st_t = sen_j.init_state(), sen_t.init_state()
    update_j = jax.jit(sen_j.update)
    pos = np.array([[0.5, -1.0], [-2.0, 0.3], [0.0, 0.0]], np.float32)
    for frame in range(2):
        depth = _press_depth(n, (res[1], res[0]), frame)
        p = pos + np.float32(0.4 * frame)
        st_j, out_j = update_j(st_j, J(depth), obj_pos_mm=J(p))
        st_t, out_t = sen_t.update(st_t, T(depth), obj_pos_mm=T(p))
        np.testing.assert_allclose(out_t["marker_motion"].numpy(), np.asarray(out_j["marker_motion"]), atol=1e-5)
        for f in dataclasses.fields(st_t):
            np.testing.assert_allclose(_np(getattr(st_t, f.name)), np.asarray(getattr(st_j, f.name)), atol=1e-5)
    np.testing.assert_allclose(st_t.traj_curr.numpy()[:-1, :2], pos[:-1] + np.float32(0.4))
    flow = out_t["marker_motion"].numpy()
    moved = np.abs(flow[:, 1] - flow[:, 0]).max(axis=(1, 2))
    assert (moved[:-1] > 1.0).all() and moved[-1] == 0.0


def test_reset_clears_masked_envs():
    cfg = tcfg.gelsight_mini_cfg(camera_resolution=(32, 24), tactile_img_res=(32, 24))
    sen = tsensor_mod.GelSightSensor(cfg, num_envs=2, device="cpu")
    st = tsensor_mod.GelSightSensorState(torch.ones(2, 3), torch.ones(2, 3), torch.full((2,), 3, dtype=torch.int32))
    st = sen.reset(st, torch.tensor([True, False]))
    assert st.traj_count.tolist() == [0, 3] and st.traj_start[0].abs().sum() == 0 and st.traj_curr[1].sum() == 3
