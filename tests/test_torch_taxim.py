"""Parity of the port's Taxim calibration and dense optical path with JAX.

Tolerances: 1e-6 for the calibration (the same numpy inputs through blurs
and resizes summed in another order); 1e-5 for the deformation (seven blurs
deep); tactile RGB under the bin rule of ``_torch_bins`` (out of contact the
gradient is float noise, so its direction bin is not reproducible).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _reference_oracle import sphere_height_map
from _torch_bins import assert_bin_rule, lut_spread, setup_torch
from tacex_tpu.sensors.gelsight.taxim import calib as jcalib
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch.ops.resize import resize_linear
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

HW = (24, 32)


@pytest.fixture(scope="module")
def calibs():
    full_j, full_t = jcalib.load_calib(), tcalib.load_calib()
    return full_j, full_t, full_j.at_resolution(HW), full_t.at_resolution(HW)


def _press_maps(n: int, hw=HW) -> np.ndarray:
    """(n, h, w) sphere presses at a few centres and depths (mm, 0 = gel top)."""
    h, w = hw
    pix = 0.0295 * 640 / w
    maps = []
    for i in range(n):
        c = (h / 2.0 + 2.0 * i - 1.0, w / 2.0 - 3.0 * i + 2.0)
        maps.append(sphere_height_map(h, w, radius_mm=4.0, pixmm=pix, center=c) - (0.6 + 0.4 * i))
    return np.stack(maps).astype(np.float32)


class TestCalib:
    def test_native_resolution(self, calibs):
        full_j, full_t, _, _ = calibs
        np.testing.assert_allclose(full_t.poly_lut.numpy(), np.asarray(full_j.poly_lut), atol=1e-6)
        # gel heights are blurred at ~gel_map_shift (5 mm), then shifted to 0:
        # the two blurs agree to 1e-6 relative to that magnitude
        atol = 1e-6 * full_j.gel_map_shift
        np.testing.assert_allclose(full_t.gel_map.numpy(), np.asarray(full_j.gel_map), atol=atol)
        np.testing.assert_allclose(full_t.background.numpy(), np.asarray(full_j.background), atol=1e-6)
        assert abs(full_t.gel_map_shift - full_j.gel_map_shift) <= 1e-6

    def test_at_slice_resolution(self, calibs):
        _, _, cal_j, cal_t = calibs
        assert cal_t.resolution == cal_j.resolution == HW
        np.testing.assert_allclose(cal_t.gel_map.numpy(), np.asarray(cal_j.gel_map), atol=1e-6)
        np.testing.assert_allclose(cal_t.background.numpy(), np.asarray(cal_j.background), atol=1e-6)
        np.testing.assert_allclose(cal_t.poly_lut.numpy(), np.asarray(cal_j.poly_lut), atol=1e-6)
        feats = np.asarray(joptical._features(cal_j, HW)).reshape(-1, 6).T
        np.testing.assert_array_equal(cal_t.features.numpy(), feats)

    @pytest.mark.parametrize("src,dst", [((480, 640), (24, 32)), ((48, 64), (24, 32)), ((24, 32), (48, 64)), ((5, 7), (3, 11))])
    def test_resize_matches_jax_image_resize(self, src, dst):
        x = np.random.default_rng(0).normal(size=(2,) + src).astype(np.float32)
        out = resize_linear(torch.from_numpy(x), (2,) + dst).numpy()
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst, method="linear"))
        np.testing.assert_allclose(out, ref, atol=1e-6)

    def test_missing_calibration_folder_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            tcalib.load_calib(tmp_path / "nowhere")


class TestOptical:
    def test_gel_deformation(self, calibs):
        _, _, cal_j, cal_t = calibs
        hm = _press_maps(3)
        d_t, m_t = toptical.compute_gel_deformation(cal_t, torch.from_numpy(hm))
        d_j, m_j = joptical.compute_gel_deformation(cal_j, jnp.asarray(hm))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)

    def test_normals_above_the_noise_floor(self, calibs):
        _, _, cal_j, cal_t = calibs
        d_j, _ = joptical.compute_gel_deformation(cal_j, jnp.asarray(_press_maps(3)))
        hm_px = -np.asarray(d_j) / cal_j.sensor_params.pixmm
        gm_t, gd_t = toptical.generate_normals(cal_t, torch.from_numpy(hm_px))
        gm_j, gd_j = joptical.generate_normals(cal_j, jnp.asarray(hm_px))
        gm_j, gd_j = np.asarray(gm_j), np.asarray(gd_j)
        lifted = np.tan(gm_j) >= 1e-5
        assert lifted.mean() > 0.1
        np.testing.assert_allclose(gm_t.numpy()[lifted], gm_j[lifted], atol=1e-5)
        np.testing.assert_allclose(gd_t.numpy()[lifted], gd_j[lifted], atol=1e-5)
        assert np.isfinite(gd_t.numpy()).all() and np.isfinite(gm_t.numpy()).all()

    @pytest.mark.parametrize("press_depth", [None, (0.5, 1.2)])
    def test_render_under_the_bin_rule(self, calibs, press_depth):
        _, _, cal_j, cal_t = calibs
        hm = _press_maps(2)
        pd_t = None if press_depth is None else torch.tensor(press_depth)
        pd_j = None if press_depth is None else jnp.asarray(press_depth)
        rgb_t = toptical.render(cal_t, torch.from_numpy(hm), press_depth=pd_t).numpy()
        rgb_j = np.asarray(joptical.render(cal_j, jnp.asarray(hm), press_depth=pd_j))
        assert rgb_t.shape == (2,) + HW + (3,) and np.all((rgb_t >= 0) & (rgb_t <= 1))

        def grads(opt, cal, hm, pd):
            if pd is not None:
                hm = opt.shift_height_map(hm, pd)
            d, _ = opt.compute_gel_deformation(cal, hm)
            gm, gd = opt.generate_normals(cal, -d / cal.sensor_params.pixmm)
            return gm, gd

        gm_t, gd_t = grads(toptical, cal_t, torch.from_numpy(hm), pd_t)
        gm_j, gd_j = grads(joptical, cal_j, jnp.asarray(hm), pd_j)
        nb = cal_t.sensor_params.num_bins
        bins_t = [b.numpy() for b in toptical.lut_bins(cal_t, gm_t, gd_t)]
        gm_j, gd_j = np.asarray(gm_j), np.asarray(gd_j)
        x_binr, y_binr = np.float32(0.5 * np.pi / (nb - 1)), np.float32(2.0 * np.pi / (nb - 1))
        t_mag = np.clip(np.floor(gm_j / x_binr), 0, nb - 1)
        t_dir = np.clip(np.floor((gd_j + np.float32(np.pi)) / y_binr), 0, nb - 1)
        spread = lut_spread(cal_t.poly_lut.numpy(), cal_t.features.numpy(), nb)
        held = assert_bin_rule(rgb_t, rgb_j, gm_j, gd_j, nb, spread, bins_t=bins_t, bins_j=[t_mag, t_dir])
        assert held > 0.3
