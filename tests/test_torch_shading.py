"""The port's bilinear, shadow and compact shading paths against JAX, on the CPU.

Images are compared under the bin rule of ``_torch_bins`` (out of contact
the gradient is float noise, so its direction bin is not reproducible).
The shadow tests run at 48x64 with an attachment kernel and a march step
five times the calibration's: at the calibration's own values a 48x64 image
has a one-pixel attachment box, so no boundary ring and no shadow at all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _reference_oracle import sphere_height_map
from _torch_bins import assert_bin_rule, exempt_pixels, lut_spread, setup_torch
from tacex_tpu.ops import blur as jblur
from tacex_tpu.sensors.gelsight.taxim import calib as jcalib
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch.ops import blur as tblur
from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

HW = (48, 64)
SHADOW_OVERRIDES = {"simulator": {"shadow_attachment_kernel_size_rel": [0.04, 0.052], "shadow_step_rel": [0.01, 0.013]}}


@pytest.fixture(scope="module")
def calibs():
    return (jcalib.load_calib(param_overrides=SHADOW_OVERRIDES).at_resolution(HW),
            tcalib.load_calib(param_overrides=SHADOW_OVERRIDES).at_resolution(HW))


def _press_maps(n: int) -> np.ndarray:
    h, w = HW
    maps = [
        sphere_height_map(h, w, radius_mm=4.0, pixmm=0.0295 * 640 / w, center=(h / 2.0 + i, w / 2.0 - i)) - (0.8 + 0.3 * i)
        for i in range(n)
    ]
    return np.stack(maps).astype(np.float32)


def _frame(opt, cal, hm):
    """(raw shade, deformed in px, pin mask, grad_mag, grad_dir) of ``hm``."""
    deformed, mask = opt.compute_gel_deformation(cal, hm)
    deformed_px = deformed / cal.sensor_params.pixmm
    grad_mag, grad_dir = opt.generate_normals(cal, -deformed_px)
    return opt.shade(cal, grad_mag, grad_dir), deformed_px, mask, grad_mag, grad_dir


@pytest.fixture(scope="module")
def frames(calibs):
    cal_j, cal_t = calibs
    hm = _press_maps(2)
    frame_j = jax.jit(lambda x: _frame(joptical, cal_j, x))(jnp.asarray(hm))
    return hm, [np.asarray(x) for x in frame_j], _frame(toptical, cal_t, torch.from_numpy(hm))


@pytest.mark.parametrize("kernel", [(3, 3), (2, 2), (2, 3), (4, 1), (1, 5), (1, 1), (0, 0)])
def test_box_dilate_matches_jax(kernel):
    mask = np.random.default_rng(0).random((2, 9, 11)) < 0.08
    out = tblur.box_dilate(torch.from_numpy(mask), kernel).numpy()
    np.testing.assert_array_equal(out, np.asarray(jblur.box_dilate(jnp.asarray(mask), kernel)))
    assert out.dtype == bool and out.sum() >= mask.sum()


def test_shadow_table_matches_jax(calibs):
    cal_j, cal_t = calibs
    np.testing.assert_array_equal(cal_t.shadow_table.numpy(), np.asarray(cal_j.shadow_table))
    np.testing.assert_array_equal(cal_t.shadow_fan_angles.numpy(), np.asarray(cal_j.shadow_fan_angles))
    assert (tcalib.SHADOW_DEPTH_0, tcalib.SHADOW_HEIGHT_IDX_OFFSET) == (jcalib.SHADOW_DEPTH_0, jcalib.SHADOW_HEIGHT_IDX_OFFSET)
    assert cal_t.to("cpu").shadow_table.shape == cal_t.shadow_table.shape


def test_shadow_compact_equals_the_dense_oracle(calibs, frames):
    _, cal_t = calibs
    _, _, (raw, deformed_px, mask, _, grad_dir) = frames
    boundary, _, _ = toptical._shadow_geometry(cal_t, deformed_px, mask, grad_dir)
    assert int(boundary.sum(dim=(-2, -1)).min()) > 50, "no boundary ring: the shadow pass is not exercised"
    compact = toptical._shadow_pass_compact(cal_t, raw, deformed_px, mask, grad_dir)
    dense = torch.stack([toptical._shadow_pass_dense(cal_t, raw[i], deformed_px[i], mask[i], grad_dir[i]) for i in range(2)])
    assert torch.equal(compact, dense)
    assert float((compact != raw).float().mean()) > 0.02, "no pixel was shadowed"
    # missing sources can only remove darkening: the composite is a minimum
    small = toptical._shadow_pass_compact(cal_t, raw, deformed_px, mask, grad_dir, capacity=40)
    assert bool((small >= dense).all()) and not torch.equal(small, dense)


def test_shadow_compact_matches_jax(calibs, frames):
    """The same frame (JAX's, so that both sides start from equal bins)
    through both compact passes."""
    cal_j, cal_t = calibs
    _, (raw, deformed_px, mask, _, grad_dir), _ = frames
    out_j = jax.jit(lambda *a: joptical._shadow_pass_compact(cal_j, *a))(*map(jnp.asarray, (raw, deformed_px, mask, grad_dir)))
    out_t = toptical._shadow_pass_compact(cal_t, *(torch.from_numpy(np.array(x)) for x in (raw, deformed_px, mask, grad_dir)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6)


@pytest.mark.parametrize(
    "kwargs",
    [dict(with_shadow=True), dict(compact_capacity=HW[0] * HW[1]), dict(compact_capacity=64)],
    ids=["shadow", "compact_full", "compact_64"],
)
def test_render_matches_jax_under_the_bin_rule(calibs, frames, kwargs):
    cal_j, cal_t = calibs
    hm, (_, _, _, gm_j, gd_j), (_, _, _, gm_t, gd_t) = frames
    rgb_j = np.asarray(jax.jit(lambda x: joptical.render(cal_j, x, **kwargs))(jnp.asarray(hm)))
    rgb_t = toptical.render(cal_t, torch.from_numpy(hm), **kwargs).numpy()
    nb = cal_t.sensor_params.num_bins
    bins_t = [b.numpy() for b in toptical.lut_bins(cal_t, gm_t, gd_t)]
    bins_j = [b.numpy() for b in toptical.lut_bins(cal_t, torch.from_numpy(np.array(gm_j)), torch.from_numpy(np.array(gd_j)))]
    spread = lut_spread(cal_t.poly_lut.numpy(), cal_t.features.numpy(), nb)
    if "with_shadow" in kwargs:
        # a boundary pixel whose direction or height row differs between the
        # two frames (4 of 186 here) casts another shadow along its rays, so
        # the pixels held to 1e-4 are those whose bins agree and whose
        # shadowed value does not depend on which of the two frames cast it
        frame_t = frames[2]
        frame_j = [torch.from_numpy(np.array(x)) for x in frames[1]]
        cast = [toptical._shadow_pass_compact(cal_t, f[0], f[1], f[2], f[4]) for f in (frame_t, frame_j)]
        same_cast = ((cast[0] - cast[1]).abs().amax(dim=-1) <= 1e-6).numpy()
        agree = (bins_t[0] == bins_j[0]) & (bins_t[1] == bins_j[1])
        assert np.all(exempt_pixels(gm_j, gd_j, nb)[~agree])
        err = np.abs(rgb_t - rgb_j).max(axis=-1)
        held = agree & same_cast
        assert held.mean() > 0.3 and err[held].max() <= 1e-4, (held.mean(), err[held].max())
        assert err.max() <= spread + 1e-4
        assert np.abs(rgb_t - toptical.render(cal_t, torch.from_numpy(hm)).numpy()).max() > 0.01, "no shadow fell"
    else:
        held = assert_bin_rule(rgb_t, rgb_j, gm_j, gd_j, nb, spread, bins_t=bins_t, bins_j=bins_j)
        assert held > 0.3


def test_compact_shade_equals_dense_shade_at_full_capacity(calibs, frames):
    _, cal_t = calibs
    _, _, (raw, _, _, grad_mag, grad_dir) = frames
    full = toptical.shade(cal_t, grad_mag, grad_dir, compact_capacity=HW[0] * HW[1])
    np.testing.assert_allclose(full.numpy(), raw.numpy(), atol=1e-6)
    # beyond the capacity a pixel keeps its halo (magnitude-bin-0) shade
    idx_mag, _ = toptical.lut_bins(cal_t, grad_mag, grad_dir)
    assert int((idx_mag >= 1).sum(dim=(-2, -1)).min()) > 64
    small = toptical.shade(cal_t, grad_mag, grad_dir, compact_capacity=64)
    differs = (small - raw).abs().amax(dim=-1) > 1e-6
    assert bool(differs.any()) and not bool((differs & (idx_mag < 1)).any())
    assert int((~differs & (idx_mag >= 1)).sum(dim=(-2, -1)).min()) >= 64


def test_bilinear_shade_and_its_gradient_match_jax(calibs):
    cal_j, cal_t = calibs
    rng = np.random.default_rng(4)
    grad_mag = rng.uniform(0.0, 1.3, (2,) + HW).astype(np.float32)
    grad_dir = rng.uniform(-np.pi, np.pi, (2,) + HW).astype(np.float32)
    weights = rng.normal(size=(2,) + HW + (3,)).astype(np.float32)

    def total_j(gm, gd):
        out = joptical.shade(cal_j, gm, gd, interp="bilinear")
        return (out * weights).sum(), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(total_j, argnums=(0, 1), has_aux=True))(jnp.asarray(grad_mag), jnp.asarray(grad_dir))
    gm_t = torch.from_numpy(grad_mag).requires_grad_()
    gd_t = torch.from_numpy(grad_dir).requires_grad_()
    out_t = toptical.shade(cal_t, gm_t, gd_t, interp="bilinear")
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5)
    grads_t = torch.autograd.grad((out_t * torch.from_numpy(weights)).sum(), (gm_t, gd_t))
    for g_t, g_j in zip(grads_t, grads_j):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())


def test_bilinear_render_is_differentiable_in_the_height_map(calibs):
    _, cal_t = calibs
    hm = torch.from_numpy(_press_maps(1)).requires_grad_()
    img = toptical.render(cal_t, hm, interp="bilinear")
    (grad,) = torch.autograd.grad(img.sum(), hm)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
    with pytest.raises(ValueError, match="interp"):
        toptical.shade(cal_t, hm.detach(), hm.detach(), interp="cubic")


def test_sensor_with_shadow_runs():
    cfg = gelsight_mini_cfg(with_markers=False, camera_resolution=(64, 48), tactile_img_res=(64, 48), with_shadow=True)
    sensor = GelSightSensor(cfg, num_envs=2, device="cpu")
    depth = torch.from_numpy(0.0285 + (_press_maps(2) + 0.5) / 1000.0)
    _, out = sensor.update(sensor.init_state(), depth)
    rgb = out["tactile_rgb"]
    assert rgb.shape == (2, 48, 64, 3) and bool(torch.isfinite(rgb).all())
    assert bool((out["indentation_depth"] > 0).all())
    cfg = cfg.copy()
    cfg.optical_sim_cfg.with_shadow = False
    plain = GelSightSensor(cfg, num_envs=2, device="cpu")
    _, out_plain = plain.update(plain.init_state(), depth)
    # at 48x64 the calibration's attachment box is one pixel: the shadow path
    # runs its blurs and composites nothing
    np.testing.assert_allclose(rgb.numpy(), out_plain["tactile_rgb"].numpy(), atol=1e-6)
