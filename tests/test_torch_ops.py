"""Parity of the PyTorch port's ops and kernels' plain versions with JAX.

The JAX side runs on the CPU; its Pallas kernels run in interpret mode, as
the JAX package's own tests run them. On the CPU the port's kernels take
their plain versions; ``test_torch_kernels.py`` holds each CUDA kernel to its
plain version on the card.
Tolerances: 1e-6 for a single blur (the same operators, summed in another
order); 1e-5 for the pyramid and the shading (seven blurs deep; features up
to 640^2 = 4.1e5 against a quadratic that cancels).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.ops import blur as jblur
from tacex_tpu.ops.pallas_lut import dir_row_shade as j_dir_row_shade
from tacex_tpu.ops.pallas_lut import dir_row_shade_reference
from tacex_tpu.ops.pallas_pyramid import deformation_pyramid_pallas
from tacex_tpu.sensors.gelsight.taxim import calib as jcalib
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch.ops import blur as tblur
from tacex_tpu_torch.ops import lut_shade as tlut
from tacex_tpu_torch.ops import pyramid as tpyr
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

# the slice's pyramid at 24x32: six pyramid levels, then the final blur
_SIM = tcalib.load_params(tcalib.default_calib_folder())[0]
SLICE_SIGMAS_24x32 = tuple(_SIM.deform_pyramid_sigma((24, 32))) + (_SIM.deform_final_sigma((24, 32)),)
SIGMAS = ((3.0, 2.2), (1.5, 1.1), (0.8, 0.6), (1.0, 0.75))


def _xla_pyramid(joined, mask, sigmas):
    x = joined
    for i, s in enumerate(sigmas):
        x = jblur.gaussian_blur(x, s)
        if i < len(sigmas) - 1:
            x = jnp.where(mask, joined, x)
    return x


class TestBlur:
    @pytest.mark.parametrize("sigma", [0.055, 0.4, 1.525, 2.0, 7.5, 50.0])
    def test_kernel_and_band_matrix_are_byte_identical(self, sigma):
        k = jblur.kernel_size_for_sigma(sigma)
        assert tblur.kernel_size_for_sigma(sigma) == k
        np.testing.assert_array_equal(tblur._gaussian_kernel1d(sigma, k), jblur._gaussian_kernel1d(sigma, k))
        for n in (24, 32, 48):
            if (k - 1) // 2 < n:
                np.testing.assert_array_equal(tblur._band_matrix(n, sigma, k), jblur._band_matrix(n, sigma, k))

    @pytest.mark.parametrize("sigma,n", [(1.525, 24), (7.5, 32), (0.775, 5)])
    def test_taps_and_reflect_rule_rebuild_the_band_matrix(self, sigma, n):
        taps = tblur.gaussian_taps(sigma)
        p = (len(taps) - 1) // 2
        m = np.zeros((n, n), np.float32)
        for i in range(n):
            for t in range(len(taps)):
                m[i, tblur.reflect_index(i + t - p, n)] += taps[t]
        np.testing.assert_array_equal(m, jblur._band_matrix(n, sigma, len(taps)))

    @pytest.mark.parametrize("shape,sigma", [((3, 24, 32), (1.525, 1.525)), ((2, 24, 32, 3), (2.0, 3.0))])
    def test_gaussian_blur_matches_jax(self, shape, sigma):
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        out = tblur.gaussian_blur(torch.from_numpy(x), sigma).numpy()
        ref = np.asarray(jblur.gaussian_blur(jnp.asarray(x), sigma))
        np.testing.assert_allclose(out, ref, atol=1e-6)


class TestPyramid:
    @pytest.mark.parametrize("shape,sigmas", [((3, 24, 32), SLICE_SIGMAS_24x32), ((5, 48, 64), SIGMAS)])
    def test_plain_matches_pallas_interpret_and_xla(self, shape, sigmas):
        rng = np.random.default_rng(1)
        joined = rng.uniform(-1, 2, shape).astype(np.float32)
        mask = rng.random(shape) < 0.2
        out = tpyr.deformation_pyramid(torch.from_numpy(joined), torch.from_numpy(mask), sigmas).numpy()
        xla = np.asarray(_xla_pyramid(jnp.asarray(joined), jnp.asarray(mask), sigmas))
        pallas = np.asarray(
            deformation_pyramid_pallas(jnp.asarray(joined), jnp.asarray(mask), sigmas, block=2, interpret=True)
        )
        np.testing.assert_allclose(out, xla, atol=1e-5)
        np.testing.assert_allclose(out, pallas, atol=1e-5)

    def test_taps_pack_levels_in_order(self):
        taps, ky, kx = tpyr._packed_taps(SLICE_SIGMAS_24x32, 24, 32)
        assert len(ky) == len(kx) == len(SLICE_SIGMAS_24x32)
        off = 0
        for (sx, sy), a, b in zip(SLICE_SIGMAS_24x32, ky, kx):
            np.testing.assert_array_equal(taps[off : off + a], tblur.gaussian_taps(sy))
            np.testing.assert_array_equal(taps[off + a : off + a + b], tblur.gaussian_taps(sx))
            off += a + b
        assert off == taps.size

    def test_blur_wider_than_the_image_is_refused(self):
        with pytest.raises(ValueError, match="wider"):
            tpyr._packed_taps(((7.5, 7.5),), 8, 8)

    def test_other_devices_raise_instead_of_falling_back(self):
        x = torch.zeros((1, 4, 4), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tpyr.deformation_pyramid(x, x.bool(), ((1.0, 1.0),))
        with pytest.raises(ValueError, match="unsupported device"):
            tlut.lut_shade(torch.zeros((1, 4), dtype=torch.int32, device="meta"), None, None)


class TestLutShade:
    @pytest.mark.parametrize("n,p", [(3, 2048), (2, 768)])
    def test_dir_row_shade_matches_reference_and_interpreter(self, n, p):
        rng = np.random.default_rng(3)
        idir = rng.integers(0, 125, (n, p)).astype(np.int32)
        feats = rng.normal(size=(6, p)).astype(np.float32)
        tabs = rng.normal(size=(18, 128)).astype(np.float32)
        out = tlut.dir_row_shade(torch.from_numpy(idir), torch.from_numpy(feats), torch.from_numpy(tabs)).numpy()
        ref = np.asarray(dir_row_shade_reference(jnp.asarray(idir), jnp.asarray(feats), jnp.asarray(tabs)))
        interp = np.asarray(j_dir_row_shade(jnp.asarray(idir), jnp.asarray(feats), jnp.asarray(tabs), interpret=True))
        assert out.shape == (n, p, 3)
        np.testing.assert_allclose(out, ref, atol=1e-5)
        np.testing.assert_allclose(out, interp, atol=1e-5)

    def test_dense_shade_matches_jax_on_the_same_gradients(self):
        """Same (grad_mag, grad_dir) into both shades: the full-table row
        gather sees identical bins, so the images agree everywhere."""
        hw = (24, 32)
        calib_j = jcalib.load_calib().at_resolution(hw)
        calib_t = tcalib.load_calib().at_resolution(hw)
        rng = np.random.default_rng(4)
        gm = rng.uniform(0.0, 1.2, (2,) + hw).astype(np.float32)
        gd = rng.uniform(-np.pi, np.pi, (2,) + hw).astype(np.float32)
        out = toptical.shade(calib_t, torch.from_numpy(gm), torch.from_numpy(gd)).numpy()
        ref = np.asarray(joptical.shade(calib_j, jnp.asarray(gm), jnp.asarray(gd)))
        np.testing.assert_allclose(out, ref, atol=1e-5)
