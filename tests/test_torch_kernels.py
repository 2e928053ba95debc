"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up jax). Without a
CUDA device every test here skips. Tolerance atol 1e-5: the kernels sum in
another order than the plain versions, and nvcc contracts to FMA.
"""

import numpy as np
import pytest
import torch

from _torch_bins import setup_torch
from tacex_tpu_torch.ops import _build
from tacex_tpu_torch.ops import lut_shade as tlut
from tacex_tpu_torch.ops import pyramid as tpyr
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

# the sensor's pyramid at h x w: six pyramid levels, then the final blur
_SIM = tcalib.load_params(tcalib.default_calib_folder())[0]


def sensor_sigmas(hw):
    return tuple(_SIM.deform_pyramid_sigma(hw)) + (_SIM.deform_final_sigma(hw),)


SLICE_SIGMAS_24x32 = sensor_sigmas((24, 32))
SIGMAS = ((3.0, 2.2), (1.5, 1.1), (0.8, 0.6), (1.0, 0.75))
# the design each image size below takes: 0 a warp per image, else the CTAs of its cluster
# (9: the global-memory design, for an image no cluster holds)
PLANS = {(24, 32): 0, (32, 32): 0, (48, 64): 1, (120, 160): 2, (180, 240): 4, (240, 320): 8, (480, 640): 9}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape,sigmas",
    [
        ((64, 24, 32), SLICE_SIGMAS_24x32),  # a warp per image
        ((256, 32, 32), sensor_sigmas((32, 32))),  # a warp per image: the Factory fingers' 2N images
        ((5, 48, 64), SIGMAS),  # a one-CTA cluster per image
        ((3, 24, 32), SLICE_SIGMAS_24x32),  # N not a multiple of the 8 images a block holds
        ((2, 240, 320), sensor_sigmas((240, 320))),  # the default sensor: a cluster of 8 CTAs
        ((2, 120, 160), sensor_sigmas((120, 160))),  # a cluster of 2 CTAs
        ((2, 180, 240), sensor_sigmas((180, 240))),  # a cluster of 4 CTAs
        ((2, 480, 640), sensor_sigmas((480, 640))),  # the calibration's frame: the global-memory design
    ],
)
def test_pyramid_kernel_matches_plain(cuda, shape, sigmas):
    h, w = shape[1:]
    taps, ky, kx = tpyr._packed_taps(tuple((float(sx), float(sy)) for sx, sy in sigmas), h, w)
    plan = _build.load_library().tacex_deformation_pyramid_plan(
        h, w, taps.ctypes.data, ky.ctypes.data, kx.ctypes.data, len(ky)
    )
    assert plan == PLANS[(h, w)]
    rng = np.random.default_rng(2)
    joined = torch.from_numpy(rng.uniform(-1, 2, shape).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(rng.random(shape) < 0.2).to(cuda)
    before = tpyr.deformation_pyramid.launches
    out = tpyr.deformation_pyramid(joined, mask, sigmas)
    assert tpyr.deformation_pyramid.launches == before + 1
    ref = tpyr.deformation_pyramid_plain(joined, mask, sigmas)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_lut_shade_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    n, p, rows = 64, 768, 15625
    idx = torch.from_numpy(rng.integers(0, rows, (n, p)).astype(np.int32)).to(cuda)
    feats = torch.from_numpy((rng.uniform(0, 640, (6, p)) ** 2).astype(np.float32)).to(cuda)
    table = torch.from_numpy((rng.normal(size=(rows, 18)) * 1e-6).astype(np.float32)).to(cuda)
    before = tlut.lut_shade.launches
    out = tlut.lut_shade(idx, feats, table)
    assert tlut.lut_shade.launches == before + 1
    torch.testing.assert_close(out, tlut.lut_shade_plain(idx, feats, table), atol=1e-5, rtol=0)
    idir = (idx % 125).contiguous()
    feats = torch.from_numpy(rng.normal(size=(6, p)).astype(np.float32)).to(cuda)
    tabs = torch.from_numpy(rng.normal(size=(18, 128)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(
        tlut.dir_row_shade(idir, feats, tabs), tlut.lut_shade_plain(idir, feats, tabs.T), atol=1e-5, rtol=0
    )


@pytest.mark.parametrize("n,p", [(64, 768), (1, 766), (3, 76801)], ids=["frame", "ragged", "odd_rows"])
def test_lut_shade_bf16_kernel_matches_plain(cuda, n, p):
    """K2's bf16-table entry (36-byte rows, 4-byte loads) against the plain
    version on the same bf16 table, at a whole frame, a ragged P and a P
    whose rows start at every 4-byte offset; its launches count apart from
    the f32 entry's. A row outside the table gives NaN."""
    rng = np.random.default_rng(8)
    rows = 15625
    idx = torch.from_numpy(rng.integers(0, rows, (n, p)).astype(np.int32)).to(cuda)
    feats = torch.from_numpy((rng.uniform(0, 640, (6, p)) ** 2).astype(np.float32)).to(cuda)
    table = torch.from_numpy((rng.normal(size=(rows, 18)) * 1e-6).astype(np.float32)).to(cuda).to(torch.bfloat16)
    before, before_f32 = tlut.lut_shade.bf16_launches, tlut.lut_shade.launches
    out = tlut.lut_shade(idx, feats, table)
    assert tlut.lut_shade.bf16_launches == before + 1 and tlut.lut_shade.launches == before_f32
    torch.testing.assert_close(out, tlut.lut_shade_plain(idx, feats, table), atol=1e-5, rtol=0)
    idx[0, -1] = rows
    out = tlut.lut_shade(idx, feats, table)
    assert torch.isnan(out[0, -1]).all() and torch.isfinite(out[0, :-1]).all()


def test_pyramid_kernel_refuses_an_image_it_cannot_hold(cuda):
    """The image no cluster of 8 CTAs holds (the calibration's 480x640 frame
    with the sensor's sigmas) is no longer refused: the plan sends it to the
    global-memory design, which launches and agrees with the plain version
    to 1e-5. The kernel still refuses a blur wider than the image reflects."""
    sigmas = sensor_sigmas((480, 640))
    taps, ky, kx = tpyr._packed_taps(tuple((float(sx), float(sy)) for sx, sy in sigmas), 480, 640)
    plan = _build.load_library().tacex_deformation_pyramid_plan(
        480, 640, taps.ctypes.data, ky.ctypes.data, kx.ctypes.data, len(ky)
    )
    assert plan == tpyr.GLOBAL_DESIGN
    rng = np.random.default_rng(3)
    joined = torch.from_numpy(rng.uniform(-1, 2, (1, 480, 640)).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(rng.random((1, 480, 640)) < 0.2).to(cuda)
    before = tpyr.deformation_pyramid.launches
    out = tpyr.deformation_pyramid(joined, mask, sigmas)
    assert tpyr.deformation_pyramid.launches == before + 1
    torch.testing.assert_close(out, tpyr.deformation_pyramid_plain(joined, mask, sigmas), atol=1e-5, rtol=0)
    x = torch.zeros((1, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="wider than"):
        tpyr.deformation_pyramid(x, x.bool(), ((20.0, 20.0),))


def test_lut_shade_kernel_ragged_pixels(cuda):
    """P = 766: the last 4-pixel group holds 2 pixels, and index rows are not
    16-byte aligned; one env. Rows outside the table give NaN."""
    rng = np.random.default_rng(6)
    n, p, rows = 1, 766, 15625
    idx = torch.from_numpy(rng.integers(0, rows, (n, p)).astype(np.int32)).to(cuda)
    feats = torch.from_numpy(rng.normal(size=(6, p)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(rows, 18)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(tlut.lut_shade(idx, feats, table), tlut.lut_shade_plain(idx, feats, table),
                               atol=1e-5, rtol=0)
    idx[0, -1] = rows
    out = tlut.lut_shade(idx, feats, table)
    assert torch.isnan(out[0, -1]).all() and torch.isfinite(out[0, :-1]).all()


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    x = torch.zeros((2, 24, 32), device=cuda)
    with pytest.raises(ValueError, match="bool"):
        tpyr.deformation_pyramid(x, x, SLICE_SIGMAS_24x32)
    with pytest.raises(ValueError, match="contiguous"):
        tpyr.deformation_pyramid(x.transpose(1, 2).contiguous().transpose(1, 2), x.bool(), SLICE_SIGMAS_24x32)
    idx = torch.zeros((2, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        tlut.lut_shade(idx, torch.zeros((6, 8), device=cuda), torch.zeros((5, 18), device=cuda))


def test_pyramid_gradient_is_its_backward_kernel_and_lut_refuses_grad(cuda):
    """A CUDA ``joined`` that requires grad gives a result whose gradient is
    K1's backward kernel (one launch, equal to the plain adjoint); K2 has no
    backward kernel, so an input of it that requires grad still raises."""
    rng = np.random.default_rng(4)
    for shape, sigmas in (((6, 24, 32), SLICE_SIGMAS_24x32), ((2, 48, 64), SIGMAS),
                          ((2, 12, 16), ((7.0, 4.6), (1.0, 1.0), (7.0, 4.6)))):
        joined = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda).requires_grad_(True)
        mask = torch.from_numpy(rng.random(shape) < 0.3).to(cuda)
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
        out = tpyr.deformation_pyramid(joined, mask, sigmas)
        assert out.grad_fn is not None
        before = tpyr.deformation_pyramid.backward_launches
        (grad,) = torch.autograd.grad(out, joined, g)
        assert tpyr.deformation_pyramid.backward_launches == before + 1
        ref = tpyr.deformation_pyramid_backward_plain(g, mask, sigmas)
        assert float((grad - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    with torch.no_grad():
        assert tpyr.deformation_pyramid(joined, mask, sigmas).grad_fn is None
    idx = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    feats, table = torch.zeros((6, 8), device=cuda), torch.zeros((5, 18), device=cuda)
    for grad_feats, grad_table in ((True, False), (False, True)):
        with pytest.raises(RuntimeError, match="no backward kernel"):
            tlut.lut_shade(idx, feats.clone().requires_grad_(grad_feats), table.clone().requires_grad_(grad_table))
    assert tlut.lut_shade(idx, feats, table).shape == (2, 8, 3)


def test_compact_shade_equals_dense_shade_on_the_card(cuda):
    """At ``compact_capacity = h * w`` the compact path (K2 over the 125-row
    subtable, then K2 over the compacted full-table rows) is the dense shade."""
    hw = (48, 64)
    calib = tcalib.load_calib().at_resolution(hw).to(cuda)
    rng = np.random.default_rng(7)
    grad_mag = torch.from_numpy(rng.uniform(0.0, 1.3, (3,) + hw).astype(np.float32)).to(cuda)
    grad_mag[:, :20] = 0.0  # a halo of magnitude-bin-0 pixels
    grad_dir = torch.from_numpy(rng.uniform(-np.pi, np.pi, (3,) + hw).astype(np.float32)).to(cuda)
    before = tlut.lut_shade.launches
    dense = toptical.shade(calib, grad_mag, grad_dir)
    compact = toptical.shade(calib, grad_mag, grad_dir, compact_capacity=hw[0] * hw[1])
    assert tlut.lut_shade.launches == before + 3
    torch.testing.assert_close(compact, dense, atol=1e-5, rtol=0)
