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
from tacex_tpu_torch.ops import lut_shade as tlut
from tacex_tpu_torch.ops import pyramid as tpyr
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib

setup_torch()

# the slice's pyramid at 24x32: six pyramid levels, then the final blur
_SIM = tcalib.load_params(tcalib.default_calib_folder())[0]
SLICE_SIGMAS_24x32 = tuple(_SIM.deform_pyramid_sigma((24, 32))) + (_SIM.deform_final_sigma((24, 32)),)
SIGMAS = ((3.0, 2.2), (1.5, 1.1), (0.8, 0.6), (1.0, 0.75))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,sigmas", [((64, 24, 32), SLICE_SIGMAS_24x32), ((5, 48, 64), SIGMAS)])
def test_pyramid_kernel_matches_plain(cuda, shape, sigmas):
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


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    x = torch.zeros((2, 24, 32), device=cuda)
    with pytest.raises(ValueError, match="bool"):
        tpyr.deformation_pyramid(x, x, SLICE_SIGMAS_24x32)
    with pytest.raises(ValueError, match="contiguous"):
        tpyr.deformation_pyramid(x.transpose(1, 2).contiguous().transpose(1, 2), x.bool(), SLICE_SIGMAS_24x32)
    idx = torch.zeros((2, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        tlut.lut_shade(idx, torch.zeros((6, 8), device=cuda), torch.zeros((5, 18), device=cuda))
