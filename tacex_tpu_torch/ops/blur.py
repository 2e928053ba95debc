"""Separable Gaussian blur (PyTorch).

Port of ``tacex_tpu/ops/blur.py``. The kernel sizes, tap weights and
reflect-padded band matrices are computed in numpy exactly as the JAX
package computes them, so both packages blur with the same operators.
``gaussian_blur`` is the plain version (two band-matrix products),
``gaussian_blur_transpose`` its adjoint (the transposed products);
``gaussian_taps`` hands the same taps and reflect rule to the hand-written
deformation-pyramid kernel (``ops/pyramid.py``). ``box_dilate`` grows a
binary mask by a box (the shadow pass's attachment ring).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def kernel_size_for_sigma(sigma: float, eps: float = 1e-5) -> int:
    """Odd kernel size such that the outermost tap weight is below ``eps``."""
    sigma = float(sigma)
    if sigma <= 0:
        return 1
    arg = -2.0 * math.log(eps * math.sqrt(2.0 * math.pi) * sigma)
    if arg <= 0:
        return 1
    return int(round(math.sqrt(arg) * sigma)) // 2 * 2 + 1


@functools.lru_cache(maxsize=256)
def _gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    x = np.linspace(-(ksize - 1) * 0.5, (ksize - 1) * 0.5, num=ksize)
    pdf = np.exp(-0.5 * (x / max(sigma, 1e-12)) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def reflect_index(j: int, n: int) -> int:
    """Single reflection about the edges (no edge repeat), as the band matrix
    folds it: -1 -> 1, n -> n - 2."""
    if j < 0:
        j = -j
    if j >= n:
        j = 2 * (n - 1) - j
    return j


@functools.lru_cache(maxsize=256)
def _band_matrix(n: int, sigma: float, ksize: int) -> np.ndarray:
    """Dense (n, n) Gaussian blur operator with reflect padding folded in."""
    ker = _gaussian_kernel1d(sigma, ksize)
    p = (ksize - 1) // 2
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(ksize):
            m[i, reflect_index(i + t - p, n)] += ker[t]
    return m


def gaussian_taps(sigma: float) -> np.ndarray:
    """The ``ksize`` float32 taps of a 1-D blur along one axis.

    Output ``i`` of a blur along an axis of length ``n`` is
    ``sum_t taps[t] * x[reflect_index(i + t - p, n)]`` with
    ``p = (ksize - 1) // 2``: the same sum the band matrix forms.
    """
    return _gaussian_kernel1d(float(sigma), kernel_size_for_sigma(float(sigma)))


def _blur_along(img: torch.Tensor, sigma: float, ksize: int, axis: int) -> torch.Tensor:
    """Gaussian blur along ``axis`` (1=H, 2=W) of a (B, H, W) tensor."""
    if ksize == 1:
        return img
    n = img.shape[axis]
    m = torch.from_numpy(_band_matrix(n, float(sigma), int(ksize))).to(img.device)
    if axis == 1:
        return torch.matmul(m, img)
    return torch.matmul(img, m.T)


def gaussian_blur_transpose(img: torch.Tensor, sigma_xy: tuple[float, float]) -> torch.Tensor:
    """The adjoint of ``gaussian_blur`` on (B, H, W) images: the transposed
    band matrices, W pass first. At the borders the folded-in reflection
    makes it differ from the blur itself."""
    sx, sy = float(sigma_xy[0]), float(sigma_xy[1])
    kx, ky = kernel_size_for_sigma(sx), kernel_size_for_sigma(sy)
    x = img
    if kx > 1:
        x = torch.matmul(x, torch.from_numpy(_band_matrix(x.shape[2], sx, kx)).to(x.device))
    if ky > 1:
        x = torch.matmul(torch.from_numpy(_band_matrix(x.shape[1], sy, ky)).to(x.device).T, x)
    return x


def gaussian_blur(
    img: torch.Tensor,
    sigma_xy: tuple[float, float],
    kernel_size: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Blur ``img`` with a separable Gaussian.

    ``img`` is ``(..., H, W)`` or ``(..., H, W, C)`` (a trailing axis of size
    <= 4 is channels). ``sigma_xy = (sigma_x, sigma_y)``: x blurs along W,
    y along H. The H pass runs first, as in the JAX package.
    """
    sx, sy = float(sigma_xy[0]), float(sigma_xy[1])
    if kernel_size is None:
        kx, ky = kernel_size_for_sigma(sx), kernel_size_for_sigma(sy)
    else:
        kx, ky = int(kernel_size[0]), int(kernel_size[1])

    has_channels = img.ndim >= 3 and img.shape[-1] <= 4
    if has_channels:
        ch = img.shape[-1]
        spatial = tuple(img.shape[-3:-1])
        lead = tuple(img.shape[:-3])
        x = img.reshape((-1,) + spatial + (ch,)).movedim(-1, 1).reshape((-1,) + spatial)
    else:
        spatial = tuple(img.shape[-2:])
        lead = tuple(img.shape[:-2])
        x = img.reshape((-1,) + spatial)

    x = _blur_along(x, sy, ky, axis=1)
    x = _blur_along(x, sx, kx, axis=2)

    if has_channels:
        x = x.reshape((-1, ch) + spatial).movedim(1, -1)
        return x.reshape(lead + spatial + (ch,))
    return x.reshape(lead + spatial)


def box_dilate(mask: torch.Tensor, kernel_hw: tuple[int, int]) -> torch.Tensor:
    """Binary dilation of a (..., H, W) bool mask by a (kh, kw) box, as a
    max-pool anchored like scipy's 'same' convolution with a ones kernel:
    output ``i`` covers ``[i - k // 2, i + (k - 1) // 2]``, which is
    asymmetric for even kernels. ``max_pool2d`` only pads symmetrically, so
    the pad is explicit."""
    kh, kw = max(int(kernel_hw[0]), 1), max(int(kernel_hw[1]), 1)
    if kh == 1 and kw == 1:
        return mask
    x = mask.to(torch.float32).reshape((-1, 1) + tuple(mask.shape[-2:]))
    x = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2), value=float("-inf"))
    return (F.max_pool2d(x, (kh, kw), stride=1) > 0).reshape(mask.shape)
