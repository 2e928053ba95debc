"""Masked Gaussian deformation pyramid: CUDA kernel and its plain version.

``deformation_pyramid`` runs the hand-written kernel of
``csrc/pyramid.cu`` (the port of ``tacex_tpu/ops/pallas_pyramid.py``) on a
CUDA tensor, and the plain PyTorch version on a CPU tensor. It never falls
back from one to the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .blur import gaussian_blur, gaussian_taps

MAX_LEVELS = 8
MAX_TAPS = 768
# tacex_deformation_pyramid_plan's code for the global-memory design (0 is
# the warp design, 1..8 a cluster of that many CTAs)
GLOBAL_DESIGN = 9


def deformation_pyramid_plain(joined: torch.Tensor, mask: torch.Tensor, sigmas) -> torch.Tensor:
    """Blur with every ``(sigma_x, sigma_y)`` level in turn; after every level
    but the last, pixels under ``mask`` are pinned back to ``joined``."""
    x = joined
    for i, s in enumerate(sigmas):
        x = gaussian_blur(x, s)
        if i < len(sigmas) - 1:
            x = torch.where(mask, joined, x)
    return x


@functools.lru_cache(maxsize=32)
def _packed_taps(sigmas: tuple, h: int, w: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(taps, ky, kx): every level's H-pass then W-pass taps, concatenated."""
    if not 1 <= len(sigmas) <= MAX_LEVELS:
        raise ValueError(f"the pyramid kernel takes 1..{MAX_LEVELS} levels, got {len(sigmas)}")
    taps, ky, kx = [], [], []
    for sx, sy in sigmas:
        ty, tx = gaussian_taps(sy), gaussian_taps(sx)
        if (len(ty) - 1) // 2 > h - 1 or (len(tx) - 1) // 2 > w - 1:
            raise ValueError(f"blur of sigma {(sx, sy)} is wider than a {h}x{w} image reflects")
        taps += [ty, tx]
        ky.append(len(ty))
        kx.append(len(tx))
    flat = np.concatenate(taps).astype(np.float32)
    if flat.size > MAX_TAPS:
        raise ValueError(f"the pyramid kernel takes {MAX_TAPS} taps in all, got {flat.size}")
    return flat, np.asarray(ky, np.int32), np.asarray(kx, np.int32)


@functools.lru_cache(maxsize=32)
def _kernel_args(sigmas: tuple, h: int, w: int) -> tuple:
    """The kernel's design for an ``h`` x ``w`` image and the packed taps as
    it takes them (pointers, level count); the arrays stay alive in the cache
    beside their pointers."""
    taps, ky, kx = _packed_taps(sigmas, h, w)
    lib = _build.load_library()
    plan = lib.tacex_deformation_pyramid_plan(h, w, taps.ctypes.data, ky.ctypes.data, kx.ctypes.data, len(ky))
    if plan < 0:
        raise ValueError(f"the pyramid kernel refuses the taps of sigmas {sigmas} for a {h}x{w} image")
    return (taps, ky, kx), plan, taps.ctypes.data, ky.ctypes.data, kx.ctypes.data, len(ky)


def deformation_pyramid(joined: torch.Tensor, mask: torch.Tensor, sigmas) -> torch.Tensor:
    """(N, H, W) f32 ``joined`` and bool ``mask`` -> (N, H, W) f32.

    ``sigmas``: ``((sigma_x, sigma_y), ...)``, the pyramid levels then the
    final blur. A CPU tensor takes the plain version (differentiable); a CUDA
    tensor launches the kernel or raises: a ``ValueError`` names levels,
    taps or a blur wider than the image reflects, a ``RuntimeError`` a
    ``joined`` that requires grad (the kernel writes a result without a
    ``grad_fn``). Every image size is taken: the warp design, a cluster of
    up to 8 CTAs, or, where no cluster holds the image (480x640 with the
    sensor's sigmas), the global-memory design with a scratch image.
    """
    sigmas = tuple((float(sx), float(sy)) for sx, sy in sigmas)
    if joined.device.type == "cpu":
        return deformation_pyramid_plain(joined, mask, sigmas)
    if joined.device.type != "cuda":
        raise ValueError(f"deformation_pyramid: unsupported device {joined.device}")
    if torch.is_grad_enabled() and joined.requires_grad:
        raise RuntimeError(
            "deformation_pyramid: the CUDA kernel has no backward kernel, so no gradient can reach `joined`; "
            "detach it, or differentiate on the CPU"
        )
    if joined.dtype != torch.float32 or joined.ndim != 3:
        raise ValueError(f"joined must be (N, H, W) float32, got {tuple(joined.shape)} {joined.dtype}")
    if mask.dtype != torch.bool or mask.shape != joined.shape or mask.device != joined.device:
        raise ValueError("mask must be a bool tensor of joined's shape, on joined's device")
    if not (joined.is_contiguous() and mask.is_contiguous()):
        raise ValueError("joined and mask must be contiguous")
    n, h, w = joined.shape
    _, plan, taps, ky, kx, levels = _kernel_args(sigmas, h, w)
    lib = _build.load_library()
    out = torch.empty_like(joined)
    with torch.cuda.device(joined.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan == GLOBAL_DESIGN:
            scratch = torch.empty_like(joined)
            err = lib.tacex_deformation_pyramid_global(
                joined.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), taps, ky, kx, levels, n, h, w,
                stream,
            )
        else:
            err = lib.tacex_deformation_pyramid(
                joined.data_ptr(), mask.data_ptr(), out.data_ptr(), taps, ky, kx, levels, n, h, w, stream
            )
    if err != 0:
        raise RuntimeError(f"deformation_pyramid kernel launch failed: CUDA error {err}")
    deformation_pyramid.launches += 1
    return out


deformation_pyramid.launches = 0
