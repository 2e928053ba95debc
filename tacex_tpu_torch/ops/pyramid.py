"""Masked Gaussian deformation pyramid: CUDA kernel and its plain version.

``deformation_pyramid`` runs the hand-written kernel of
``csrc/pyramid.cu`` (the port of ``tacex_tpu/ops/pallas_pyramid.py``) on a
CUDA tensor, and the plain PyTorch version on a CPU tensor. It never falls
back from one to the other. Its gradient in ``joined`` on the card is a
second kernel of the same source (``deformation_pyramid_backward``), the
explicit adjoint whose plain version is
``deformation_pyramid_backward_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build
from .blur import gaussian_blur, gaussian_blur_transpose, gaussian_taps

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


def _check_inputs(name: str, x: torch.Tensor, mask: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"{name} must be (N, H, W) float32, got {tuple(x.shape)} {x.dtype}")
    if mask.dtype != torch.bool or mask.shape != x.shape or mask.device != x.device:
        raise ValueError(f"mask must be a bool tensor of {name}'s shape, on {name}'s device")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name} and mask must be contiguous")


def _forward_kernel(joined: torch.Tensor, mask: torch.Tensor, sigmas: tuple) -> torch.Tensor:
    """Launch the forward kernel on a CUDA ``joined``."""
    _check_inputs("joined", joined, mask)
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


def deformation_pyramid_backward_plain(grad_out: torch.Tensor, mask: torch.Tensor, sigmas) -> torch.Tensor:
    """The gradient in ``joined`` of ``deformation_pyramid_plain`` for the
    cotangent ``grad_out``, as the explicit adjoint (not autograd): for
    the levels from the last to the first, ``gx = B^T g`` with the
    transposed band operators; above the first level the pinned pixels of
    ``gx`` go to ``joined`` and the others on to the level below."""
    sigmas = [(float(sx), float(sy)) for sx, sy in sigmas]
    g = grad_out
    grad_joined = torch.zeros_like(grad_out)
    for i in range(len(sigmas) - 1, 0, -1):
        gx = gaussian_blur_transpose(g, sigmas[i])
        grad_joined = grad_joined + torch.where(mask, gx, 0.0)
        g = torch.where(mask, 0.0, gx)
    return grad_joined + gaussian_blur_transpose(g, sigmas[0])


def deformation_pyramid_backward(grad_out: torch.Tensor, mask: torch.Tensor, sigmas) -> torch.Tensor:
    """(N, H, W) f32 cotangent of the pyramid's output and its bool
    ``mask`` -> the gradient in ``joined``. A CPU tensor takes
    ``deformation_pyramid_backward_plain``; a CUDA tensor launches
    ``tacex_deformation_pyramid_backward`` (two global-memory passes a
    level and a scratch image) or raises."""
    sigmas = tuple((float(sx), float(sy)) for sx, sy in sigmas)
    if grad_out.device.type == "cpu":
        return deformation_pyramid_backward_plain(grad_out, mask, sigmas)
    if grad_out.device.type != "cuda":
        raise ValueError(f"deformation_pyramid_backward: unsupported device {grad_out.device}")
    _check_inputs("grad_out", grad_out, mask)
    n, h, w = grad_out.shape
    _, _, taps, ky, kx, levels = _kernel_args(sigmas, h, w)
    lib = _build.load_library()
    grad_joined = torch.empty_like(grad_out)
    scratch = torch.empty_like(grad_out)
    with torch.cuda.device(grad_out.device):
        err = lib.tacex_deformation_pyramid_backward(
            grad_out.data_ptr(), mask.data_ptr(), grad_joined.data_ptr(), scratch.data_ptr(), taps, ky, kx, levels,
            n, h, w, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"deformation_pyramid backward kernel launch failed: CUDA error {err}")
    deformation_pyramid.backward_launches += 1
    return grad_joined


class _DeformationPyramid(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, joined, mask, sigmas):
        ctx.save_for_backward(mask)
        ctx.sigmas = sigmas
        return _forward_kernel(joined, mask, sigmas)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (mask,) = ctx.saved_tensors
        return deformation_pyramid_backward(grad_out.contiguous(), mask, ctx.sigmas), None, None


def deformation_pyramid(joined: torch.Tensor, mask: torch.Tensor, sigmas) -> torch.Tensor:
    """(N, H, W) f32 ``joined`` and bool ``mask`` -> (N, H, W) f32.

    ``sigmas``: ``((sigma_x, sigma_y), ...)``, the pyramid levels then the
    final blur. A CPU tensor takes the plain version (differentiable); a
    CUDA tensor launches the kernel or raises (a ``ValueError`` names
    levels, taps or a blur wider than the image reflects). A CUDA
    ``joined`` that requires grad gives a result whose ``grad_fn`` launches
    the backward kernel (first order: ``once_differentiable``). Every
    image size is taken: the warp design, a cluster of up to 8 CTAs, or,
    where no cluster holds the image (480x640 with the sensor's sigmas),
    the global-memory design with a scratch image.
    """
    sigmas = tuple((float(sx), float(sy)) for sx, sy in sigmas)
    if joined.device.type == "cpu":
        return deformation_pyramid_plain(joined, mask, sigmas)
    if joined.device.type != "cuda":
        raise ValueError(f"deformation_pyramid: unsupported device {joined.device}")
    if torch.is_grad_enabled() and joined.requires_grad:
        return _DeformationPyramid.apply(joined, mask, sigmas)
    return _forward_kernel(joined, mask, sigmas)


deformation_pyramid.launches = 0
deformation_pyramid.backward_launches = 0
