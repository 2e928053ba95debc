"""Linear image resize with the weights of ``jax.image.resize``.

``jax.image.resize(method="linear")`` is a separable triangle-kernel resample
that widens the kernel by the scale factor when it downsamples (antialiasing)
and renormalises the weights of each output sample. The JAX package resizes
its calibration frames and its camera height maps this way, so the port
builds the same weight matrices (in numpy, float32) and applies them with
one matrix product per resized axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def linear_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of one resized axis."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=32)
def _weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(linear_resize_weights(in_size, out_size)).to(device)


def resize_linear(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Resize ``x`` to ``shape`` along every axis whose size changes.

    The weights of an (axis size, device) pair are moved to the device once
    and reused, so repeated calls copy nothing from the host.
    """
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} does not match rank {x.ndim}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        wmat = _weights_on(int(n_in), int(n_out), x.device)
        x = torch.tensordot(x.movedim(d, -1), wmat, dims=1).movedim(-1, d)
    return x
