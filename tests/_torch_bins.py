"""Shared helpers of the PyTorch-port parity tests.

The Taxim shade of a pixel depends on which LUT bin its gradient falls in.
Out of contact the gradient is float noise (tan|grad| ~ 1e-8), so its
direction bin is decided by the order of the float operations in the blur,
and two correct implementations may pick different rows there. The
"bin rule" below is how the tests compare tactile images around that:

  * where the port's and JAX's (magnitude, direction) bins agree, RGB agrees
    to 1e-4;
  * where they disagree, JAX's tan|grad| is below 1e-5 (the noise floor), or
    the gradient lies within 1e-5 (relative) of a bin edge;
  * nowhere do the images differ by more than the LUT's magnitude-bin-0
    direction spread at the working resolution.

When the two sides' inputs themselves differ (whole env steps, where the
height map comes from f32 world poses), ``edge_bins`` widens "near a bin
edge" to an absolute distance in bin units that covers that input noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NOISE_FLOOR = 1e-5
EDGE_RTOL = 1e-5
RGB_ATOL = 1e-4
# The Factory fingers' 32x32 gel keeps f32 blur noise gradients up to tan
# ~2e-5 out of contact, whose direction, and so whose magnitude-bin-0 row,
# the order of the sums decides: their images take this floor.
FINGER_NOISE_FLOOR = 1e-4


def setup_torch() -> None:
    """Full-f32 matmuls and convolutions; two threads beside the xdist workers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)


def bin_coords(grad_mag: np.ndarray, grad_dir: np.ndarray, num_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """Continuous (magnitude, direction) bin coordinates; edges are integers."""
    x_binr = 0.5 * math.pi / (num_bins - 1)
    y_binr = 2.0 * math.pi / (num_bins - 1)
    return grad_mag.astype(np.float64) / x_binr, (grad_dir.astype(np.float64) + math.pi) / y_binr


def exempt_pixels(
    grad_mag: np.ndarray, grad_dir: np.ndarray, num_bins: int, edge_bins: float | None = None,
    noise_floor: float = NOISE_FLOOR,
) -> np.ndarray:
    """Pixels whose bin two correct implementations may legitimately disagree on."""
    t_mag, t_dir = bin_coords(grad_mag, grad_dir, num_bins)

    def near_edge(t):
        margin = EDGE_RTOL * np.maximum(np.abs(t), 1.0) if edge_bins is None else edge_bins
        return np.abs(t - np.round(t)) <= margin

    return (np.tan(grad_mag.astype(np.float64)) < noise_floor) | near_edge(t_mag) | near_edge(t_dir)


def lut_spread(poly_lut: np.ndarray, features: np.ndarray, num_bins: int) -> float:
    """Largest change of a pixel's shade across the direction bins of
    magnitude bin 0. ``poly_lut``: (nb*nb, 6, 3); ``features``: (6, P)."""
    lut0 = poly_lut.reshape(num_bins, num_bins, 6, 3)[0].astype(np.float64)
    shades = np.einsum("kp,dkc->pdc", features.astype(np.float64), lut0)
    return float((shades.max(axis=1) - shades.min(axis=1)).max())


def assert_bin_rule(
    rgb_t, rgb_j, grad_mag_j, grad_dir_j, num_bins, spread, bins_t=None, bins_j=None, edge_bins=None,
    noise_floor=NOISE_FLOOR,
) -> float:
    """Check two (N, h, w, 3) images under the bin rule; returns the share of
    pixels held to ``RGB_ATOL``. Without the bins of both sides, every pixel
    that is not exempt is held to ``RGB_ATOL``."""
    rgb_t, rgb_j = np.asarray(rgb_t), np.asarray(rgb_j)
    assert rgb_t.shape == rgb_j.shape, (rgb_t.shape, rgb_j.shape)
    err = np.abs(rgb_t - rgb_j).max(axis=-1)
    exempt = exempt_pixels(np.asarray(grad_mag_j), np.asarray(grad_dir_j), num_bins, edge_bins, noise_floor)
    if bins_t is not None:
        agree = np.ones(err.shape, bool)
        for a, b in zip(bins_t, bins_j):
            agree &= np.asarray(a) == np.asarray(b)
        assert np.all(exempt[~agree]), "bins disagree at pixels above the noise floor and off bin edges"
        held = agree
    else:
        held = ~exempt
    assert err[held].max(initial=0.0) <= RGB_ATOL, err[held].max()
    assert err.max() <= spread + RGB_ATOL, (err.max(), spread)
    return float(held.mean())
