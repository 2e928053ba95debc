"""Taxim optical simulation, dense path: height map -> tactile RGB (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/taxim/optical.py`` without the
bilinear, compact and shadow paths:

  1. gel-pad deformation: clamp the object height map against the gel rest
     surface, then the masked Gaussian pyramid (kernel ``ops/pyramid.py``);
  2. surface normals by central differences -> gradient (magnitude, direction);
  3. per-pixel shading: bin the gradients into the (num_bins x num_bins) LUT
     and evaluate the quadratic [x^2, y^2, xy, x, y, 1] model from the
     pixel's row (kernel ``ops/lut_shade.py``);
  4. add the background frame, clip to [0, 1].

Out of contact the gradient is float noise (|grad| ~ 1e-8 at 32x24), so its
direction bin, and the shade of those pixels, depends on the order of the
float operations in the blur: any two implementations differ there by up to
the LUT's magnitude-bin-0 direction spread (about 0.12).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ....ops.pyramid import deformation_pyramid
from ....ops.lut_shade import lut_shade
from .calib import TaximCalib


def shift_height_map(height_map: torch.Tensor, press_depth_mm: torch.Tensor) -> torch.Tensor:
    """Place the object so its closest point is ``press_depth_mm`` below the
    gel top. ``press_depth_mm``: (...,)."""
    hm_min = height_map.amin(dim=(-2, -1), keepdim=True)
    return height_map - hm_min - press_depth_mm[..., None, None]


def deformation_inputs(calib: TaximCalib, height_map: torch.Tensor):
    """The pyramid's inputs for ``height_map`` (..., h, w) mm: the height map
    clamped against the gel surface, the pin mask, and the
    ``(sigma_x, sigma_y)`` levels (pyramid levels, then the final blur)."""
    h, w = height_map.shape[-2:]
    sim = calib.sim_params
    pressing_depth = -height_map.amin(dim=(-2, -1), keepdim=True)
    contact_mask = height_map < 0

    gel_map = calib.gel_map
    joined = torch.minimum(height_map, gel_map)
    # pixels pressed deeper than contact_scale * press_depth stay pinned
    mask = ((joined - gel_map) < -pressing_depth * sim.contact_scale) & contact_mask
    sigmas = list(sim.deform_pyramid_sigma((h, w))) + [sim.deform_final_sigma((h, w))]
    return joined, mask, sigmas


def compute_gel_deformation(calib: TaximCalib, height_map: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Deform the gel pad under ``height_map`` (..., h, w) mm (0 = gel top,
    negative = penetration). Returns (deformed (..., h, w) mm, pin mask)."""
    h, w = height_map.shape[-2:]
    joined, mask, sigmas = deformation_inputs(calib, height_map)
    blurred = deformation_pyramid(
        joined.reshape(-1, h, w).contiguous(), mask.reshape(-1, h, w).contiguous(), sigmas
    )
    return blurred.reshape(height_map.shape), mask


def generate_normals(calib: TaximCalib, height_map_px: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient magnitude/direction maps by central differences.

    ``height_map_px``: (..., h, w) in pixel height units (mm / pixmm),
    negated so that bumps point up. Gradients are rescaled into
    full-calibration-resolution pixel units. The double ``where`` keeps the
    NaN-free form of the JAX package (sqrt and atan2 at 0).
    """
    h, w = height_map_px.shape[-2:]
    full_h, full_w = calib.sensor_params.height, calib.sensor_params.width
    top = height_map_px[..., 0 : h - 2, 1 : w - 1]
    bot = height_map_px[..., 2:h, 1 : w - 1]
    left = height_map_px[..., 1 : h - 1, 0 : w - 2]
    right = height_map_px[..., 1 : h - 1, 2:w]
    dzdx = (bot - top) * (0.5 * h / full_h)
    dzdy = (right - left) * (0.5 * w / full_w)

    mag2 = dzdx * dzdx + dzdy * dzdy
    nz = mag2 > 0
    mag_tan = torch.sqrt(torch.where(nz, mag2, 1.0))
    mag_tan = torch.where(nz, mag_tan, 0.0)
    grad_mag = torch.atan(mag_tan)
    sx = torch.where(nz, dzdx, 1.0)
    sy = torch.where(nz, dzdy, 1.0)
    grad_dir = torch.where(nz, torch.atan2(sx, sy), 0.0)

    def pad_edge(x):
        return F.pad(x.reshape(-1, 1, h - 2, w - 2), (1, 1, 1, 1), mode="replicate").reshape(
            height_map_px.shape
        )

    return pad_edge(grad_mag), pad_edge(grad_dir)


def lut_bins(calib: TaximCalib, grad_mag: torch.Tensor, grad_dir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floor-binned (magnitude, direction) LUT indices, int32."""
    nb = calib.sensor_params.num_bins
    x_binr = 0.5 * math.pi / (nb - 1)
    y_binr = 2.0 * math.pi / (nb - 1)
    idx_mag = torch.clamp(torch.floor(grad_mag / x_binr).to(torch.int32), 0, nb - 1)
    idx_dir = torch.clamp(torch.floor((grad_dir + math.pi) / y_binr).to(torch.int32), 0, nb - 1)
    return idx_mag, idx_dir


def shade(calib: TaximCalib, grad_mag: torch.Tensor, grad_dir: torch.Tensor) -> torch.Tensor:
    """Polynomial-LUT shading (..., h, w) -> (..., h, w, 3) from each pixel's
    nearest (floor-binned) LUT row, as ``shade(interp="nearest")`` in JAX."""
    h, w = grad_mag.shape[-2:]
    if (h, w) != calib.resolution:
        raise ValueError(f"gradients {h, w} != calib resolution {calib.resolution}; use calib.at_resolution()")
    nb = calib.sensor_params.num_bins
    idx_mag, idx_dir = lut_bins(calib, grad_mag, grad_dir)
    idx = (idx_mag * nb + idx_dir).reshape(-1, h * w).contiguous()
    out = lut_shade(idx, calib.features, calib.poly_lut.reshape(nb * nb, 18))
    return out.reshape(grad_mag.shape + (3,))


def render(calib: TaximCalib, height_map: torch.Tensor, press_depth: torch.Tensor | None = None) -> torch.Tensor:
    """Tactile RGB (..., h, w, 3) in [0, 1] from height maps (..., h, w) mm
    (0 = gel top, negative = pressed in), without shadows. ``press_depth``
    (...,) mm shifts each map so its minimum sits that far below the gel top."""
    lead = height_map.shape[:-2]
    h, w = height_map.shape[-2:]
    if (h, w) != calib.resolution:
        raise ValueError(f"height map {h, w} != calib resolution {calib.resolution}; use calib.at_resolution()")
    hm = height_map.reshape(-1, h, w).to(torch.float32)
    if press_depth is not None:
        hm = shift_height_map(hm, torch.as_tensor(press_depth, dtype=torch.float32, device=hm.device).expand(lead).reshape(-1))

    deformed, _ = compute_gel_deformation(calib, hm)
    deformed_px = deformed / calib.sensor_params.pixmm
    grad_mag, grad_dir = generate_normals(calib, -deformed_px)
    raw = shade(calib, grad_mag, grad_dir)
    img = torch.clamp(raw + calib.background, 0.0, 1.0)
    return img.reshape(lead + (h, w, 3))
