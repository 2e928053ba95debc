"""Geometry helpers of the FEM marker-flow pipeline.

Port of ``tacex_tpu/sensors/gelsight/fem/geometry.py``: the best-fit rigid
transform (Kabsch), applying it, ray-casting point-in-polygon and the
rotated-rectangle corners on tensors, batched over leading dims. ``in_hull``
stays host numpy/scipy (a one-time precompute at marker-binding time).
"""

from __future__ import annotations

import numpy as np
import torch


def estimate_rigid_transform(src: torch.Tensor, dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-fit rigid transform (R, t) with dst ~= src @ R.T + t (Kabsch via
    SVD, with the reflection fixed by det). src, dst: (..., P, 3)."""
    src_c = src - src.mean(-2, keepdim=True)
    dst_c = dst - dst.mean(-2, keepdim=True)
    H = torch.einsum("...pi,...pj->...ij", src_c, dst_c)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2)))
    S = torch.cat([torch.ones(H.shape[:-2] + (2,), dtype=H.dtype, device=H.device), d[..., None]], -1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, S, U)
    t = dst.mean(-2) - torch.einsum("...ij,...j->...i", R, src.mean(-2))
    return R, t


def transform_pts(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Apply (R, t): (..., P, 3) -> (..., P, 3)."""
    return torch.einsum("...ij,...pj->...pi", R, pts) + t[..., None, :]


def in_hull(points: np.ndarray, hull_points: np.ndarray) -> np.ndarray:
    """Boolean mask of ``points`` inside the convex hull of ``hull_points``
    (host-side scipy Delaunay, used once at marker-binding time)."""
    from scipy.spatial import Delaunay

    return Delaunay(np.asarray(hull_points)).find_simplex(np.asarray(points)) >= 0


def points_in_polygon(points: torch.Tensor, polygon: torch.Tensor) -> torch.Tensor:
    """Ray-casting point-in-polygon. points (..., P, 2), polygon (V, 2)
    counter-clockwise -> bool (..., P)."""
    px, py = points[..., 0][..., None], points[..., 1][..., None]  # (..., P, 1)
    x0, y0 = polygon[:, 0], polygon[:, 1]
    x1, y1 = torch.roll(x0, -1), torch.roll(y0, -1)
    cond = (y0 > py) != (y1 > py)
    denom = torch.where((y1 - y0).abs() > 1e-12, y1 - y0, 1e-12)
    x_int = x0 + (py - y0) * (x1 - x0) / denom
    crossings = (cond & (px < x_int)).sum(-1)
    return (crossings % 2) == 1


def random_rectangle_points(
    rng: np.random.Generator,
    center: tuple[float, float],
    half_w: float,
    half_h: float,
    rotation: float = 0.0,
) -> np.ndarray:
    """Corner points (4, 2) of a rotated rectangle (host numpy, as the JAX
    package's; ``rng`` is unused there too)."""
    c, s = np.cos(rotation), np.sin(rotation)
    R = np.array([[c, -s], [s, c]])
    corners = np.array([[-half_w, -half_h], [half_w, -half_h], [half_w, half_h], [-half_w, half_h]])
    return corners @ R.T + np.asarray(center)
