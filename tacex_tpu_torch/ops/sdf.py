"""Signed-distance functions for analytic rigid scenes (PyTorch).

Port of ``tacex_tpu/ops/sdf.py``: the fixed-capacity primitive soup
(spheres, oriented boxes, capsules, planes) plus helical threads and spur
gears, evaluated as signed distances of (P, 3) points. Every function is
built from ops whose gradients ``torch.func.grad`` takes as ``jax.grad``
does: ties of ``torch.minimum``/``maximum``/``amax`` split the gradient
evenly, ``abs``, ``sign`` and ``floor`` have gradient 0 at 0, and ``clip``
is written as ``minimum(maximum(x, lo), hi)`` so that a value on a bound
takes half the gradient, as ``jnp.clip`` gives it. Nothing here creates a
tensor from host data, so the functions run under ``torch.func.vmap`` and
on the card without a host sync.
"""

from __future__ import annotations

import math

import torch

from ..core import maths

BIG = 1e9


def _safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """sqrt(sum(v^2) + tiny): NaN-free gradient at v = 0, also through the
    branches a ``min``/``where`` does not select."""
    return torch.sqrt((v * v).sum(dim) + 1e-20)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: its gradient at a bound is split like a tie."""
    lo = lo if isinstance(lo, torch.Tensor) else x.new_full((), lo)
    hi = hi if isinstance(hi, torch.Tensor) else x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def sdf_spheres(p: torch.Tensor, spheres: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) points vs (..., S, 4) spheres -> (..., P, S) signed distances."""
    c, r = spheres[..., :3], spheres[..., 3]
    d = _safe_norm(p[..., :, None, :] - c[..., None, :, :]) - r[..., None, :]
    return torch.where(r[..., None, :] > 0, d, BIG)


def sdf_planes(p: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) vs (..., L, 4) planes (n, d): signed distance n.x - d."""
    n, off = planes[..., :3], planes[..., 3]
    d = p @ n.transpose(-1, -2) - off[..., None, :]
    enabled = (n * n).sum(-1) > 0.5
    return torch.where(enabled[..., None, :], d, BIG)


def sdf_boxes(p: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) vs (..., B, 10) oriented boxes -> (..., P, B) exact signed distances."""
    c, q, h = boxes[..., :3], boxes[..., 3:7], boxes[..., 7:10]
    local = maths.quat_apply_inverse(q[..., None, :, :], p[..., :, None, :] - c[..., None, :, :])  # (..., P, B, 3)
    a = local.abs() - h[..., None, :, :]
    zero = a.new_zeros(())
    outside = _safe_norm(torch.maximum(a, zero))
    inside = torch.minimum(a.amax(-1), zero)
    return torch.where(boxes[..., None, :, 7] > 0, outside + inside, BIG)


def sdf_capsules(p: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) vs (..., C, 8) capsules -> (..., P, C)."""
    a, b, r, en = caps[..., 0:3], caps[..., 3:6], caps[..., 6], caps[..., 7]
    ab = b - a
    ab2 = torch.maximum((ab * ab).sum(-1), ab.new_full((), 1e-12))
    t = ((p[..., :, None, :] - a[..., None, :, :]) * ab[..., None, :, :]).sum(-1) / ab2[..., None, :]
    t = _clip(t, 0.0, 1.0)
    closest = a[..., None, :, :] + t[..., None] * ab[..., None, :, :]
    d = _safe_norm(p[..., :, None, :] - closest) - r[..., None, :]
    return torch.where(en[..., None, :] > 0.5, d, BIG)


def sdf_threads(p: torch.Tensor, threads: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) points vs (..., T, 12) helical threads -> (..., P, T)
    signed distances (leading axes as the other primitives': one set of
    threads an env).

    A triangular thread profile swept along a helix, evaluated in helicoidal
    coordinates (u = z - pitch theta / 2 pi, folded to [0, pitch/2]) as the
    2D distance to one flank segment in the (u, r) half-plane; see the JAX
    package's ``sdf_threads`` for the derivation.

    Layout per thread: [base(3), axis(3), r_mid, depth, pitch, z0, z1, side],
    side = +1 an external thread (bolt), -1 an internal one (nut bore), 0
    disabled. Outside [z0, z1] the depth ramps to zero over pitch/2.
    """
    base, axis = threads[..., 0:3], threads[..., 3:6]
    # per-thread scalars as (..., 1, T) rows against the (..., P, T) grid
    r_mid, depth, pitch, z0, z1, side = (threads[..., None, :, i] for i in range(6, 12))
    axis = axis / _safe_norm(axis)[..., None]
    # orthonormal frame per thread, seeded with the world axis least aligned
    # with the thread axis: x unless |axis.x| >= 0.9, then y
    use_x = (axis[..., 0].abs() < 0.9).to(axis.dtype)
    seed = torch.stack([use_x, 1.0 - use_x, torch.zeros_like(use_x)], -1)
    b1 = torch.linalg.cross(axis, seed, dim=-1)
    b1 = b1 / _safe_norm(b1)[..., None]
    b2 = torch.linalg.cross(axis, b1, dim=-1)

    rel = p[..., :, None, :] - base[..., None, :, :]  # (..., P, T, 3)
    z = (rel * axis[..., None, :, :]).sum(-1)
    x1 = (rel * b1[..., None, :, :]).sum(-1)
    x2 = (rel * b2[..., None, :, :]).sum(-1)
    r2 = x1 * x1 + x2 * x2
    rr = torch.sqrt(r2 + 1e-20)
    # NaN-free atan2 gradient on the axis
    on_axis = r2 < 1e-16
    theta = torch.atan2(torch.where(on_axis, 0.0, x2), torch.where(on_axis, 1.0, x1))

    pitch_s = torch.maximum(pitch, pitch.new_full((), 1e-9))
    u = z - pitch_s * theta / (2.0 * math.pi)
    f = u / pitch_s - torch.floor(u / pitch_s)  # frac in [0, 1)
    uf = torch.minimum(f, 1.0 - f) * pitch_s  # folded to [0, pitch/2]

    ramp = _clip(1.0 + torch.minimum(z - z0, z1 - z) / (0.5 * pitch_s), 0.0, 1.0)
    half_d = 0.5 * depth * ramp * side  # signed crest offset

    # 2D distance to the flank segment A = (0, r_mid + half_d) -> B = (pitch/2, r_mid - half_d)
    ay = r_mid + half_d
    bx, by = 0.5 * pitch_s, r_mid - half_d
    ex, ey = bx, by - ay
    px_, py = uf, rr - ay
    t = _clip((px_ * ex + py * ey) / (ex * ex + ey * ey + 1e-20), 0.0, 1.0)
    dx, dy = px_ - t * ex, py - t * ey
    dist = torch.sqrt(dx * dx + dy * dy + 1e-20)
    r_prof = ay + (by - ay) * (uf / (0.5 * pitch_s))
    sign = torch.sign(side * (rr - r_prof))
    return torch.where(side != 0, sign * dist, BIG)


def sdf_gear(p: torch.Tensor, gears: torch.Tensor) -> torch.Tensor:
    """(P, 3) points vs (G, 8) z-axis spur gears -> (P, G) distances.

    A cylinder whose radius alternates between r_root and r_tip around the
    circumference, r(theta) = r_root + (r_tip - r_root) sigma(cos(n (theta -
    phase))), intersected with the z-slab: the radial distance, not a true
    Euclidean SDF near the flanks. Layout: [cx, cy, r_root, r_tip, n_teeth,
    z0, z1, phase].
    """
    c = gears[:, 0:2]
    r_root, r_tip = gears[:, 2], gears[:, 3]
    n_teeth = gears[:, 4]
    z0, z1, phase = gears[:, 5], gears[:, 6], gears[:, 7]
    rel = p[:, None, 0:2] - c[None, :, :]  # (P, G, 2)
    rho2 = (rel * rel).sum(-1)
    rho = torch.sqrt(rho2 + 1e-20)
    on_axis = rho2 < 1e-16
    theta = torch.atan2(torch.where(on_axis, 1.0, rel[..., 1]), torch.where(on_axis, 1.0, rel[..., 0]))
    cw = torch.cos(n_teeth[None, :] * (theta - phase[None, :]))
    sigma = _clip(0.5 + cw / 0.8, 0.0, 1.0)
    r_surf = r_root[None, :] + (r_tip - r_root)[None, :] * sigma
    d_radial = rho - r_surf
    z = p[:, None, 2]
    return torch.maximum(d_radial, torch.maximum(z0[None, :] - z, z - z1[None, :]))


def scene_sdf(
    p: torch.Tensor,  # (..., P, 3)
    spheres: torch.Tensor,  # (..., S, 4)
    boxes: torch.Tensor,
    capsules: torch.Tensor,
    planes: torch.Tensor,
    threads: torch.Tensor | None = None,  # (..., T, 12)
) -> torch.Tensor:
    """(..., P) min signed distance of each point to the primitive soup;
    every primitive takes the same leading batch axes (one soup an env)."""
    parts = [sdf_spheres(p, spheres), sdf_boxes(p, boxes), sdf_capsules(p, capsules), sdf_planes(p, planes)]
    if threads is not None:
        parts.append(sdf_threads(p, threads))
    return torch.cat(parts, dim=-1).amin(-1)
