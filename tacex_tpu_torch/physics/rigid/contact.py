"""Analytic sphere contact with impulse resolution (PyTorch).

Port of ``tacex_tpu/physics/rigid/contact.py`` for the ball-rolling scene: a
dynamic sphere against a static plane and a kinematic oriented box (the gel
pad), resolved with a projected impulse (normal impulse with Baumgarte
positional stabilization + Coulomb-clamped tangential impulse), batched over
envs with masks in place of branches.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core import maths


@dataclasses.dataclass(frozen=True)
class SphereParams:
    """Sphere contact parameters; fields are python scalars (shared across
    envs) or (N,) tensors (per env, e.g. domain-randomized)."""

    radius: float
    mass: float | torch.Tensor
    restitution: float | torch.Tensor = 0.0
    friction: float | torch.Tensor = 0.8

    @property
    def inv_mass(self):
        return 1.0 / self.mass

    @property
    def inv_inertia(self):
        # solid sphere: I = 2/5 m r^2, guarded against a zero radius
        inertia = 0.4 * self.mass * self.radius**2
        if isinstance(inertia, torch.Tensor):
            return 1.0 / inertia.clamp_min(1e-12)
        return 1.0 / max(inertia, 1e-12)


def _col(x):
    """Scalar or (N,) parameter -> broadcastable against (..., 3) vectors."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def _resolve_contact(
    lin_vel: torch.Tensor,  # (..., 3) sphere linear velocity
    ang_vel: torch.Tensor,  # (..., 3)
    normal: torch.Tensor,  # (..., 3) contact normal, toward the sphere
    depth: torch.Tensor,  # (...,) penetration depth (>0 = penetrating)
    surf_vel: torch.Tensor,  # (..., 3) velocity of the surface at the contact point
    r_vec: torch.Tensor,  # (..., 3) contact point - sphere center
    params: SphereParams,
    dt: float,
    baumgarte: float = 0.2,
    slop: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_lin_vel, d_ang_vel) impulse response for one contact set."""
    active = depth > 0.0

    v_point = lin_vel + maths.cross(ang_vel, r_vec)
    v_rel = v_point - surf_vel
    vn = (v_rel * normal).sum(-1)

    inv_m = params.inv_mass
    inv_i = params.inv_inertia

    bias = baumgarte / dt * torch.clamp(depth - slop, min=0.0)
    jn = -(1.0 + params.restitution) * vn + bias
    jn = torch.clamp(jn / inv_m, min=0.0)
    jn = torch.where(active, jn, 0.0)

    vt = v_rel - vn[..., None] * normal
    vt_norm = torch.linalg.vector_norm(vt, dim=-1)
    t_dir = vt / vt_norm.clamp_min(1e-9)[..., None]
    k_t = inv_m + (params.radius**2) * inv_i
    jt_needed = vt_norm / k_t
    jt = torch.minimum(jt_needed, params.friction * jn)
    jt = torch.where(active, jt, 0.0)

    imp = jn[..., None] * normal - jt[..., None] * t_dir
    d_lin = imp * _col(inv_m)
    ang_imp = jn[..., None] * normal - 1.0 * jt[..., None] * t_dir
    d_ang = maths.cross(r_vec, ang_imp) * _col(inv_i)
    return d_lin, d_ang


def sphere_plane_contact(
    pos: torch.Tensor,  # (..., 3) sphere center
    lin_vel: torch.Tensor,
    ang_vel: torch.Tensor,
    plane_n: tuple[float, float, float],  # unit normal
    plane_d: float,  # plane offset: n.x = d
    params: SphereParams,
    dt: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    nx, ny, nz = (float(v) for v in plane_n)
    dist = pos[..., 0] * nx + pos[..., 1] * ny + pos[..., 2] * nz - plane_d
    n = torch.stack([torch.full_like(dist, nx), torch.full_like(dist, ny), torch.full_like(dist, nz)], -1)
    depth = params.radius - dist
    r_vec = -params.radius * n
    return _resolve_contact(lin_vel, ang_vel, n, depth, torch.zeros_like(pos), r_vec, params, dt)


def closest_point_on_box(
    p: torch.Tensor,  # (..., 3) query point, world
    box_pos: torch.Tensor,  # (..., 3)
    box_quat: torch.Tensor,  # (..., 4)
    half_extents: torch.Tensor,  # (3,) or (..., 3)
) -> torch.Tensor:
    local = maths.quat_apply_inverse(box_quat, p - box_pos)
    clamped = torch.clamp(local, -half_extents, half_extents)
    return maths.quat_apply(box_quat, clamped) + box_pos


def sphere_box_contact(
    pos: torch.Tensor,  # (..., 3) sphere center
    lin_vel: torch.Tensor,
    ang_vel: torch.Tensor,
    box_pos: torch.Tensor,  # (..., 3) kinematic box pose
    box_quat: torch.Tensor,  # (..., 4)
    box_vel: torch.Tensor,  # (..., 3) kinematic box linear velocity
    half_extents: torch.Tensor,  # (3,)
    params: SphereParams,
    dt: float,
    stiffness_scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sphere vs kinematic oriented box (the gel pad pressing a ball).

    ``stiffness_scale`` < 1 softens the positional correction, approximating
    gel compliance."""
    cp = closest_point_on_box(pos, box_pos, box_quat, half_extents)
    delta = pos - cp
    dist = torch.linalg.vector_norm(delta, dim=-1)
    # centre inside the box: push out along the face normal of least depth
    local = maths.quat_apply_inverse(box_quat, pos - box_pos)
    inside = (local.abs() <= half_extents).all(dim=-1)
    face_dist = half_extents - local.abs()
    face_axis = torch.argmin(face_dist, dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(local, -1, face_axis))
    axes = torch.arange(3, device=pos.device)
    face_n_local = (face_axis == axes).to(pos.dtype) * sign
    face_n = maths.quat_apply(box_quat, face_n_local)
    n_out = delta / dist.clamp_min(1e-9)[..., None]
    normal = torch.where(inside[..., None], face_n, n_out)
    depth = torch.where(inside, params.radius + face_dist.amin(dim=-1), params.radius - dist)
    r_vec = -params.radius * normal
    return _resolve_contact(
        lin_vel, ang_vel, normal, depth, box_vel, r_vec, params, dt, baumgarte=0.2 * stiffness_scale,
    )
