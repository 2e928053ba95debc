"""Batched quaternion / rigid-transform math (PyTorch).

Port of ``tacex_tpu/core/maths.py`` for the helpers that the Franka
kinematics, the contact model, the depth camera and the ball-rolling env
use. Quaternions are (w, x, y, z), unit-norm; every function broadcasts over
leading batch axes and never reads a value back to the host.
"""

from __future__ import annotations

import torch


def quat_identity(batch_shape: tuple[int, ...] = (), device=None) -> torch.Tensor:
    q = torch.zeros(batch_shape + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q`` (Rodrigues form)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_apply_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_apply(quat_conjugate(q), v)


def transform_points(points: torch.Tensor, pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Apply the rigid transform ``pos`` (..., 3), ``quat`` (..., 4) to
    (..., P, 3) points."""
    return quat_apply(quat[..., None, :], points) + pos[..., None, :]


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Branch-free rotation-matrix -> quaternion (best of four candidates)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    qw = torch.sqrt(qw.clamp_min(1e-12)) / 2.0
    case = torch.argmax(qw, dim=-1)

    q0, q1, q2, q3 = qw.unbind(-1)
    w0, x0 = q0, (m21 - m12) / (4 * q0)
    y0, z0 = (m02 - m20) / (4 * q0), (m10 - m01) / (4 * q0)
    x1, w1 = q1, (m21 - m12) / (4 * q1)
    y1, z1 = (m01 + m10) / (4 * q1), (m02 + m20) / (4 * q1)
    y2, w2 = q2, (m02 - m20) / (4 * q2)
    x2, z2 = (m01 + m10) / (4 * q2), (m12 + m21) / (4 * q2)
    z3, w3 = q3, (m10 - m01) / (4 * q3)
    x3, y3 = (m02 + m20) / (4 * q3), (m12 + m21) / (4 * q3)

    qs = torch.stack(
        [
            torch.stack([w0, x0, y0, z0], -1),
            torch.stack([w1, x1, y1, z1], -1),
            torch.stack([w2, x2, y2, z2], -1),
            torch.stack([w3, x3, y3, z3], -1),
        ],
        dim=-2,
    )
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(qs, -2, idx)[..., 0, :]
    return quat_normalize(q)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    half = angle * 0.5
    w = torch.cos(half)
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat([w[..., None], xyz], dim=-1)


def euler_xyz_from_quat(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    return euler_xyz_from_quat(q)[2]


def axis_angle_from_quat(q: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation vector (axis * angle) from quaternion; smooth near identity."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    xyz = q[..., 1:4]
    sin_half = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, q[..., 0:1])
    scale = torch.where(sin_half > eps, angle / sin_half.clamp_min(eps), 2.0)
    return xyz * scale
