"""Franka Panda kinematics: batched FK, geometric Jacobian, differential IK.

Port of ``tacex_tpu/physics/rigid/franka.py``: published Panda modified-DH
parameters (Craig convention), a damped-least-squares IK step, and a
rate-limited first-order joint servo. Joint limits are carried as tensors
on the state's device by ``ArmLimits``; nothing here reads a value back to
the host (the 6x6 solve uses ``solve_ex`` without its error check).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core import maths

NUM_JOINTS = 7

# Modified DH rows: (a, d, alpha) for joints 1..7, flange handled separately.
_DH = np.array(
    [
        [0.0, 0.333, 0.0],
        [0.0, 0.0, -math.pi / 2],
        [0.0, 0.316, math.pi / 2],
        [0.0825, 0.0, math.pi / 2],
        [-0.0825, 0.384, -math.pi / 2],
        [0.0, 0.0, math.pi / 2],
        [0.088, 0.0, math.pi / 2],
    ],
    dtype=np.float32,
)
# per joint: (a, -sin(alpha) * d, cos(alpha) * d, cos(alpha), sin(alpha)) in f32
_LINKS = [
    (float(a), float(-np.sin(al) * d), float(np.cos(al) * d), float(np.cos(al)), float(np.sin(al)))
    for a, d, al in _DH
]
FLANGE_OFFSET = 0.107  # m along the joint-7 z axis

Q_LOWER = (-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973)
Q_UPPER = (2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973)
Q_DEFAULT = (0.0, -0.569, 0.0, -2.81, 0.0, 3.037, 0.741)
QD_LIMIT = (2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61)


@dataclasses.dataclass(frozen=True)
class ArmLimits:
    """Joint position and velocity limits as (7,) tensors on one device."""

    q_lower: torch.Tensor
    q_upper: torch.Tensor
    qd_limit: torch.Tensor

    @staticmethod
    def on(device=None) -> "ArmLimits":
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return ArmLimits(t(Q_LOWER), t(Q_UPPER), t(QD_LIMIT))


def _mdh_transform(link: tuple, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Modified-DH link transform as (rotmat (..., 3, 3), translation (..., 3))."""
    a, t_y, t_z, ca, sa = link
    ct, st = torch.cos(theta), torch.sin(theta)
    zero = torch.zeros_like(ct)
    rot = torch.stack(
        [
            torch.stack([ct, -st, zero], -1),
            torch.stack([st * ca, ct * ca, torch.full_like(ct, -sa)], -1),
            torch.stack([st * sa, ct * sa, torch.full_like(ct, ca)], -1),
        ],
        -2,
    )
    trans = torch.stack([torch.full_like(ct, a), torch.full_like(ct, t_y), torch.full_like(ct, t_z)], -1)
    return rot, trans


def forward_kinematics(
    q: torch.Tensor,  # (..., 7)
    ee_offset_pos: tuple[float, float, float] | None = None,  # tool offset in the flange frame
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """FK to the flange/tool frame from a base at the world origin.

    Returns (ee_pos (...,3), ee_quat (...,4), joint_origins (...,7,3),
    joint_axes (...,7,3)); origins and axes feed the geometric Jacobian.
    """
    rot = None
    pos = None
    origins, axes = [], []
    for i in range(NUM_JOINTS):
        r_i, t_i = _mdh_transform(_LINKS[i], q[..., i])
        if rot is None:  # base frame is the identity
            pos, rot = t_i, r_i
        else:
            pos = pos + (rot @ t_i[..., None])[..., 0]
            rot = rot @ r_i
        origins.append(pos)
        axes.append(rot[..., :, 2])  # joint rotates about local z

    ee_pos = pos + FLANGE_OFFSET * rot[..., :, 2]
    if ee_offset_pos is not None:
        ox, oy, oz = (float(v) for v in ee_offset_pos)
        ee_pos = ee_pos + (ox * rot[..., :, 0] + oy * rot[..., :, 1] + oz * rot[..., :, 2])
    ee_quat = maths.quat_from_matrix(rot)
    return ee_pos, ee_quat, torch.stack(origins, -2), torch.stack(axes, -2)


def geometric_jacobian(ee_pos: torch.Tensor, joint_origins: torch.Tensor, joint_axes: torch.Tensor) -> torch.Tensor:
    """(..., 6, 7) spatial Jacobian [linear; angular] at the tool point."""
    r = ee_pos[..., None, :] - joint_origins  # (..., 7, 3)
    lin = torch.linalg.cross(joint_axes, r, dim=-1)
    return torch.cat([lin, joint_axes], dim=-1).transpose(-1, -2)


def dls_ik_step(
    q: torch.Tensor,  # (..., 7)
    pos_err: torch.Tensor,  # (..., 3) desired - current, world
    rot_err: torch.Tensor,  # (..., 3) axis-angle error, world
    jacobian: torch.Tensor,  # (..., 6, 7)
    damping: float = 0.05,
) -> torch.Tensor:
    """Damped-least-squares IK update: q + J^T (J J^T + λ²I)^-1 err."""
    err = torch.cat([pos_err, rot_err], dim=-1)[..., None]  # (..., 6, 1)
    jjt = jacobian @ jacobian.transpose(-1, -2)
    lam = (damping**2) * torch.eye(6, dtype=q.dtype, device=q.device)
    sol, _ = torch.linalg.solve_ex(jjt + lam, err, check_errors=False)
    dq = (jacobian.transpose(-1, -2) @ sol)[..., 0]
    return q + dq


@dataclasses.dataclass(frozen=True)
class ArmState:
    """Batched arm state: measured joints + servo targets."""

    q: torch.Tensor  # (N, 7)
    qd: torch.Tensor  # (N, 7)
    q_target: torch.Tensor  # (N, 7)

    @staticmethod
    def init(num_envs: int, q0: torch.Tensor) -> "ArmState":
        q = q0.to(torch.float32).expand(num_envs, NUM_JOINTS).clone()
        return ArmState(q=q, qd=torch.zeros_like(q), q_target=q.clone())


def servo_step(state: ArmState, dt: float, limits: ArmLimits, stiffness: float = 40.0) -> ArmState:
    """First-order rate-limited tracking of q_target (high-PD abstraction)."""
    err = state.q_target - state.q
    qd = torch.clamp(stiffness * err, -limits.qd_limit, limits.qd_limit)
    q = torch.clamp(state.q + qd * dt, limits.q_lower, limits.q_upper)
    return ArmState(q=q, qd=qd, q_target=state.q_target)


def apply_delta_pose_ik(
    state: ArmState,
    delta_pos: torch.Tensor,  # (N, 3) commanded EE translation
    delta_rot: torch.Tensor,  # (N, 3) commanded EE axis-angle rotation
    limits: ArmLimits,
    ee_offset_pos: tuple[float, float, float] | None = None,
    damping: float = 0.05,
) -> ArmState:
    """Set joint targets from a 6-dim delta-pose command (one DLS step)."""
    ee_pos, _, origins, axes = forward_kinematics(state.q, ee_offset_pos)
    jac = geometric_jacobian(ee_pos, origins, axes)
    q_new = dls_ik_step(state.q, delta_pos, delta_rot, jac, damping)
    q_new = torch.clamp(q_new, limits.q_lower, limits.q_upper)
    return ArmState(q=state.q, qd=state.qd, q_target=q_new)
