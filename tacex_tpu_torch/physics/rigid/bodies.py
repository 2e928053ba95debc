"""Batched 6-DoF rigid-body state and semi-implicit Euler integration (PyTorch).

Port of ``tacex_tpu/physics/rigid/bodies.py``: one dataclass of
``(N, B, ...)`` tensors for N envs x B bodies.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core import maths


@dataclasses.dataclass(frozen=True)
class RigidState:
    """Batched rigid bodies: (N, B, ...)."""

    pos: torch.Tensor  # (N, B, 3)
    quat: torch.Tensor  # (N, B, 4) wxyz
    lin_vel: torch.Tensor  # (N, B, 3)
    ang_vel: torch.Tensor  # (N, B, 3) world frame

    @staticmethod
    def init(num_envs: int, num_bodies: int, device=None) -> "RigidState":
        z = lambda: torch.zeros((num_envs, num_bodies, 3), device=device)
        return RigidState(
            pos=z(), quat=maths.quat_identity((num_envs, num_bodies), device=device), lin_vel=z(), ang_vel=z()
        )


def integrate(
    state: RigidState, dt: float, gravity=(0.0, 0.0, -9.81), inv_mass: torch.Tensor | None = None
) -> RigidState:
    """Semi-implicit Euler: v += g dt (dynamic bodies), x += v dt, q += w q dt/2.

    ``inv_mass``: (B,) or (N, B); 0 marks a static or kinematic body (no gravity).
    """
    gx, gy, gz = (float(v) for v in gravity)
    if inv_mass is None:
        dyn = torch.ones(state.pos.shape[:-1], dtype=state.pos.dtype, device=state.pos.device)
    else:
        dyn = (inv_mass > 0).to(state.pos.dtype).expand(state.pos.shape[:-1])
    g = torch.stack([dyn * gx, dyn * gy, dyn * gz], -1)
    lin_vel = state.lin_vel + g * dt
    pos = state.pos + lin_vel * dt
    w = state.ang_vel
    wq = torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1)
    quat = maths.quat_normalize(state.quat + 0.5 * dt * maths.quat_mul(wq, state.quat))
    return RigidState(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=state.ang_vel)
