"""Held-asset 6-DoF contact dynamics for the Factory insertion tasks (PyTorch).

Port of ``tacex_tpu/envs/factory/contact.py``: the held asset (peg, gear or
nut) is a rigid body coupled to the gripper by a compliant grasp (a
spring-damper wrench), pressed against the fixed asset, an analytic SDF.
Contact is a penalty force on a fixed set of surface sample points, with
normal damping and capped Coulomb friction; jamming, wedging and threading
come out of the force balance. The contact normals are the SDF's exact
gradient, ``torch.func.vmap(torch.func.grad_and_value(sdf))`` over every
sample point of every env at once. The bolt of NutThread carries the
helical thread of ``ops/sdf.py``; the nut's samples ride its groove.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core import maths
from ...ops import sdf as sdf_ops

# ---------------------------------------------------------------------------
# analytic SDFs of the fixed assets (local frame, z up, origin = asset centre)


def _norm(v: torch.Tensor) -> torch.Tensor:
    # eps-padded so the gradient is finite at v = 0 (points inside a box or on
    # the cylinder axis meet the norm's kink exactly)
    return torch.sqrt((v * v).sum() + 1e-18)


def _sdf_box(p: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    q = p.abs() - half
    zero = q.new_zeros(())
    return _norm(torch.maximum(q, zero)) + torch.minimum(q.amax(), zero)


def _sdf_capped_cylinder(p: torch.Tensor, radius: float, z0: float, z1: float) -> torch.Tensor:
    """Solid vertical cylinder from z0 to z1."""
    d_r = _norm(p[:2]) - radius
    d_z = torch.maximum(z0 - p[2], p[2] - z1)
    q = torch.stack([d_r, d_z])
    zero = q.new_zeros(())
    return _norm(torch.maximum(q, zero)) + torch.minimum(torch.maximum(d_r, d_z), zero)


#: tooth phase of the fixed neighbour gears (rad): a yaw-0 held gear's tooth
#: tips pass through the neighbours' tooth gaps on the line of centres
GEAR_NEIGHBOR_PHASE = 0.0218


def make_fixed_sdf(task_name: str, t, device=None):
    """Scalar SDF ``sdf(p (3,)) -> ()`` of the fixed asset and the table, in
    the asset's local frame. ``t``: a ``FactoryTaskCfg``; its constant
    tensors are built on ``device`` here, once."""
    f32 = dict(dtype=torch.float32, device=device)
    half_t = tuple(s / 2 for s in t.fixed_size)
    half = torch.tensor(half_t, **f32)
    table_z = -half_t[2]  # the table surface under the asset's base

    if task_name == "peg_insert":
        rh = t.hole_diameter / 2

        def sdf(p):
            block = _sdf_box(p, half)
            # hole bored from the top face, hole_depth deep (+eps past the top)
            hole = _sdf_capped_cylinder(p, rh, half_t[2] - t.hole_depth, half_t[2] + 1e-3)
            table = p[2] - table_z
            return torch.minimum(torch.maximum(block, -hole), table)

        return sdf

    if task_name == "gear_mesh":
        rs = t.hole_diameter / 2  # gear-shaft radius
        # the neighbour gears on the base: the held gear's tooth module
        # (r_root = 0.75 r_tip, 12 teeth), centres along +-y so the tip
        # circles interleave by ~3 mm
        r_tip_g = t.held_diameter / 2
        r_root_g = 0.75 * r_tip_g
        center_d = r_tip_g + r_root_g + 0.0005
        gear_z1 = half_t[2] + 0.8 * t.hole_depth
        gears = torch.tensor(
            [
                [0.0, center_d, r_root_g, r_tip_g, 12.0, half_t[2], gear_z1, GEAR_NEIGHBOR_PHASE],
                [0.0, -center_d, r_root_g, r_tip_g, 12.0, half_t[2], gear_z1, GEAR_NEIGHBOR_PHASE],
            ],
            **f32,
        )

        def sdf(p):
            plate = _sdf_box(p, half)
            shaft = _sdf_capped_cylinder(p, rs, half_t[2], half_t[2] + t.hole_depth)
            table = p[2] - table_z
            d_gears = sdf_ops.sdf_gear(p[None], gears)[0].amin()
            return torch.minimum(torch.minimum(torch.minimum(plate, shaft), table), d_gears)

        return sdf

    if task_name == "nut_thread":
        # the bolt's external thread, capped to its z-span by intersection
        rb = t.hole_diameter / 2  # thread mid radius
        thread = torch.tensor(
            [[0.0, 0.0, 0.0, 0.0, 0.0, 1.0, rb, t.thread_depth, t.thread_pitch,
              half_t[2], half_t[2] + t.hole_depth, 1.0]],
            **f32,
        )
        z_lo, z_hi = half_t[2] - 1e-3, half_t[2] + t.hole_depth

        def sdf(p):
            base = _sdf_box(p, half)
            d_thr = sdf_ops.sdf_threads(p[None], thread)[0, 0]
            slab = torch.maximum(z_lo - p[2], p[2] - z_hi)
            bolt = torch.maximum(d_thr, slab)
            table = p[2] - table_z
            return torch.minimum(torch.minimum(base, bolt), table)

        return sdf

    raise ValueError(f"unknown factory task {task_name!r}")


# ---------------------------------------------------------------------------
# held-asset surface sample points (local frame, z up, origin = asset bottom)

NUM_POINTS = 96


def make_held_points(task_name: str, t) -> np.ndarray:
    """(NUM_POINTS, 3) contact sample points on the held asset's surface
    (numpy, as in the JAX package)."""
    pts = []
    if task_name == "peg_insert":
        r, h = t.held_diameter / 2, t.held_height
        pts.append([0.0, 0.0, 0.0])  # bottom centre
        for z, n in ((0.0, 16), (0.15 * h, 12), (0.5 * h, 10), (h, 9)):
            for k in range(n):
                a = 2 * math.pi * k / n
                pts.append([r * math.cos(a), r * math.sin(a), z])
    elif task_name == "gear_mesh":
        rb = t.hole_diameter / 2 + 2e-4  # bore radius (small clearance)
        ro, h = t.held_diameter / 2, t.held_height
        for z, n, rr in ((0.0, 10, rb), (h, 10, rb)):  # the bore rim, both ends
            for k in range(n):
                a = 2 * math.pi * k / n
                pts.append([rr * math.cos(a), rr * math.sin(a), z])
        # bottom-face rings from the bore out, dense enough that the shaft top
        # cannot pass between them
        n_rings = 4
        for j in range(n_rings):
            rr = rb * 1.6 + (ro - rb * 1.6) * j / (n_rings - 1)
            n = 10 if j < 2 else 12
            for k in range(n):
                a = 2 * math.pi * (k + 0.5 * j) / n
                pts.append([rr * math.cos(a), rr * math.sin(a), 0.0])
        # one tooth-tip sample per tooth, at the bottom face and at the
        # neighbour gears' height
        r_tooth = ro * 0.985
        for z in (0.0, 0.008):
            for i in range(12):
                a = 2 * math.pi * (i + 0.25) / 12
                pts.append([r_tooth * math.cos(a), r_tooth * math.sin(a), z])
    elif task_name == "nut_thread":
        # the nut's internal thread: its tooth-tip helix (right-handed, as
        # sdf_threads), then a mid-flank helix half a pitch up
        r_mid_n = t.hole_diameter / 2 + t.thread_clearance
        r_tip = r_mid_n - t.thread_depth / 2
        ro, h = t.held_diameter / 2, t.held_height
        n_per_turn = 10
        turns = h / t.thread_pitch
        for k in range(int(n_per_turn * turns)):
            a = 2 * math.pi * k / n_per_turn
            z = t.thread_pitch * a / (2 * math.pi)
            if z > h:
                break
            pts.append([r_tip * math.cos(a), r_tip * math.sin(a), z])
        for k in range(int(n_per_turn * turns)):
            a = 2 * math.pi * k / n_per_turn
            z = t.thread_pitch * (a / (2 * math.pi) + 0.25)
            if z > h:
                break
            pts.append([r_mid_n * math.cos(a), r_mid_n * math.sin(a), z])
        # the bottom face is an annulus: the bore is open
        for rr, n in ((0.55 * ro, 10), (0.85 * ro, 10)):
            for k in range(n):
                a = 2 * math.pi * k / n
                pts.append([rr * math.cos(a), rr * math.sin(a), 0.0])
    else:
        raise ValueError(task_name)
    pts = np.asarray(pts, np.float32)[:NUM_POINTS]
    out = np.zeros((NUM_POINTS, 3), np.float32)
    out[: pts.shape[0]] = pts
    out[pts.shape[0] :] = pts[0]  # pad by repeating the first point
    return out


# ---------------------------------------------------------------------------
# dynamics


@dataclasses.dataclass(frozen=True)
class HeldState:
    """Batched rigid state of the held asset. Origin = asset bottom centre."""

    pos: torch.Tensor  # (N, 3)
    quat: torch.Tensor  # (N, 4) wxyz
    linvel: torch.Tensor  # (N, 3)
    angvel: torch.Tensor  # (N, 3) world frame

    @staticmethod
    def init(num_envs: int, device=None) -> "HeldState":
        z = lambda: torch.zeros((num_envs, 3), device=device)
        return HeldState(pos=z(), quat=maths.quat_identity((num_envs,), device=device), linvel=z(), angvel=z())


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """Solver constants, shared by every env."""

    mass: float = 0.05  # held asset mass (kg)
    inertia: float = 2e-5  # isotropic rotational inertia (kg m^2)
    kn: float = 2.0e4  # contact normal stiffness (N/m)
    cn: float = 50.0  # contact normal damping (N s/m), ~critical for 50 g
    v_max: float = 0.5  # rigid-body speed clamp (keeps penetration shallow so
    w_max: float = 20.0  # the SDF normals stay on the right face)
    mu: float = 0.3  # Coulomb friction
    kt: float = 2.0e3  # tangential viscous gain, capped at mu fn
    kg: float = 1.0e3  # grasp translational stiffness (N/m)
    cg: float = 20.0  # grasp translational damping
    kr: float = 4.0  # grasp rotational stiffness (N m/rad)
    cr: float = 0.05  # grasp rotational damping


def held_asset_step(
    state: HeldState,
    grasp_pos: torch.Tensor,  # (N, 3) grasp target of the asset origin
    grasp_quat: torch.Tensor,  # (N, 4) grasp target orientation
    fixed_pos: torch.Tensor,  # (N, 3) fixed asset centre
    fixed_quat: torch.Tensor,  # (N, 4)
    points_local: torch.Tensor,  # (P, 3) held-asset sample points
    sdf_fn,  # scalar local-frame SDF of the fixed asset
    params: ContactParams,
    task_name: str,
    dt: float,
    substeps: int = 8,
):
    """Advance the held asset one step under grasp and contact forces.

    ``task_name`` is the JAX signature's; nothing depends on it (threading
    is ordinary contact and friction). Returns (new_state, diag); diag holds the substep-averaged contact force
    (N, 3), grasp force (N, 3), grasp torque (N, 3) and the largest
    penetration (N,)."""
    p = params
    h = dt / substeps
    sdf_and_normal = torch.func.vmap(torch.func.grad_and_value(sdf_fn))
    n_envs, n_pts = grasp_pos.shape[0], points_local.shape[0]
    # (0, 0, -g m), built with fills: an indexed write of a Python number
    # into a CUDA tensor copies it from the host and synchronises
    gravity = torch.cat([torch.zeros_like(grasp_pos[:1, :2]), torch.full_like(grasp_pos[:1, :1], -9.81 * p.mass)], -1)

    def contact_wrench(pos, quat, linvel, angvel):
        pts_w = pos[:, None, :] + maths.quat_apply(quat[:, None, :], points_local[None])
        pts_f = maths.quat_apply_inverse(fixed_quat[:, None, :], pts_w - fixed_pos[:, None, :])
        n_f, sd = sdf_and_normal(pts_f.reshape(-1, 3))
        n_f, sd = n_f.reshape(n_envs, n_pts, 3), sd.reshape(n_envs, n_pts)
        n_f = n_f / torch.linalg.vector_norm(n_f, dim=-1, keepdim=True).clamp_min(1e-9)
        n_w = maths.quat_apply(fixed_quat[:, None, :], n_f)
        pen = torch.clamp(-sd, min=0.0)
        # point velocity v + w x r
        r = pts_w - pos[:, None, :]
        v_pt = linvel[:, None, :] + maths.cross(angvel[:, None, :], r)
        vn = (v_pt * n_w).sum(-1)
        # the velocity-proportional forces are impulse-capped by the effective
        # mass a force at offset r works against, so no substep reverses the
        # point's motion
        m_eff = 1.0 / (1.0 / p.mass + (r * r).sum(-1) / p.inertia)
        cap = m_eff / h
        fn = p.kn * pen + torch.clamp(cap, max=p.cn) * torch.clamp(-vn, min=0.0) * (pen > 0)
        vt = v_pt - vn[..., None] * n_w
        vt_norm = torch.linalg.vector_norm(vt, dim=-1).clamp_min(1e-9)
        ft_mag = torch.minimum(torch.clamp(cap, max=p.kt) * vt_norm, p.mu * fn)
        f = fn[..., None] * n_w - ft_mag[..., None] * vt / vt_norm[..., None]
        return f.sum(1), maths.cross(r, f).sum(1), pen.amax(-1)

    pos, quat = state.pos, state.quat
    linvel, angvel = state.linvel, state.angvel
    c_force = torch.zeros_like(pos)
    g_force = torch.zeros_like(pos)
    g_tau = torch.zeros_like(pos)
    max_pen = torch.zeros_like(pos[:, 0])

    for _ in range(substeps):
        fc, tc, pen = contact_wrench(pos, quat, linvel, angvel)
        # the grasp spring; its damping is applied implicitly below
        fg = p.kg * (grasp_pos - pos)
        tg = p.kr * maths.axis_angle_from_quat(maths.quat_mul(grasp_quat, maths.quat_conjugate(quat)))
        force = fc + fg + gravity
        torque = tc + tg
        # semi-implicit Euler with implicit grasp damping (stable for any gain)
        linvel = (linvel + h * force / p.mass) / (1.0 + h * p.cg / p.mass)
        angvel = (angvel + h * torque / p.inertia) / (1.0 + h * p.cr / p.inertia)
        lv_n = torch.linalg.vector_norm(linvel, dim=-1, keepdim=True)
        linvel = linvel * torch.clamp(p.v_max / lv_n.clamp_min(1e-9), max=1.0)
        av_n = torch.linalg.vector_norm(angvel, dim=-1, keepdim=True)
        angvel = angvel * torch.clamp(p.w_max / av_n.clamp_min(1e-9), max=1.0)
        pos = pos + h * linvel
        w_n = torch.linalg.vector_norm(angvel, dim=-1)
        dq = maths.quat_from_angle_axis(w_n * h, angvel / w_n[..., None].clamp_min(1e-9))
        quat = maths.quat_mul(dq, quat)
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        # substep-averaged wrenches: the contact micro-bounces in a small limit
        # cycle, so a single substep may catch the airborne phase
        c_force = c_force + fc / substeps
        g_force = g_force + fg / substeps
        g_tau = g_tau + tg / substeps
        max_pen = torch.maximum(max_pen, pen)

    diag = {"contact_force": c_force, "grasp_force": g_force, "grasp_torque": g_tau, "max_penetration": max_pen}
    return HeldState(pos=pos, quat=quat, linvel=linvel, angvel=angvel), diag
