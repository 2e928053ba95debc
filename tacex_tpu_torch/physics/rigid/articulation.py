"""Second-order Franka + gripper dynamics: mass matrix, gravity, torque control.

Port of ``tacex_tpu/physics/rigid/articulation.py``: the 7 revolute arm
joints plus 2 prismatic finger joints (9 DOF), with

  * the mass matrix M(q) = sum_i m_i J_v_i^T J_v_i + J_w_i^T (R_i I_i R_i^T)
    J_w_i from per-link CoM Jacobians, batched over envs (a loop over the
    9 bodies, never over envs);
  * the gravity torque as the exact gradient of the potential energy,
    ``torch.func.vmap(torch.func.grad(potential_energy))``;
  * torque-level control with implicit damping, integrated by semi-implicit
    Euler. Coriolis and centrifugal terms are omitted.

Inertial parameters: the published identified Panda values (Gaz et al.,
RA-L 2019). Constant tensors live in ``ArmDynamics``, built once per
device, so no step copies host data to the card; the 9x9 solves use
``solve_ex`` without its error check, so nothing reads a value back.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ...core import maths
from . import franka

NUM_DOF = 9  # 7 arm + 2 prismatic fingers
GRAVITY = 9.81

# link masses (kg): links 1..7; hand and each finger
_MASSES = (4.970684, 0.646926, 3.228604, 3.587895, 1.225946, 1.666555, 0.735522)
_HAND_MASS = 0.73
_FINGER_MASS = 0.015

# CoM in each link's modified-DH frame
_COMS = (
    (3.875e-03, 2.081e-03, -0.1750),
    (-3.141e-03, -2.872e-02, 3.495e-03),
    (2.7518e-02, 3.9252e-02, -6.6502e-02),
    (-5.317e-02, 1.04419e-01, 2.7454e-02),
    (-1.1953e-02, 4.1065e-02, -3.8437e-02),
    (6.0149e-02, -1.4117e-02, -1.0517e-02),
    (1.0517e-02, -4.252e-03, 6.1597e-02),
)
_HAND_COM = (-0.01, 0.0, 0.03)  # in the hand frame

# rotational inertia about each link CoM, link frame (kg m^2): Ixx, Ixy, Ixz, Iyy, Iyz, Izz
_INERTIA_ROWS = (
    (7.0337e-01, -1.3900e-04, 6.7720e-03, 7.0661e-01, 1.9169e-02, 9.1170e-03),
    (7.9620e-03, -3.9250e-03, 1.0254e-02, 2.8110e-02, 7.0400e-04, 2.5995e-02),
    (3.7242e-02, -4.7610e-03, -1.1396e-02, 3.6155e-02, -1.2805e-02, 1.0830e-02),
    (2.5853e-02, 7.7960e-03, -1.3320e-03, 1.9552e-02, 8.6410e-03, 2.8323e-02),
    (3.5549e-02, -2.1170e-03, -4.0370e-03, 2.9474e-02, 2.2900e-04, 8.6270e-03),
    (1.9640e-03, 1.0900e-04, -1.1580e-03, 4.3540e-03, 3.4100e-04, 5.4330e-03),
    (1.2516e-02, -4.2800e-04, -1.1960e-03, 1.0027e-02, -7.4100e-04, 4.8150e-03),
)
_HAND_INERTIA_DIAG = (1e-3, 2.5e-3, 1.7e-3)

# hand geometry: flange -> grasp frame, finger slide axis = hand y
HAND_TCP_OFFSET = 0.1034  # flange to grasp centre along flange z
FINGER_Z_OFFSET = 0.0584  # flange to finger base
FINGER_TRAVEL = (0.0, 0.04)  # prismatic range per finger (m)
FINGER_FORCE_LIMIT = 70.0  # N, per finger

# default joint PD gains: the arm after the reference HIGH_PD configs, fingers stiff
DEFAULT_KP = (400.0,) * 4 + (100.0,) * 3 + (4000.0,) * 2
DEFAULT_KD = (80.0,) * 4 + (20.0,) * 3 + (80.0,) * 2
TAU_LIMIT = (87.0,) * 4 + (12.0,) * 3 + (FINGER_FORCE_LIMIT,) * 2
FINGER_QD_LIMIT = 0.2


@dataclasses.dataclass(frozen=True)
class ArmDynamics:
    """The model's constant tensors on one device."""

    masses: torch.Tensor  # (7,)
    coms: torch.Tensor  # (7, 3)
    inertias: torch.Tensor  # (7, 3, 3)
    hand_com: torch.Tensor  # (3,)
    hand_inertia: torch.Tensor  # (3, 3)
    q_lower: torch.Tensor  # (9,)
    q_upper: torch.Tensor  # (9,)
    qd_limit: torch.Tensor  # (7,)
    kp: torch.Tensor  # (9,) DEFAULT_KP
    kd: torch.Tensor  # (9,) DEFAULT_KD
    tau_limit: torch.Tensor  # (9,)
    rotor: torch.Tensor  # (9, 9) rotor/transmission inertia floor


@functools.lru_cache(maxsize=8)
def dynamics_on(device) -> ArmDynamics:
    """``ArmDynamics`` on ``device`` (built once per device)."""
    device = torch.device(device)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    inertias = [
        [[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]] for ixx, ixy, ixz, iyy, iyz, izz in _INERTIA_ROWS
    ]
    return ArmDynamics(
        masses=t(_MASSES),
        coms=t(_COMS),
        inertias=t(inertias),
        hand_com=t(_HAND_COM),
        hand_inertia=torch.diag(t(_HAND_INERTIA_DIAG)),
        q_lower=t(franka.Q_LOWER + (FINGER_TRAVEL[0],) * 2),
        q_upper=t(franka.Q_UPPER + (FINGER_TRAVEL[1],) * 2),
        qd_limit=t(franka.QD_LIMIT),
        kp=t(DEFAULT_KP),
        kd=t(DEFAULT_KD),
        tau_limit=t(TAU_LIMIT),
        rotor=torch.diag(torch.full((NUM_DOF,), 3e-3, device=device)),
    )


def _link_frames(q7: torch.Tensor):
    """All link frames for (..., 7) joint angles.

    Returns (origins (..., 7, 3), rots (..., 7, 3, 3), hand_pos (..., 3),
    hand_rot (..., 3, 3)).
    """
    origins, rots = [], []
    pos = rot = None
    for i in range(franka.NUM_JOINTS):
        r_i, t_i = franka._mdh_transform(franka._LINKS[i], q7[..., i])
        if rot is None:  # the base frame is the identity
            pos, rot = t_i, r_i
        else:
            pos = pos + (rot @ t_i[..., None])[..., 0]
            rot = rot @ r_i
        origins.append(pos)
        rots.append(rot)
    hand_pos = pos + franka.FLANGE_OFFSET * rot[..., :, 2]
    return torch.stack(origins, -2), torch.stack(rots, -3), hand_pos, rot


def finger_positions(q9: torch.Tensor):
    """World positions of the two finger-pad centres for (..., 9) joints:
    ((..., 2, 3) pads, (..., 3) grasp centre, (..., 3, 3) hand rotation)."""
    _, _, hand_pos, hand_rot = _link_frames(q9[..., :7])
    base = hand_pos + HAND_TCP_OFFSET * hand_rot[..., :, 2]
    y = hand_rot[..., :, 1]
    pads = torch.stack([base + q9[..., 7:8] * y, base - q9[..., 8:9] * y], -2)
    return pads, base, hand_rot


def potential_energy(q9: torch.Tensor, dyn: ArmDynamics) -> torch.Tensor:
    """Gravitational potential of all links, the hand and the fingers for
    (..., 9) joints -> (...)."""
    origins, rots, hand_pos, hand_rot = _link_frames(q9[..., :7])
    coms_w = origins + (rots @ dyn.coms[..., None])[..., 0]
    u = (dyn.masses * coms_w[..., 2]).sum(-1)
    hand_com = hand_pos + (hand_rot @ dyn.hand_com[:, None])[..., 0]
    u = u + _HAND_MASS * hand_com[..., 2]
    fbase = hand_pos + FINGER_Z_OFFSET * hand_rot[..., :, 2]
    y = hand_rot[..., :, 1]
    u = u + _FINGER_MASS * ((fbase[..., 2] + q9[..., 7] * y[..., 2]) + (fbase[..., 2] - q9[..., 8] * y[..., 2]))
    return GRAVITY * u


def gravity_torque(q9: torch.Tensor) -> torch.Tensor:
    """(..., 9) joint torques that gravity exerts: dU/dq, the exact gradient
    of ``potential_energy`` (add it to cancel gravity)."""
    dyn = dynamics_on(q9.device)
    grad = torch.func.vmap(torch.func.grad(lambda q: potential_energy(q, dyn)))
    return grad(q9.reshape(-1, NUM_DOF)).reshape(q9.shape)


def mass_matrix(q9: torch.Tensor) -> torch.Tensor:
    """(..., 9, 9) symmetric positive-definite joint-space mass matrix."""
    dyn = dynamics_on(q9.device)
    origins, rots, hand_pos, hand_rot = _link_frames(q9[..., :7])
    axes = rots[..., :, :, 2]  # (..., 7, 3) revolute axes
    batch = q9.shape[:-1]
    zeros2 = q9.new_zeros(batch + (2, 3))
    joint = torch.arange(franka.NUM_JOINTS, device=q9.device)

    def jacobians(com_w, n_active):
        """(..., 9, 3) linear and angular CoM Jacobians of a body rigidly
        attached after arm joint ``n_active``."""
        active = (joint < n_active)[:, None]
        jv = torch.where(active, torch.linalg.cross(axes, com_w[..., None, :] - origins, dim=-1), 0.0)
        jw = torch.where(active, axes, 0.0)
        return torch.cat([jv, zeros2], -2), torch.cat([jw, zeros2], -2)

    def add_body(m, mass, jv, jw, i_w):
        return m + mass * (jv @ jv.transpose(-1, -2)) + jw @ i_w @ jw.transpose(-1, -2)

    m = q9.new_zeros(batch + (NUM_DOF, NUM_DOF))
    coms_w = origins + (rots @ dyn.coms[..., None])[..., 0]
    for i in range(franka.NUM_JOINTS):
        jv, jw = jacobians(coms_w[..., i, :], i + 1)
        r = rots[..., i, :, :]
        m = add_body(m, dyn.masses[i], jv, jw, r @ dyn.inertias[i] @ r.transpose(-1, -2))
    hand_com = hand_pos + (hand_rot @ dyn.hand_com[:, None])[..., 0]
    jv, jw = jacobians(hand_com, 7)
    m = add_body(m, _HAND_MASS, jv, jw, hand_rot @ dyn.hand_inertia @ hand_rot.transpose(-1, -2))
    # fingers: point masses on their prismatic DOFs
    fbase = hand_pos + FINGER_Z_OFFSET * hand_rot[..., :, 2]
    y = hand_rot[..., :, 1]
    dof = torch.arange(NUM_DOF, device=q9.device)[:, None]
    for k, sgn in ((7, 1.0), (8, -1.0)):
        jv, _ = jacobians(fbase + sgn * q9[..., k : k + 1] * y, 7)
        jv = torch.where(dof == k, sgn * y[..., None, :], jv)
        m = m + _FINGER_MASS * (jv @ jv.transpose(-1, -2))
    return m + dyn.rotor


@dataclasses.dataclass(frozen=True)
class GripperArmState:
    """Batched 9-DOF state (7 arm + 2 finger joints)."""

    q: torch.Tensor  # (N, 9)
    qd: torch.Tensor  # (N, 9)
    q_target: torch.Tensor  # (N, 9)

    @staticmethod
    def init(num_envs: int, q0_arm: torch.Tensor, finger_width: float = 0.04) -> "GripperArmState":
        qa = q0_arm.to(torch.float32).expand(num_envs, 7)
        qf = torch.full((num_envs, 2), finger_width / 2, dtype=torch.float32, device=q0_arm.device)
        q = torch.cat([qa, qf], -1)
        return GripperArmState(q=q, qd=torch.zeros_like(q), q_target=q)

    @property
    def arm(self) -> franka.ArmState:
        """The 7-DOF ``ArmState`` view, for the kinematics helpers."""
        return franka.ArmState(self.q[:, :7], self.qd[:, :7], self.q_target[:, :7])


def pd_torque(
    state: GripperArmState,
    kp: torch.Tensor | None = None,
    kd: torch.Tensor | None = None,
    gravity_comp: bool = True,
) -> torch.Tensor:
    """Joint PD torque toward ``q_target`` (default gains ``DEFAULT_KP`` and
    ``DEFAULT_KD``), with optional gravity compensation, clipped to the
    torque limits."""
    dyn = dynamics_on(state.q.device)
    kp = dyn.kp if kp is None else kp
    kd = dyn.kd if kd is None else kd
    tau = kp * (state.q_target - state.q) - kd * state.qd
    if gravity_comp:
        tau = tau + gravity_torque(state.q)
    return torch.clamp(tau, -dyn.tau_limit, dyn.tau_limit)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b for (N, 9, 9) a and (N, 9) b, with no host sync."""
    return torch.linalg.solve_ex(a, b[..., None], check_errors=False)[0][..., 0]


def _integrate(q, qd, h, dyn):
    """Clip the joint rates, step ``q`` by ``h qd`` into the joint range and
    zero the rate into an active limit."""
    qd = torch.cat(
        [
            torch.clamp(qd[:, :7], -dyn.qd_limit, dyn.qd_limit),
            torch.clamp(qd[:, 7:], -FINGER_QD_LIMIT, FINGER_QD_LIMIT),
        ],
        -1,
    )
    q = torch.clamp(q + h * qd, dyn.q_lower, dyn.q_upper)
    at_lo = (q <= dyn.q_lower + 1e-9) & (qd < 0)
    at_hi = (q >= dyn.q_upper - 1e-9) & (qd > 0)
    return q, torch.where(at_lo | at_hi, 0.0, qd)


def dynamics_step(
    state: GripperArmState, tau: torch.Tensor, dt: float, substeps: int = 2, gravity: bool = True
) -> GripperArmState:
    """Semi-implicit Euler: qdd = M(q)^-1 (tau - g(q)); qd += h qdd; q += h qd.
    ``gravity=False`` models perfect gravity compensation."""
    dyn = dynamics_on(state.q.device)
    h = dt / substeps
    q, qd = state.q, state.qd
    for _ in range(substeps):
        rhs = tau - gravity_torque(q) if gravity else tau
        qd = qd + h * _solve(mass_matrix(q), rhs)
        q, qd = _integrate(q, qd, h, dyn)
    return GripperArmState(q=q, qd=qd, q_target=state.q_target)


def step(
    state: GripperArmState,
    dt: float,
    kp: torch.Tensor | None = None,
    kd: torch.Tensor | None = None,
    tau_ext: torch.Tensor | None = None,
    gravity_comp: bool = True,
    substeps: int = 2,
) -> GripperArmState:
    """PD-controlled dynamics step with the gains taken implicitly:
    (M + h D + h^2 K) qd' = M qd + h (K (q_target - q) + tau_ext [- g]),
    stable for any gain; torque limits clamp the error the spring acts on."""
    dyn = dynamics_on(state.q.device)
    kp = dyn.kp if kp is None else kp
    kd = dyn.kd if kd is None else kd
    h = dt / substeps
    q, qd = state.q, state.qd
    for _ in range(substeps):
        m = mass_matrix(q)
        err = torch.clamp(state.q_target - q, -dyn.tau_limit / kp, dyn.tau_limit / kp)
        rhs = kp * err
        if not gravity_comp:
            rhs = rhs - gravity_torque(q)
        if tau_ext is not None:
            rhs = rhs + tau_ext
        a = m + torch.diag_embed(h * kd + h * h * kp)
        qd = _solve(a, (m @ qd[..., None])[..., 0] + h * rhs)
        q, qd = _integrate(q, qd, h, dyn)
    return GripperArmState(q=q, qd=qd, q_target=state.q_target)


def ee_wrench_to_tau(
    q9: torch.Tensor, wrench: torch.Tensor, ee_offset_pos: tuple[float, float, float] | None = None
) -> torch.Tensor:
    """(N, 6) [force; torque] wrench at the tool point -> (N, 9) joint
    torques through J^T (the fingers get zero: the wrench acts on the hand)."""
    ee_pos, _, origins, axes = franka.forward_kinematics(q9[:, :7], ee_offset_pos=ee_offset_pos)
    jac = franka.geometric_jacobian(ee_pos, origins, axes)  # (N, 6, 7)
    tau_arm = (jac.transpose(-1, -2) @ wrench[..., None])[..., 0]
    return torch.cat([tau_arm, q9.new_zeros(q9.shape[:-1] + (2,))], -1)


def operational_space_tau(
    state: GripperArmState,
    target_pos: torch.Tensor,  # (N, 3)
    target_quat: torch.Tensor,  # (N, 4)
    task_kp: torch.Tensor,  # (6,)
    task_kd: torch.Tensor,  # (6,)
    ee_offset_pos: tuple[float, float, float] | None = None,
    null_damping: float = 1.5,
) -> torch.Tensor:
    """Operational-space PD torque: J^T (kp pose_err - kd ee_vel) - kd_null qd.
    No gravity term: integrate with ``dynamics_step(gravity=False)``."""
    ee_pos, ee_quat, origins, axes = franka.forward_kinematics(state.q[:, :7], ee_offset_pos=ee_offset_pos)
    jac = franka.geometric_jacobian(ee_pos, origins, axes)
    ee_vel = (jac @ state.qd[:, :7, None])[..., 0]
    rot_err = maths.axis_angle_from_quat(maths.quat_mul(target_quat, maths.quat_conjugate(ee_quat)))
    err = torch.cat([target_pos - ee_pos, rot_err], -1)
    tau = ee_wrench_to_tau(state.q, task_kp * err - task_kd * ee_vel, ee_offset_pos)
    return tau - null_damping * torch.cat([state.qd[:, :7], torch.zeros_like(state.qd[:, 7:])], -1)


def osc_step(
    state: GripperArmState,
    target_pos: torch.Tensor,  # (N, 3)
    target_quat: torch.Tensor,  # (N, 4)
    task_kp: torch.Tensor,  # (6,)
    task_kd: torch.Tensor,  # (6,)
    dt: float,
    tau_ext: torch.Tensor | None = None,  # (N, 9), e.g. the grasp reaction through J^T
    ee_offset_pos: tuple[float, float, float] | None = None,
    null_damping: float = 1.5,
    substeps: int = 2,
) -> GripperArmState:
    """Operational-space-controlled dynamics step with implicit damping: the
    task damping J^T D J, the null-space damping and the finger PD go into
    the left-hand side,

      (M + h (J^T D J + D_null + D_f) + h^2 K_f) qd' =
            M qd + h (J^T kp err + K_f (qt_f - q_f) + tau_ext),

    with gravity perfectly compensated."""
    dyn = dynamics_on(state.q.device)
    h = dt / substeps
    q, qd = state.q, state.qd
    zeros7 = torch.zeros_like(dyn.kp[:7])
    d_joint = torch.cat([zeros7 + null_damping, dyn.kd[7:]])
    k_diag = torch.cat([zeros7, dyn.kp[7:]])
    lhs_diag = torch.diag(h * d_joint) + (h * h) * torch.diag(k_diag)
    for _ in range(substeps):
        ee_pos, ee_quat, origins, axes = franka.forward_kinematics(q[:, :7], ee_offset_pos=ee_offset_pos)
        jac7 = franka.geometric_jacobian(ee_pos, origins, axes)  # (N, 6, 7)
        jac = torch.cat([jac7, q.new_zeros(q.shape[0], 6, 2)], -1)  # (N, 6, 9)
        rot_err = maths.axis_angle_from_quat(maths.quat_mul(target_quat, maths.quat_conjugate(ee_quat)))
        err = torch.cat([target_pos - ee_pos, rot_err], -1)
        tau = (jac.transpose(-1, -2) @ (task_kp * err)[..., None])[..., 0]
        tau = tau + k_diag * (state.q_target - q)
        if tau_ext is not None:
            tau = tau + tau_ext
        m = mass_matrix(q)
        c = jac.transpose(-1, -2) @ (task_kd[:, None] * jac)  # J^T D J
        a = m + h * c + lhs_diag
        qd = _solve(a, (m @ qd[..., None])[..., 0] + h * tau)
        q, qd = _integrate(q, qd, h, dyn)
    return GripperArmState(q=q, qd=qd, q_target=state.q_target)
