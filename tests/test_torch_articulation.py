"""The port's 9-DOF Franka + gripper dynamics and rigid bodies against the
JAX package, on random joint states made with numpy.

Tolerances: positions 1e-6 m, torques and mass-matrix entries 1e-5 relative
to their scale (sums of ~10 f32 products of different magnitude), and the
states after implicit steps 1e-5 (rad, rad/s): a 9x9 solve of a matrix with
entries from 3e-3 to ~3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.physics.rigid import articulation as ja
from tacex_tpu.physics.rigid import bodies as jb
from tacex_tpu_torch.physics.rigid import articulation as ta
from tacex_tpu_torch.physics.rigid import bodies as tb

setup_torch()

N = 6
ATOL = 1e-5
POS_ATOL = 1e-6
T = lambda a: torch.from_numpy(np.array(a, np.float32))
J = lambda a: jnp.asarray(np.asarray(a, np.float32))
EE = (0.0, 0.0, ja.HAND_TCP_OFFSET)


def _q9(seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(ja.Q_LOWER), np.asarray(ja.Q_UPPER)
    q = lo + (hi - lo) * rng.uniform(0.2, 0.8, (N, 9))
    qd = rng.normal(0, 0.3, (N, 9)) * np.array([1] * 7 + [0.05] * 2)
    return q.astype(np.float32), qd.astype(np.float32)


def _state(q, qd, q_target):
    return ja.GripperArmState(J(q), J(qd), J(q_target)), ta.GripperArmState(T(q), T(qd), T(q_target))


def _rel_close(a, b, atol=ATOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, atol=atol * max(1.0, float(np.abs(b).max())))


def test_kinematic_quantities_match_jax():
    q, _ = _q9()
    pads_j, base_j, rot_j = jax.jit(ja.finger_positions)(J(q))
    pads_t, base_t, rot_t = ta.finger_positions(T(q))
    np.testing.assert_allclose(pads_t.numpy(), np.asarray(pads_j), atol=POS_ATOL)
    np.testing.assert_allclose(base_t.numpy(), np.asarray(base_j), atol=POS_ATOL)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=POS_ATOL)
    u_j = jax.jit(jax.vmap(ja.potential_energy))(J(q))
    _rel_close(ta.potential_energy(T(q), ta.dynamics_on("cpu")).numpy(), u_j)


def test_gravity_torque_and_mass_matrix_match_jax():
    """The gravity torque is ``torch.func`` of the potential, as JAX takes
    ``jax.grad`` of it; the mass matrix is symmetric positive definite."""
    q, _ = _q9(1)
    _rel_close(ta.gravity_torque(T(q)).numpy(), jax.jit(ja.gravity_torque)(J(q)))
    m_t = ta.mass_matrix(T(q))
    _rel_close(m_t.numpy(), jax.jit(ja.mass_matrix)(J(q)))
    assert torch.allclose(m_t, m_t.transpose(-1, -2), atol=1e-6)
    assert bool((torch.linalg.eigvalsh(m_t) > 0).all())
    # batch shapes other than (N, 9)
    assert ta.gravity_torque(T(q).reshape(2, 3, 9)).shape == (2, 3, 9)
    assert ta.mass_matrix(T(q[0])).shape == (9, 9)


def test_wrench_and_operational_space_torque_match_jax():
    q, qd = _q9(2)
    rng = np.random.default_rng(3)
    wrench = rng.normal(0, 5, (N, 6)).astype(np.float32)
    _rel_close(ta.ee_wrench_to_tau(T(q), T(wrench), EE).numpy(),
               jax.jit(lambda a, b: ja.ee_wrench_to_tau(a, b, J(EE)))(J(q), J(wrench)))
    st_j, st_t = _state(q, qd, q)
    kp = np.array([300.0] * 3 + [30.0] * 3, np.float32)
    target_pos = rng.uniform(0.3, 0.6, (N, 3)).astype(np.float32)
    target_quat = np.tile(np.array([0.0, 1.0, 0.0, 0.0], np.float32), (N, 1))
    tau_j = jax.jit(lambda s: ja.operational_space_tau(s, J(target_pos), J(target_quat), J(kp), 2 * jnp.sqrt(J(kp)),
                                                       J(EE)))(st_j)
    tau_t = ta.operational_space_tau(st_t, T(target_pos), T(target_quat), T(kp), 2 * torch.sqrt(T(kp)), EE)
    _rel_close(tau_t.numpy(), tau_j)


def _compare_state(st_t, st_j, atol=ATOL):
    for name in ("q", "qd", "q_target"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["osc_step", "step", "dynamics_step", "pd_torque"])
def test_dynamics_steps_match_jax(kind):
    """One implicit OSC step (Factory's controller, with an external torque),
    one implicit joint-PD step, one explicit step under gravity and the PD
    torque, from the same state."""
    q, qd = _q9(4)
    rng = np.random.default_rng(5)
    q_target = np.clip(q + rng.normal(0, 0.05, q.shape), ja.Q_LOWER, ja.Q_UPPER).astype(np.float32)
    st_j, st_t = _state(q, qd, q_target)
    dt = 1.0 / 120.0
    if kind == "osc_step":
        kp = np.array([300.0] * 3 + [30.0] * 3, np.float32)
        tp = rng.uniform(0.3, 0.6, (N, 3)).astype(np.float32)
        tq = np.tile(np.array([0.0, 1.0, 0.0, 0.0], np.float32), (N, 1))
        tau_ext = (rng.normal(0, 1, (N, 9)) * np.array([1] * 7 + [0] * 2)).astype(np.float32)
        out_j = jax.jit(lambda s: ja.osc_step(s, J(tp), J(tq), J(kp), 2 * jnp.sqrt(J(kp)), dt, tau_ext=J(tau_ext),
                                              ee_offset_pos=J(EE)))(st_j)
        out_t = ta.osc_step(st_t, T(tp), T(tq), T(kp), 2 * torch.sqrt(T(kp)), dt, tau_ext=T(tau_ext), ee_offset_pos=EE)
    elif kind == "step":
        tau_ext = rng.normal(0, 1, (N, 9)).astype(np.float32)
        out_j = jax.jit(lambda s: ja.step(s, dt, tau_ext=J(tau_ext)))(st_j)
        out_t = ta.step(st_t, dt, tau_ext=T(tau_ext))
    elif kind == "dynamics_step":
        tau = rng.normal(0, 2, (N, 9)).astype(np.float32)
        out_j = jax.jit(lambda s: ja.dynamics_step(s, J(tau), dt))(st_j)
        out_t = ta.dynamics_step(st_t, T(tau), dt)
    else:
        _rel_close(ta.pd_torque(st_t).numpy(), jax.jit(ja.pd_torque)(st_j))
        return
    _compare_state(out_t, out_j)
    assert not np.allclose(np.asarray(out_j.q), q)


def test_gripper_state_init_and_arm_view():
    q0 = np.array([0.1, -0.2, 0.0, -2.0, 0.0, 1.8, 0.8], np.float32)
    st_j = ja.GripperArmState.init(3, J(q0), finger_width=0.014)
    st_t = ta.GripperArmState.init(3, T(q0), finger_width=0.014)
    _compare_state(st_t, st_j, atol=0.0)
    assert st_t.arm.q.shape == (3, 7) and torch.equal(st_t.arm.q, st_t.q[:, :7])


def test_rigid_bodies_integrate_match_jax():
    rng = np.random.default_rng(6)
    n, b = 4, 3
    leaves = dict(
        pos=rng.normal(0, 0.1, (n, b, 3)), quat=rng.normal(size=(n, b, 4)),
        lin_vel=rng.normal(0, 0.5, (n, b, 3)), ang_vel=rng.normal(0, 2.0, (n, b, 3)),
    )
    leaves["quat"] /= np.linalg.norm(leaves["quat"], axis=-1, keepdims=True)
    inv_mass = np.array([1.0, 0.0, 2.0], np.float32)
    st_j = jb.RigidState(**{k: J(v) for k, v in leaves.items()})
    st_t = tb.RigidState(**{k: T(v) for k, v in leaves.items()})
    out_j = jax.jit(lambda s: jb.integrate(s, 0.01, inv_mass=J(inv_mass)))(st_j)
    out_t = tb.integrate(st_t, 0.01, inv_mass=T(inv_mass))
    for k in leaves:
        np.testing.assert_allclose(getattr(out_t, k).numpy(), np.asarray(getattr(out_j, k)), atol=1e-6, err_msg=k)
    init = tb.RigidState.init(2, 3)
    assert init.quat.shape == (2, 3, 4) and float(init.quat[..., 0].min()) == 1.0
    np.testing.assert_allclose(tb.integrate(init, 0.1).lin_vel[..., 2].numpy(), -0.981, rtol=1e-6)
