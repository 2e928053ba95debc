"""The coupled FEM+ABD world with the FEM model's own contact families on,
port against the JAX package: the pressed two-gel union of
``_torch_contact`` (self contact and edge-edge contact at K = 4) and a free
6 mm affine cube 0.3 mm above the top slab (the cross families), one
``CoupledModel.step`` at 3 Newton x 8 CG iterations with the convergence
stop off. The JAX step is ``_torch_coupled.per_env_step`` (one jit of
``CoupledModel._step_single`` called env by env, ~20 s of trace and
compile on the CPU).

Tolerances (f32): gel positions ``_torch_contact.ATOL`` (1.5e-5 m) and
velocities that over dt; the cube's q 1.5e-5 (``tests/_torch_coupled.py``'s
Q_ATOL); the broad-phase counts exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_contact import ATOL, GAP, LOWER, N, SIZE, as_torch, pressed, union_models
from _torch_coupled import per_env_step
from tacex_tpu.physics.soft import abd as jabd
from tacex_tpu.physics.soft import coupled as jcoupled
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import coupled as tcoupled
from tacex_tpu_torch.physics.soft import ipc as tipc

setup_torch()

Q_ATOL = 1.5e-5
HALF = 0.003
FAMILIES = dict(self_contact_k=4, ee_contact_k=4)
CUBE_PTS = np.array([[x, y, z] for x in (-HALF, HALF) for y in (-HALF, HALF) for z in (-HALF, HALF)], np.float64)
CUBE_TRIS = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
ABD_CFG = dict(dt=0.01, d_hat=0.0005, kappa_contact=1e3, friction_mu=0.0, contact_k=0, ee_contact_k=0,
               gravity=(0.0, 0.0, 0.0))


def _port_world(**fem_kw):
    _, model_t, _, _ = union_models(**FAMILIES)
    if fem_kw:
        model_t = tipc.SoftBodyModel(model_t.mesh, cfg=model_t.cfg.replace(**fem_kw),
                                     attachment_verts=model_t.attachment_verts.numpy(), device="cpu")
    abd = tabd.AbdModel([CUBE_PTS], [CUBE_TRIS], cfg=tabd.AbdSolverCfg(**ABD_CFG), device="cpu")
    return tcoupled.CoupledModel(model_t, abd)


def _inputs():
    _, model_t, anchors, n_bot = union_models(**FAMILIES)
    x, aim = pressed(model_t, anchors, n_bot)
    top = 1.5 * SIZE[2] + GAP - LOWER  # the top slab's top face
    q = np.zeros((N, 1, 12), np.float32)
    q[:, 0, 3] = q[:, 0, 7] = q[:, 0, 11] = 1.0
    q[:, 0, :3] = [[0.0005, -0.0003, top + HALF + 0.0003], [-0.0004, 0.0002, top + HALF + 0.00025]]
    return x, np.zeros_like(x), q, np.zeros_like(q), aim


@pytest.fixture(scope="module")
def stepped():
    model_j, *_ = union_models(**FAMILIES)
    world_j = jcoupled.CoupledModel(model_j, jabd.AbdModel([CUBE_PTS], [CUBE_TRIS], cfg=jabd.AbdSolverCfg(**ABD_CFG)))
    x, v, q, qd, aim = _inputs()
    fj, aj = per_env_step(world_j)(jipc.SoftBodyState(x=jnp.asarray(x), v=jnp.asarray(v)),
                                   jabd.AbdState(q=jnp.asarray(q), qd=jnp.asarray(qd)), jipc.RigidSdfScene.empty(N),
                                   jnp.asarray(aim))
    world_t = _port_world()
    tx, tv, tq, tqd, taim = as_torch(x, v, q, qd, aim)
    ft, at = world_t.step(tipc.SoftBodyState(x=tx, v=tv), tabd.AbdState(q=tq, qd=tqd),
                          tipc.RigidSdfScene.empty(N, device="cpu"), taim)
    return world_j, world_t, (fj, aj), (ft, at)


def test_coupled_step_with_fem_families_matches(stepped):
    _, world_t, (fj, aj), (ft, at) = stepped
    x0, _, q0, _, _ = _inputs()
    dt = world_t.fem.cfg.dt
    np.testing.assert_allclose(ft.x.numpy(), np.asarray(fj.x), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ft.v.numpy(), np.asarray(fj.v), atol=ATOL / dt, rtol=0)
    np.testing.assert_allclose(at.q.numpy(), np.asarray(aj.q), atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(at.qd.numpy(), np.asarray(aj.qd), atol=Q_ATOL / dt, rtol=0)
    assert np.abs(ft.x.numpy() - x0).max() > 5e-5 and np.abs(at.q.numpy() - q0).max() > 5e-5


def test_coupled_broad_phase_overflow_matches(stepped):
    world_j, world_t, (fj, aj), (ft, at) = stepped
    cj = jax.jit(jax.vmap(world_j.broad_phase_overflow))(fj.x, aj.q)
    ct = world_t.broad_phase_overflow(ft.x, at.q)
    assert sorted(ct) == sorted(cj) == ["ee", "vt_cross_a", "vt_cross_b", "vt_self"]
    for key in cj:
        np.testing.assert_array_equal(ct[key].numpy(), np.asarray(cj[key]))
    assert all(int(v.min()) > 0 for v in ct.values())


def test_coupled_solve_ignores_ccd_substeps():
    """The JAX ``CoupledModel`` never reads ``ccd_substeps``: the port's accepts
    ``ccd_substeps=2`` and takes the same single solve a step."""
    x, v, q, qd, aim = _inputs()
    out = []
    for k in (1, 2):
        world = _port_world(ccd_substeps=k, newton_max_iter=1, cg_iters=2)
        assert world.fem.cfg.ccd_substeps == k
        tx, tv, tq, tqd, taim = as_torch(x, v, q, qd, aim)
        out.append(world.step(tipc.SoftBodyState(x=tx, v=tv), tabd.AbdState(q=tq, qd=tqd),
                              tipc.RigidSdfScene.empty(N, device="cpu"), taim))
    for a, b in zip(dataclasses.astuple(out[0][0]) + dataclasses.astuple(out[0][1]),
                    dataclasses.astuple(out[1][0]) + dataclasses.astuple(out[1][1])):
        assert torch.equal(a, b)
