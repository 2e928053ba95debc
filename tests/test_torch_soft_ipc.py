"""The port's soft FEM gel solver against the JAX package.

The scene is ``_torch_soft``'s: the UIPC envs' "low" gel pad at 2 envs,
attached at its mount face and pressed onto a ball. Tolerances:

  * the mesh and the FEM rest data are numpy copies: equal;
  * barrier values and derivatives: rtol 1e-5 (f32);
  * energy: rtol 1e-5; gradient and Hessian-vector product: within 1e-4 of
    the vector's norm (the sums run in another order);
  * a step: gel positions within STEP_ATOL = 1.5e-5 m of JAX's (absolute;
    the gel sits ~0.35 m from the origin, where one f32 step is 3e-8 m),
    against displacements of 2-4e-4 m. Two f32 CG solves drift apart: each
    Hessian-vector product differs by rounding (~1e-7 relative) and 16 CG
    iterations on the stiff contact system amplify it. With one CG
    iteration a step agrees to 1e-7 m (``test_torch_soft_step.py``).

``test_torch_soft_step.py`` holds that case, the default convergence test
and the CCD substeps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_soft import N, models, press_inputs, scenes, step_both
from tacex_tpu.physics.soft import fem as jfem
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import fem as tfem
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh

setup_torch()

STEP_ATOL = 1.5e-5
# the solver settings of every test here: velocity_tol = 0, so no convergence
# decision can flip, and one jit of the JAX step serves the whole file
SOLVER = dict(velocity_tol=0.0)


def assert_steps_match(atol, min_disp=2e-4, **kw) -> None:
    """One and two steps of the press, port against JAX: each env's gel
    positions within ``atol`` (m) and velocities within ``atol / dt`` a step
    (the velocity is the displacement over dt)."""
    x0, traj = step_both(2, **kw)
    for steps, (xj, xt, vj, vt) in enumerate(traj, 1):
        disp = np.abs(xj - x0).max(axis=(1, 2))
        assert (disp > min_disp).all(), disp
        err = np.abs(xt - xj).max(axis=(1, 2))
        assert (err <= atol).all(), (steps, err, disp)
        np.testing.assert_allclose(vt, vj, atol=60.0 * atol * steps)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("res", [(8, 10, 2), (16, 20, 3), (3, 2, 1)])
def test_box_mesh_matches_jax(res):
    kw = dict(center=(0.0, 0.0, -0.00225))
    mj = jmesh.box_tet_mesh((0.02075, 0.02525, 0.0045), res, use_native=False, **kw)
    mt = tmesh.box_tet_mesh((0.02075, 0.02525, 0.0045), res, **kw)
    for name in ("points", "tets", "surface_tris", "surface_verts"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name), err_msg=name)
    if res == (8, 10, 2):
        assert (mt.num_vertices, len(mt.tets), len(mt.surface_verts)) == (297, 960, 234)
    dm_j, vol_j = jfem.precompute_rest(mj.points, mj.tets)
    dm_t, vol_t = tfem.precompute_rest(mt.points, mt.tets)
    np.testing.assert_array_equal(dm_t, dm_j)
    np.testing.assert_array_equal(tfem.lumped_masses(mt.points, mt.tets, 1000.0), jfem.lumped_masses(mj.points, mj.tets, 1000.0))


def test_union_and_surface_match_jax():
    parts = [jmesh.box_tet_mesh((0.01, 0.01, 0.004), (2, 2, 1), use_native=False),
             jmesh.box_tet_mesh((0.01, 0.01, 0.004), (2, 3, 2), center=(0.02, 0, 0), use_native=False)]
    uj, off_j = jmesh.union_meshes(parts)
    ut, off_t = tmesh.union_meshes(parts)
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(ut.surface_tris, uj.surface_tris)
    np.testing.assert_array_equal(tmesh.extract_surface(uj.tets, uj.points), jmesh.extract_surface(uj.tets, uj.points))


def test_barrier_matches_jax():
    """Values, and first and second derivatives (the Hessian-vector products
    differentiate the barrier twice), across the quadratic extension below
    d0 = 0.1 d_hat, the log branch and the inactive range."""
    kappa, d_hat = 2e4, 5e-4
    d = np.concatenate([np.linspace(-1e-3, 1.2e-3, 301), [0.0, 5e-5, 5e-4, 1.0]]).astype(np.float32)
    b = lambda x: jipc.barrier_extended(x, kappa, d_hat)  # noqa: E731
    d_j = jnp.asarray(d)
    bj = np.asarray(jax.jit(b)(d_j))
    g1j = np.asarray(jax.jit(jax.vmap(jax.grad(b)))(d_j))
    g2j = np.asarray(jax.jit(jax.vmap(jax.grad(jax.grad(b))))(d_j))
    fj = np.asarray(jax.jit(lambda x: jipc.barrier_force_mag(x, kappa, d_hat))(d_j))

    dt = torch.from_numpy(d).requires_grad_(True)
    bt = tipc.barrier_extended(dt, kappa, d_hat)
    (g1t,) = torch.autograd.grad(bt.sum(), dt, create_graph=True)
    (g2t,) = torch.autograd.grad(g1t.sum(), dt)
    for name, t, j in (("barrier", bt, bj), ("d/dd", g1t, g1j), ("d2/dd2", g2t, g2j),
                       ("force", tipc.barrier_force_mag(dt.detach(), kappa, d_hat), fj)):
        t = t.detach().numpy()
        assert np.isfinite(t).all(), name
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max(), err_msg=name)
    # the force is the barrier's slope where the barrier is active (at d0
    # itself the clip's tie halves one side's slope)
    smooth = (d < d_hat) & (d != np.float32(0.1 * d_hat))
    np.testing.assert_allclose(fj[smooth], np.abs(g1j[smooth]), rtol=1e-4)


@pytest.fixture(scope="module")
def pressed():
    """The gel after one JAX step of the press, and the inputs of its next
    step: (x_prev, x, x_tilde, aim, spheres, planes)."""
    model_j, model_t, step_j = models(**SOLVER)
    x0, v0, aim, sph, planes = press_inputs(model_j)
    sj, _ = scenes(sph, planes)
    s1 = step_j(jipc.SoftBodyState(x=jnp.asarray(x0), v=jnp.asarray(v0)), sj, jnp.asarray(aim))
    x1, v1 = np.asarray(s1.x), np.asarray(s1.v)
    dt = model_j.cfg.dt
    x_tilde = (x1 + dt * v1 + dt * dt * np.array([0.0, 0.0, -9.81], np.float32)).astype(np.float32)
    return x0, x1, x_tilde, aim, sph, planes


def test_friction_lag_matches_jax(pressed):
    """(lambda_n, normal) at the pressed gel: the barrier's force magnitude
    and the normalised SDF gradient of each surface vertex."""
    model_j, model_t, _ = models(**SOLVER)
    _, x1, _, _, sph, planes = pressed
    sj, st = scenes(sph, planes)
    c = model_j.cfg

    def lag(x, sc):
        xs = x[model_j.surface_verts]
        d = sc.sdf(xs)
        n = jax.vmap(jax.grad(lambda p: sc.sdf(p[None])[0]))(xs)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return jipc.barrier_force_mag(d, c.kappa, c.d_hat), n

    lam_j, n_j = jax.jit(jax.vmap(lag))(jnp.asarray(x1), sj)
    lam_t, n_t = model_t._friction_lag(torch.from_numpy(x1), st)
    assert float(lam_t.max()) > 0.0, "no surface vertex within d_hat of the ball"
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-4, atol=1e-4 * float(np.abs(lam_j).max()))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)


def test_energy_gradient_hvp_match_jax(pressed):
    """The incremental potential of the pressed gel, with friction lagged
    from it, its gradient and a Hessian-vector product, each env's against
    ``jax.grad`` and forward-over-reverse ``jax.jvp`` of its own energy."""
    model_j, model_t, _ = models(**SOLVER)
    x0, x1, x_tilde, aim, sph, planes = pressed
    sj, st = scenes(sph, planes)
    lam, nrm = model_t._friction_lag(torch.from_numpy(x1), st)
    lam, nrm = lam.numpy(), nrm.numpy()
    dt = model_j.cfg.dt
    p = np.random.default_rng(0).normal(size=x1.shape).astype(np.float32) * 1e-4

    def one(x, xt, sc, a, xp, ln, nd, pp):
        energy = lambda xx: model_j._energy(xx, xt, sc, a, xp, (ln, nd), dt=dt)  # noqa: E731
        return energy(x), jax.grad(energy)(x), jax.jvp(jax.grad(energy), (x,), (pp,))[1]

    e_j, g_j, hp_j = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (x1, x_tilde)), sj,
                                           *(jnp.asarray(a) for a in (aim, x0, lam, nrm, p)))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    energy = lambda xx: model_t._energy(xx, t(x_tilde), st, t(aim), t(x0), (t(lam), t(nrm)), dt)  # noqa: E731
    e_t, g_t, hvp = tipc.derivatives(energy, t(x1))
    hp_t = hvp(t(p))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    for k in range(N):
        assert _rel(g_t[k].numpy(), g_j[k]) <= 1e-4, (k, _rel(g_t[k].numpy(), g_j[k]))
        assert _rel(hp_t[k].numpy(), hp_j[k]) <= 1e-4, (k, _rel(hp_t[k].numpy(), hp_j[k]))
    # the products are each env's own: a direction in env 0 alone moves no other env
    only0 = torch.zeros_like(t(p))
    only0[0] = t(p)[0]
    assert float(hvp(only0)[1:].abs().max()) == 0.0


def test_cofactor_det_matches_lu_det():
    f = np.random.default_rng(1).normal(size=(64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tfem.det3(torch.from_numpy(f)).numpy(), np.asarray(jnp.linalg.det(jnp.asarray(f))),
                               rtol=1e-5, atol=1e-6)


def test_step_matches_jax():
    """Two steps of the press at velocity_tol = 0: every Newton iteration is
    taken on both sides, so no convergence decision can flip."""
    assert_steps_match(STEP_ATOL, **SOLVER)


def test_sphere_contact_force_matches_jax(pressed):
    model_j, model_t, _ = models(**SOLVER)
    _, x1, _, _, sph, planes = pressed
    sj, st = scenes(sph, planes)
    f_j = np.asarray(jax.jit(model_j.sphere_contact_force)(jipc.SoftBodyState(x=jnp.asarray(x1), v=jnp.zeros_like(x1)), sj))
    f_t = model_t.sphere_contact_force(tipc.SoftBodyState(x=torch.from_numpy(x1), v=torch.zeros(x1.shape)), st).numpy()
    assert f_t.shape == (N, 1, 3) and np.abs(f_j).max() > 1e-4
    assert (f_j[..., 2] < 0).all(), "the gel above the ball pushes it down"
    np.testing.assert_allclose(f_t, f_j, rtol=1e-4, atol=1e-4 * np.abs(f_j).max())


def test_unported_branches_raise():
    """Every branch of the model is ported now, its gradient too. Shell elements join it: their
    masses add to the tets' lumped masses and their energies to the elastic
    energy (held to the JAX package in ``test_torch_shell*.py``). Self,
    static-trimesh and edge-edge contact and the broad-phase counters build
    and count (held to the JAX package in ``test_torch_uipc_families.py``); a
    scene with a thread collider steps (held to the JAX package in
    ``test_torch_abd_threads.py``)."""
    from tacex_tpu_torch.physics.soft import codim as tcodim
    from tacex_tpu_torch.physics.soft.fem import lumped_masses

    mesh = tmesh.box_tet_mesh((0.01, 0.01, 0.004), (2, 2, 1))
    top = mesh.surface_tris[(mesh.points[mesh.surface_tris][..., 2] > 0.0019).all(-1)]
    shells = tcodim.build_shell_elements(mesh.points, top, num_vertices=mesh.num_vertices)
    plain = tipc.SoftBodyModel(mesh, device="cpu")
    with_shells = tipc.SoftBodyModel(mesh, device="cpu", shell_elems=shells)
    assert len(top) == 8 and with_shells.shell is not None and plain.shell is None
    np.testing.assert_allclose(with_shells.masses.numpy(),
                               (lumped_masses(mesh.points, mesh.tets, 1000.0) + shells.masses).astype(np.float32))
    x = torch.from_numpy(mesh.points)[None] * torch.tensor([1.1, 1.0, 1.0])  # a stretch loads the membrane
    args = (x, x, tipc.RigidSdfScene.empty(1, device="cpu"), torch.zeros((1, 1, 3)), x, None, 0.01)
    shell_part = tcodim.membrane_energy(x, with_shells.shell) + tcodim.bending_energy(x, with_shells.shell)
    assert shell_part.item() > 0
    np.testing.assert_allclose(with_shells._energy(*args).numpy(), (plain._energy(*args) + shell_part).numpy(),
                               rtol=1e-6)
    families = tipc.SoftBodyModel(mesh, device="cpu", cfg=tipc.IpcSolverCfg(self_contact_k=4, ee_contact_k=4),
                                  static_tris=np.zeros((1, 3, 3), np.float32))
    counts = families.broad_phase_overflow(torch.from_numpy(mesh.points)[None])
    assert sorted(counts) == ["ee", "vt_self", "vt_static"] and all(v.shape == (1,) for v in counts.values())
    model = tipc.SoftBodyModel(mesh, device="cpu")
    assert model.broad_phase_overflow(torch.from_numpy(mesh.points)[None]) == {}
    scene = tipc.RigidSdfScene.empty(1, device="cpu")
    # thread colliders (ROADMAP item 8a) are ported: a disabled thread leaves the free fall as it was
    threaded = tipc.RigidSdfScene(scene.spheres, scene.boxes, scene.capsules, scene.planes, torch.zeros((1, 1, 12)))
    free = model.step(tipc.SoftBodyState.init(1, mesh.points, device="cpu"), scene)
    np.testing.assert_array_equal(
        model.step(tipc.SoftBodyState.init(1, mesh.points, device="cpu"), threaded).x.numpy(), free.x.numpy())
    # SoftBodyModel.step differentiates (held to the JAX package in test_torch_grad.py); ShellModel.step
    # keeps its refusal until ROADMAP item 3c
    state = tipc.SoftBodyState.init(1, mesh.points, device="cpu")
    short = tipc.SoftBodyModel(mesh, device="cpu", cfg=tipc.IpcSolverCfg(newton_max_iter=1, cg_iters=1))
    stepped = short.step(tipc.SoftBodyState(x=state.x.requires_grad_(True), v=state.v), scene)
    assert stepped.x.grad_fn is not None and stepped.v.grad_fn is not None
    from tacex_tpu_torch.physics.soft import shell as tshell

    cloth = tshell.ShellModel(mesh.points, top, device="cpu")
    cloth_state = tipc.SoftBodyState(x=torch.from_numpy(mesh.points)[None].requires_grad_(True),
                                     v=torch.zeros((1,) + mesh.points.shape))
    with pytest.raises(RuntimeError, match="no gradient.*item 3c"):
        cloth.step(cloth_state, scene)
