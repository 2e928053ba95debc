"""The coupled world's geometric primitives and the affine body, port against
the JAX package on the same seeded numpy inputs.

Tolerances (f32): closest points and distances 1e-6 m on coordinates of
order 1e-2 m (the Voronoi-region cascade and its guarded divisions in
another order of operations); the crossing tests and the region choices
exactly (the inputs are drawn clear of the tests' thresholds, and the
degenerate triangles sit exactly on them in both); barycentric weights
1e-5; the affine body's constants, built in float64 numpy on both sides,
to f32 round-off (rtol 1e-6); its world points 1e-7 m; its energy rtol
1e-5 and its gradient within 1e-4 of the gradient's norm, against
``jax.grad``; the closed-form orthogonality Hessian rtol 1e-5 against
``jax.hessian``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.envs.grasp_lift.env import _cube_surface as jcube
from tacex_tpu.physics.soft import abd as jabd
from tacex_tpu.physics.soft import coupled as jcoupled
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch.envs.grasp_lift.env import _cube_surface as tcube
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import coupled as tcoupled
from tacex_tpu_torch.physics.soft import ipc as tipc

setup_torch()

T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
J = jnp.asarray


def _triangles(rng, m):
    """(m, 3, 3) triangles of ~1-10 mm, the last rows degenerate: a repeated
    vertex, three collinear vertices, and a zero triangle."""
    tri = rng.uniform(-0.01, 0.01, (m, 3, 3)).astype(np.float32)
    tri[-3, 2] = tri[-3, 0]
    tri[-2, 2] = 2.0 * tri[-2, 1] - tri[-2, 0]
    tri[-1] = 0.0
    return tri


def test_point_triangle_closest_and_distance():
    rng = np.random.default_rng(0)
    tri = _triangles(rng, 64)
    p = rng.uniform(-0.015, 0.015, (64, 3)).astype(np.float32)
    p[:8] = tri[:8].mean(1) + 1e-4 * rng.normal(size=(8, 3)).astype(np.float32)  # near the face region
    args = (p, tri[:, 0], tri[:, 1], tri[:, 2])
    q_j = np.asarray(jipc._point_triangle_closest(*map(J, args)))
    q_t = tipc._point_triangle_closest(*map(T, args)).numpy()
    np.testing.assert_allclose(q_t, q_j, atol=1e-6, rtol=0)
    d_j = np.asarray(jipc._point_triangle_distance(*map(J, args)))
    d_t = tipc._point_triangle_distance(*map(T, args)).numpy()
    np.testing.assert_allclose(d_t, d_j, atol=1e-6, rtol=0)
    assert np.isfinite(d_t).all() and (d_t > 0).all()
    # broadcast as the cross families call it: points (P, 1, 3) against triangles (1, K, 3)
    bj = np.asarray(jipc._point_triangle_distance(J(p[:, None]), *(J(tri[None, :, i]) for i in range(3))))
    bt = tipc._point_triangle_distance(T(p[:, None]), *(T(tri[None, :, i]) for i in range(3))).numpy()
    assert bt.shape == (64, 64)
    np.testing.assert_allclose(bt, bj, atol=1e-6, rtol=0)


def test_distance_gradient_matches_jax():
    """The distance's gradient in the point and the corners, as the barrier's
    Newton solve differentiates it, on proper triangles (the cube's, the
    peg's and the pads' are): at a degenerate one JAX's gradient is NaN
    (an unselected branch of the region cascade divides by zero) where the
    port's is finite."""
    rng = np.random.default_rng(1)
    tri = _triangles(rng, 32)[:-3]
    p = rng.uniform(-0.015, 0.015, (29, 3)).astype(np.float32)
    f_j = lambda *a: jipc._point_triangle_distance(*a).sum()  # noqa: E731
    g_j = jax.grad(f_j, argnums=(0, 1, 2, 3))(J(p), *(J(tri[:, i]) for i in range(3)))
    xs = [T(p).requires_grad_(True)] + [T(tri[:, i].copy()).requires_grad_(True) for i in range(3)]
    g_t = torch.autograd.grad(tipc._point_triangle_distance(*xs).sum(), xs)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_segment_crossing_tests():
    """Moeller-Trumbore against a fixed and a moving triangle: segments
    through the face, beside it, edge-on (in the triangle's plane) and
    against the degenerate triangles."""
    rng = np.random.default_rng(2)
    tri = _triangles(rng, 48)
    cen = tri.mean(1)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    off = 0.003 * nrm
    p0 = cen + off
    p1 = cen - off  # through the face
    p1[16:24] = p0[16:24] + 0.5 * off[16:24]  # stops short
    p0[24:32] = tri[24:32, 0] + 0.25 * (tri[24:32, 1] - tri[24:32, 0]) - 0.004 * (cen[24:32] - tri[24:32, 0])
    p1[24:32] = cen[24:32]  # edge-on: in the triangle's plane
    p0, p1 = p0.astype(np.float32), p1.astype(np.float32)
    args = (p0, p1, tri[:, 0], tri[:, 1], tri[:, 2])
    c_j = np.asarray(jipc._segment_crosses_triangle(*map(J, args)))
    c_t = tipc._segment_crosses_triangle(*map(T, args)).numpy()
    np.testing.assert_array_equal(c_t, c_j)
    assert c_j[:16].all() and not c_j[16:24].any() and not c_j[-3:].any()
    shift = rng.uniform(-0.002, 0.002, (48, 1, 3)).astype(np.float32)
    tri1 = tri + shift
    margs = (p0, p1, tri[:, 0], tri[:, 1], tri[:, 2], tri1[:, 0], tri1[:, 1], tri1[:, 2])
    m_j = np.asarray(jipc._segment_crosses_moving_triangle(*map(J, margs)))
    m_t = tipc._segment_crosses_moving_triangle(*map(T, margs)).numpy()
    np.testing.assert_array_equal(m_t, m_j)
    assert m_j.any() and not m_j.all()


def test_triangle_barycentric():
    rng = np.random.default_rng(3)
    tri = _triangles(rng, 64)
    w = rng.dirichlet((1.0, 1.0, 1.0), 64).astype(np.float32)
    w[:16] = rng.uniform(-0.5, 1.5, (16, 3))  # outside the simplex: clamped
    q = np.einsum("mc,mcd->md", w, tri).astype(np.float32)
    args = (q, tri[:, 0], tri[:, 1], tri[:, 2])
    b_j = np.asarray(jcoupled._triangle_barycentric(*map(J, args)))
    b_t = tcoupled._triangle_barycentric(*map(T, args)).numpy()
    np.testing.assert_allclose(b_t, b_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(b_t.sum(-1), 1.0, atol=1e-6)
    assert (b_t >= -1e-6).all()


@pytest.fixture(scope="module")
def bodies():
    """The Grasp-Lift cube and the Factory-UIPC peg as affine bodies, at the
    envs' settings."""
    pts, tris = jcube()
    assert np.array_equal(pts, tcube()[0]) and np.array_equal(tris, tcube()[1])
    peg = pts / 0.0075 * np.asarray((0.0075, 0.0075, 0.03))
    kw = dict(dt=0.01, d_hat=1e-3, kappa_contact=1e4, friction_mu=0.5, contact_k=0, ee_contact_k=0)
    out = []
    for p, dens in ((pts, 2000.0), (peg, 2000.0)):
        mj = jabd.AbdModel([p], [tris], mass_density=dens, kappa_ortho=1e7, cfg=jabd.AbdSolverCfg(**kw))
        mt = tabd.AbdModel([p], [tris], mass_density=dens, kappa_ortho=1e7, cfg=tabd.AbdSolverCfg(**kw), device="cpu")
        out.append((mj, mt))
    return out


def test_affine_body_constants(bodies):
    for mj, mt in bodies:
        for name in ("mass", "mass_inv", "gravity_q", "kappa_ortho", "volumes", "pts"):
            np.testing.assert_allclose(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), rtol=1e-6,
                                       atol=0, err_msg=name)
        np.testing.assert_array_equal(mt.tris.numpy(), np.asarray(mj.tris))
        np.testing.assert_array_equal(mt.vert_body.numpy(), np.asarray(mj.vert_body))
        np.testing.assert_array_equal(mt.tri_body.numpy(), np.asarray(mj.tri_body))
        assert mt._tri_radius_max == mj._tri_radius_max
    # the cube: 15 mm side at 2000 kg/m^3 -> 6.75 g
    np.testing.assert_allclose(float(bodies[0][1].mass[0, 0, 0]), 2000.0 * 0.015**3, rtol=1e-6)


def _poses(rng, n):
    """(n, 1, 12) poses near the identity: a few mm off, A within 5% of I."""
    q = np.zeros((n, 1, 12), np.float32)
    q[..., :3] = rng.uniform(-0.005, 0.005, (n, 1, 3))
    q[..., 3:] = (np.eye(3).reshape(9) + rng.uniform(-0.05, 0.05, (n, 1, 9))).astype(np.float32)
    return q


def test_world_points_and_energy(bodies):
    """``world_points`` and the ABD energy with its gradient, the scene a
    ground plane 1-3 mm below the cube's lowest corner, lagged friction on."""
    rng = np.random.default_rng(4)
    mj, mt = bodies[0]
    n = 3
    q = _poses(rng, n)
    q_tilde = q + rng.normal(0, 1e-4, q.shape).astype(np.float32)
    y_j = np.asarray(jax.vmap(mj.world_points)(J(q)))
    y_t = mt.world_points(T(q)).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-7, rtol=0)
    planes = np.zeros((n, 1, 4), np.float32)
    planes[:, 0, 2] = 1.0
    planes[:, 0, 3] = y_j[..., 2].min(-1) - rng.uniform(1e-4, 9e-4, n)  # inside d_hat
    sc_j = jipc.RigidSdfScene.empty(n)
    sc_j = jipc.RigidSdfScene(sc_j.spheres, sc_j.boxes, sc_j.capsules, J(planes))
    sc_t = tipc.RigidSdfScene.empty(n, device="cpu")
    sc_t = tipc.RigidSdfScene(sc_t.spheres, sc_t.boxes, sc_t.capsules, T(planes))
    aim = _poses(rng, n)
    strength = rng.uniform(0, 5, (n, 1, 12)).astype(np.float32)
    x_prev = y_j - rng.normal(0, 1e-4, y_j.shape).astype(np.float32)
    lam = rng.uniform(0, 1, y_j.shape[:2]).astype(np.float32)
    nd = np.zeros(y_j.shape, np.float32)
    nd[..., 2] = 1.0

    def e_j(qq, qt, sc, a, s, xp, la, nn):
        return mj._energy(qq, qt, sc, a, s, xp, (la, nn), None)

    args = (J(q), J(q_tilde), sc_j, J(aim), J(strength), J(x_prev), J(lam), J(nd))
    ej, gj = jax.jit(jax.vmap(jax.value_and_grad(e_j)))(*args)
    ej, gj = np.asarray(ej), np.asarray(gj)
    qv = T(q.copy()).requires_grad_(True)
    et = mt._energy(qv, T(q_tilde), sc_t, T(aim), T(strength), T(x_prev), (T(lam), T(nd)))
    (gt,) = torch.autograd.grad(et.sum(), qv)
    np.testing.assert_allclose(et.detach().numpy(), ej, rtol=1e-5)
    for i in range(n):
        assert np.linalg.norm(gt[i].numpy() - gj[i]) <= 1e-4 * np.linalg.norm(gj[i])
    assert (np.asarray(jax.vmap(lambda y, s: s.sdf(y))(J(y_j), sc_j)).min(-1) < 1e-3).all(), "no barrier active"


def test_ortho_hessian_and_inverse(bodies):
    """The closed-form orthogonality Hessian of the block preconditioner
    against ``jax.hessian``, and the 3x3 adjugate inverse."""
    rng = np.random.default_rng(5)
    _, mt = bodies[0]
    q = _poses(rng, 4)
    kap = float(mt.kappa_ortho[0])

    def ortho_b(a_flat):
        A = a_flat.reshape(3, 3)
        R = A.T @ A - jnp.eye(3)
        return kap * jnp.sum(R * R)

    h_j = np.stack([np.asarray(jax.hessian(ortho_b)(J(q[i, 0, 3:]))) for i in range(4)])
    h_t = tabd.ortho_hessian(T(q[:, 0]), mt.kappa_ortho.expand(4)).numpy()
    np.testing.assert_allclose(h_t, h_j, rtol=1e-5, atol=1e-5 * np.abs(h_j).max())
    A = T(q[:, 0, 3:].reshape(4, 3, 3))
    np.testing.assert_allclose(tabd.inverse3(A).numpy(), np.linalg.inv(q[:, 0, 3:].reshape(4, 3, 3)), atol=1e-6)


def test_unported_abd_branches_raise():
    """The body-body branches of ROADMAP item 8a are ported: a model with
    vertex-triangle (or edge-edge) candidates builds, counts its broad
    phase, and ``AbdModel.step`` (the standalone solve) runs: a free cube
    falls under gravity by g dt^2 in one step."""
    pts, tris = tcube()
    for kw, keys in ((dict(contact_k=8, ee_contact_k=0), ["vt_body"]), (dict(contact_k=0, ee_contact_k=4), [])):
        m = tabd.AbdModel([pts, pts + 1.0], [tris, tris], cfg=tabd.AbdSolverCfg(**kw), device="cpu")
        st = tabd.AbdState.identity(1, 2, device="cpu")
        assert sorted(m.broad_phase_overflow(m.world_points(st.q))) == keys
    m = tabd.AbdModel([pts], [tris], cfg=tabd.AbdSolverCfg(contact_k=0, ee_contact_k=0, newton_max_iter=2), device="cpu")
    st = m.step(tabd.AbdState.identity(1, 1, device="cpu"), tipc.RigidSdfScene.empty(1, device="cpu"))
    np.testing.assert_allclose(st.q[0, 0, 2].item(), -9.81 * m.cfg.dt**2, rtol=1e-3)
    assert torch.isfinite(st.q).all() and float(st.q[0, 0, :2].abs().max()) < 1e-9