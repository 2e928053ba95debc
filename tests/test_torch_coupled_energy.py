"""The coupled world's cross families and joint energy, port against the JAX
package, on the Grasp-Lift scene at 2 envs pressed by hand: each pad moved
0.6 mm toward the cube (0.4 mm from its faces, inside the 1 mm barrier
reach; 0.75 mm for ``missed_barriers``), the gel and the cube's pose
jittered by seeded noise, and an iterate a seeded small step away from the
start, so the barriers, the friction lags and the orthogonality term are
all active.

Tolerances (f32): candidate sets exactly (ties in the centroid distances
go to the lower index on both sides); distances 1e-7 m; lagged forces rtol
1e-4 of their largest, normals and body-local points 1e-5; the joint
energy rtol 1e-6; its gradient and its Hessian-vector product within 1e-4
of their norms (the sums run in another order; the HVP against
``jax.jvp(jax.grad)``); the block preconditioner's ABD rows within
cond x eps of a float64 solve (its f32 inverse's error bound), its FEM
rows rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_coupled import N, scene
from tacex_tpu.physics.soft import coupled as jcoupled
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch.physics.soft import coupled as tcoupled
from tacex_tpu_torch.physics.soft import ipc as tipc

setup_torch()

T = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731
J = jnp.asarray


def _jax_problem(env_j, x, v, q, qd, aim, z_k):
    """One env's joint energy (the JAX package's pieces as ``_step_single``
    composes them) and its lags at z_k."""
    fem, abd, world, sc = env_j.gel, env_j.cube, env_j.world, env_j.scene
    c, ca = fem.cfg, abd.cfg
    V = x.shape[0]
    x_tilde = x + c.dt * v + c.dt * c.dt * jnp.asarray(c.gravity, jnp.float32)
    q_tilde = q + ca.dt * qd + ca.dt**2 * jnp.einsum("bij,bj->bi", abd.mass_inv, abd.gravity_q)
    xs0, y0 = x[fem.surface_verts], abd.world_points(q)
    candA, validA = world._cross_candidates(xs0, y0)
    candB, validB = world._cross_candidates_b(x, y0)
    cand = (candA, validA, candB, validB)
    ops = world._gather_ops(candA, candB)
    unpack = lambda z: (z[: 3 * V].reshape(V, 3), z[3 * V :].reshape(1, 12))  # noqa: E731

    def scene_lag(p, kappa, d_hat):
        n = jax.vmap(jax.grad(lambda pp: sc.sdf(pp[None])[0]))(p)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return jipc.barrier_force_mag(sc.sdf(p), kappa, d_hat), n

    xk, qk = unpack(z_k)
    fl = scene_lag(xk[fem.surface_verts], c.kappa, c.d_hat)
    al = scene_lag(abd.world_points(qk), ca.kappa_contact, ca.d_hat)
    cl = world._cross_lag(xk, qk, cand, q, ops)
    aim_strength = jnp.zeros((1, 12))

    def energy(z):
        xx, qq = unpack(z)
        e = fem._energy(xx, x_tilde, sc, aim, x, fl, None, None, None, None, None)
        e = e + abd._energy(qq, q_tilde, sc, q, aim_strength, y0, al, None, None)
        return e + world._cross_energy(xx, qq, cand, cl, x, y0, ops)

    return cand, cl, energy


@pytest.fixture(scope="module")
def both():
    env_j, env_t, (x, v, q, qd, aim, z_k) = scene()
    rng = np.random.default_rng(8)
    p = rng.normal(0, 1e-4, z_k.shape).astype(np.float32)

    single = _SingleEnv(env_j)

    def one(x, v, q, qd, aim, z_k, p):
        cand, cl, energy = _jax_problem(single, x, v, q, qd, aim, z_k)
        e, g = jax.value_and_grad(energy)(z_k)
        hp = jax.jvp(jax.grad(energy), (z_k,), (p,))[1]
        return cand, cl, e, g, hp

    out_j = jax.jit(jax.vmap(one))(*(J(a) for a in (x, v, q, qd, aim, z_k, p)))
    world = env_t.world
    zeros = torch.zeros((N, 1, 12))
    prob = world._problem(T(x), T(v), T(q), T(qd), env_t.scene, T(aim), T(q), zeros)
    lags = prob.lags_at(T(z_k))
    e_t, g_t, hvp = tipc.derivatives(lambda z: prob.energy(z, lags), T(z_k))
    out_t = (lags, e_t, g_t, hvp(T(p)).detach(), prob)
    return env_j, env_t, out_j, out_t


class _SingleEnv:
    """The JAX env's models with its scene cut to one env (vmap maps the rest)."""

    def __init__(self, env_j):
        self.gel, self.cube, self.world = env_j.gel, env_j.cube, env_j.world
        self.scene = jax.tree_util.tree_map(lambda a: a[0], env_j.scene)


def test_cross_candidates_match(both):
    env_j, env_t, out_j, _ = both
    _, _, (x, v, q, qd, aim, z_k) = scene()
    world = env_t.world
    xs0 = T(x).index_select(1, world.fem.surface_verts)
    y0 = world.abd.world_points(T(q))
    candA, validA = world._cross_candidates(xs0, y0)
    candB, validB = world._cross_candidates_b(T(x), y0)
    cj = [np.asarray(a) for a in out_j[0]]
    np.testing.assert_array_equal(candA.numpy(), cj[0])
    np.testing.assert_array_equal(validA.numpy(), cj[1])
    # family B's ids index the gel's surface triangles, which the JAX
    # package's native mesher lists in another order: compare the triangles
    # themselves (vertex-id triples), each vertex's candidates as a set
    tris_t = _triangle_sets(world.fem.surface_tris[candB].numpy(), validB.numpy())
    tris_j = _triangle_sets(np.asarray(env_j.gel.surface_tris)[cj[2]], cj[3])
    assert tris_t == tris_j
    assert cj[1].any() and cj[3].any() and not cj[1].all()


def _triangle_sets(tri_ids, valid):
    """Per (env, vertex): the sorted set of (sorted vertex triple, valid) of its candidates."""
    n, v, k, _ = tri_ids.shape
    return [[sorted((tuple(sorted(tri_ids[i, j, m])), bool(valid[i, j, m])) for m in range(k)) for j in range(v)]
            for i in range(n)]


def test_cross_distances_match(both):
    env_j, env_t, out_j, _ = both
    _, _, (x, v, q, qd, aim, z_k) = scene()
    world_t = env_t.world
    xs = T(x).index_select(1, world_t.fem.surface_verts)
    y = world_t.abd.world_points(T(q))
    cA, _ = world_t._cross_candidates(xs, y)
    cB, _ = world_t._cross_candidates_b(T(x), y)
    dA, dB = world_t._cross_distances(xs, y, tcoupled._gather(y, world_t.abd.tris[cA]),
                                      tcoupled._gather(T(x), world_t.fem.surface_tris[cB]))
    cand = out_j[0]
    dj = jax.jit(jax.vmap(lambda x, q, a, b: env_j.world._cross_distances(x, q, a, b)))(J(x), J(q), cand[0], cand[2])
    np.testing.assert_allclose(dA.numpy(), np.asarray(dj[0]), atol=1e-7, rtol=0)
    # family B's candidates in triangle order (see test_cross_candidates_match)
    np.testing.assert_allclose(np.sort(dB.numpy(), -1), np.sort(np.asarray(dj[1]), -1), atol=1e-7, rtol=0)
    assert float(dA.min()) < 1e-3, "no family-A pair within the barrier's reach"


def test_cross_lags_match(both):
    _, _, out_j, out_t = both
    env_j, env_t, out_j, out_t = both
    (lamA, nA, pA_local, pA0, _), (lamB, nB, wB, _) = out_j[1]
    (tA, tB) = out_t[0][2]
    np.testing.assert_allclose(tA[0].numpy(), np.asarray(lamA), rtol=0, atol=1e-4 * float(np.abs(lamA).max()))
    assert float(np.abs(lamA).max()) > 0.0
    for a, b in ((tA[1], nA), (tA[2], pA_local), (tA[3], pA0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    # family B, matched by triangle (see test_cross_candidates_match); the
    # weights by vertex id
    cand_t = env_t.world.fem.surface_tris[_port_candidates_b(env_t)].numpy()
    cand_j = np.asarray(env_j.gel.surface_tris)[np.asarray(out_j[0][2])]
    by_t = _by_triangle(cand_t, tB[0].numpy(), tB[1].numpy(), tB[2].numpy())
    by_j = _by_triangle(cand_j, np.asarray(lamB), np.asarray(nB), np.asarray(wB))
    assert by_t.keys() == by_j.keys()
    lam_max = max(float(np.abs(lamB).max()), 1.0)
    for key, (lt, nt, wt) in by_t.items():
        lj, nj, wj = by_j[key]
        assert abs(lt - lj) <= 1e-4 * lam_max, key
        np.testing.assert_allclose(nt, nj, atol=1e-5, err_msg=str(key))
        np.testing.assert_allclose(wt, wj, atol=1e-5, err_msg=str(key))


def _port_candidates_b(env_t):
    _, _, (x, v, q, qd, aim, z_k) = scene()
    world = env_t.world
    return world._cross_candidates_b(T(x), world.abd.world_points(T(q)))[0]


def _by_triangle(tri_ids, lam, nrm, w):
    """{(env, vertex, sorted triple): (lambda, normal, weights in vertex-id order)}."""
    out = {}
    for idx in np.ndindex(tri_ids.shape[:3]):
        order = np.argsort(tri_ids[idx])
        out[idx[:2] + (tuple(tri_ids[idx][order]),)] = (lam[idx], nrm[idx], w[idx][order])
    return out


def test_joint_energy_gradient_and_hvp_match(both):
    _, _, out_j, out_t = both
    _, _, e_j, g_j, hp_j = out_j
    _, e_t, g_t, hp_t, _ = out_t
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-6)
    for a, b in ((g_t, g_j), (hp_t, hp_j)):
        a, b = a.numpy(), np.asarray(b)
        for i in range(N):
            assert np.linalg.norm(a[i] - b[i]) <= 1e-4 * np.linalg.norm(b[i]), (np.linalg.norm(a[i] - b[i]),
                                                                              np.linalg.norm(b[i]))


def test_block_preconditioner_matches(both):
    """The ABD rows' 12x12 block inverse (mass / dt^2 + the orthogonality
    Hessian + 1e-6 I) applied to a residual, against the JAX formula."""
    env_j, _, _, out_t = both
    _, _, (x, v, q, qd, aim, z_k) = scene()
    prob = out_t[4]
    r = np.random.default_rng(9).normal(0, 1.0, z_k.shape).astype(np.float32)
    pr = prob.precond(T(r)).numpy()
    abd, c = env_j.cube, env_j.gel.cfg

    def ortho_b(a_flat, kap):
        A = a_flat.reshape(3, 3)
        R = A.T @ A - jnp.eye(3)
        return kap * jnp.sum(R * R)

    V = x.shape[1]
    for i in range(N):
        Hd = abd.mass / c.dt**2
        Hd = Hd.at[:, 3:, 3:].add(jax.vmap(jax.hessian(ortho_b))(J(q[i, :, 3:]), abd.kappa_ortho)) + 1e-6 * jnp.eye(12)
        # the 12x12 block's inverse in float64; the port inverts in f32, whose
        # error is bounded by cond(Hd) x eps (cond ~2e5: the translation rows
        # weigh m / dt^2, the affine rows the orthogonality stiffness)
        H64 = np.asarray(Hd[0], np.float64)
        pq = np.linalg.solve(H64, r[i, 3 * V :].astype(np.float64))
        tol = np.linalg.cond(H64) * np.finfo(np.float32).eps * np.abs(pq).max()
        np.testing.assert_allclose(pr[i, 3 * V :], pq, rtol=0, atol=tol)
        px = r[i, : 3 * V].reshape(V, 3) * c.dt**2 / np.asarray(env_j.gel.masses)[:, None]
        np.testing.assert_allclose(pr[i, : 3 * V], px.reshape(-1), rtol=1e-6)


def test_missed_barriers_reads_nonzero_as_jax():
    """A pad 0.25 mm from the cube's face: each inner-face vertex over the
    face lies within d_hat / 2 of both of its triangles, so one candidate a
    vertex (coupling_k = 1) drops pairs and the counter reads nonzero; the
    registered 4 drop fewer (only the vertices at the cube's edges and
    corners, within reach of up to 6 triangles, still count)."""
    env_j, env_t, (x, v, q, qd, aim, z_k) = scene(press=7.5e-4)
    counts = {}
    for k in (1, 4):
        mj = jcoupled.CoupledModel(env_j.gel, env_j.cube, cross_k=k)
        mt = tcoupled.CoupledModel(env_t.gel, env_t.cube, cross_k=k)
        m_j = np.asarray(jax.jit(jax.vmap(mj.missed_barriers))(J(x), J(q)))
        m_t = mt.missed_barriers(T(x), T(q)).numpy()
        np.testing.assert_array_equal(m_t, m_j)
        counts[k] = m_j
    assert (counts[1] > counts[4]).all() and (counts[4] >= 0).all(), counts
