"""The port's standalone ABD contact terms against the JAX package, on
``_torch_abd``'s stack and pile (and batched thread colliders):

  * the body-body vertex-triangle and edge-edge candidates of the step's
    start, as sets of (vertex tuple, validity) per row (a tie goes to the
    lower index on both sides, but the sets do not depend on it);
  * ``broad_phase_overflow`` (``vt_body``, ``ee``) at tight capacities;
  * the lagged friction quantities at a Newton iterate (``_friction_lag``)
    against the same formulas from the JAX package's primitives;
  * the energy with scene and pair friction and both body-body families,
    its gradient and every env's dense (12B, 12B) Hessian against
    ``jax.grad`` and ``jax.hessian`` on the same inputs;
  * ``analytic_hessian``: the J^T G J assembly against the autograd
    Hessian and the JAX package's ``_assemble_hessian``;
  * ``scene_sdf`` with (N, T, 12) threads against the JAX package's under
    ``jax.vmap``, values and gradients.

Tolerances: distances and anchors 1e-6 m, normals 1e-5, force magnitudes
1e-4 relative; the energy 2e-5 relative and the gradient and the Hessians
2e-5 of their largest entry (f32 sums of terms up to ~1e6 in another
order; the two packages' own autodiff Hessians differ by ~3e-6 of it); SDF
values 1e-6 m and gradients 1e-5, as ``test_torch_sdf_raster.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_abd as A
from _torch_bins import setup_torch
from _torch_contact import pair_sets
from tacex_tpu.ops import sdf as jsdf
from tacex_tpu.physics.soft.ipc import barrier_force_mag as j_force_mag
from tacex_tpu_torch.ops import sdf as tsdf
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import ipc as tipc
from test_torch_sdf_raster import GRAD_ATOL, VALUE_ATOL, _off_crest, _prims

setup_torch()

REL = 2e-5


def _close(a, b, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * np.abs(b).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _iterate(**kw):
    """Everything a Newton iteration's energy takes, from the port at a
    seeded iterate q_k = q + 1e-4 noise: (q, q_k, q_tilde, x0, cand,
    ee_cand, lags) as torch tensors."""
    model_j, model_t, _ = A.models(**kw)
    q, qd = A.state()
    q_t = torch.from_numpy(q)
    q_k = q_t + torch.from_numpy(np.random.default_rng(1).normal(0, 1e-4, q.shape).astype(np.float32))
    x0 = model_t.world_points(q_t)
    cand = model_t._select_candidates(x0)
    ee_cand = model_t._select_ee_candidates(x0) if model_t._ee_on else None
    A0, t0 = tabd.q_to_affine(q_t)
    lags = model_t._friction_lag(q_k, A.port_scene(), cand, A0, t0)
    q_tilde = q_t + 0.01 * torch.from_numpy(qd) + 1e-4 * model_t._q_gravity
    return q_t, q_k, q_tilde, x0, cand, ee_cand, lags


def _env(tree, e):
    """Env e's slice of a tree of torch tensors, as JAX arrays."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_env(t, e) for t in tree)
    return jnp.asarray(tree[e].numpy())


def _port_energy(model_t, q_tilde, q_t, x0, cand, ee_cand, lags):
    aim = torch.zeros_like(q_t)
    return lambda qf: model_t._energy(qf.unflatten(1, (A.B, 12)), q_tilde, A.port_scene(), q_t, aim, x0, lags[0],
                                      cand, lags[1], ee_cand)


@functools.lru_cache(maxsize=None)
def _jax_derivatives(**kw):
    """One jit of (E, grad, Hessian) of the JAX energy at one env's inputs."""
    model_j = A.models(**kw)[0]

    def derivs(qf, q_tilde, scene, aim_q, x0, fb, cand, pf, ee_cand):
        def fn(z):
            return model_j._energy(z.reshape(A.B, 12), q_tilde, scene, aim_q, jnp.zeros((A.B, 12)), x0, fb, cand, pf,
                                   ee_cand)

        return fn(qf), jax.grad(fn)(qf), jax.hessian(fn)(qf)

    return jax.jit(derivs)


def test_candidates_match_as_sets():
    model_j, model_t, _ = A.models()
    q, _ = A.state()
    x0 = model_t.world_points(torch.from_numpy(q))
    for family, select, elems in (("vt", "_select_candidates", model_t.tris),
                                  ("ee", "_select_ee_candidates", model_t.edges)):
        cand, valid = getattr(model_t, select)(x0)
        got = pair_sets(elems.numpy(), cand.numpy(), valid.numpy())
        for e in range(A.N):
            cj, vj = getattr(model_j, select)(jnp.asarray(x0[e].numpy()))
            want = pair_sets(elems.numpy(), np.asarray(cj)[None], np.asarray(vj)[None])[0]
            assert got[e] == want, (family, e)
        assert valid.any(), family


def test_broad_phase_overflow_matches_jax():
    model_j, model_t, _ = A.models(contact_k=2, ee_contact_k=1)
    q, _ = A.state()
    x0 = model_t.world_points(torch.from_numpy(q))
    counts = model_t.broad_phase_overflow(x0)
    assert sorted(counts) == ["ee", "vt_body"]
    for e in range(A.N):
        want = model_j.broad_phase_overflow(jnp.asarray(x0[e].numpy()))
        assert {k: int(v[e]) for k, v in counts.items()} == {k: int(v) for k, v in want.items()}
    assert counts["vt_body"].sum() > 0 and counts["ee"].sum() > 0
    P, T = A.cube()
    single = tabd.AbdModel([P], [T], device="cpu", cfg=tabd.AbdSolverCfg(contact_k=0))
    assert single.broad_phase_overflow(x0[:, :8]) == {}


def test_friction_lags_match_jax_primitives():
    model_j, model_t, _ = A.models()
    q_t, q_k, _, x0, (ci, valid), _, ((lam_n, n_dir), (lam_p, n_p, q_p0, p_local, tb, valid_p)) = _iterate()
    assert torch.equal(valid_p, valid) and torch.equal(tb, model_t.tri_body[ci])
    x_k = model_t.world_points(q_k)

    @jax.jit
    def jax_lag(xk, ci, scene):
        d = scene.sdf(xk)
        n = jax.vmap(jax.grad(lambda p: scene.sdf(p[None])[0]))(xk)
        return d, n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9), *model_j._pair_closest(xk, ci)

    for e in range(A.N):
        xk = jnp.asarray(x_k[e].numpy())
        d, n, d_p, qp = jax_lag(xk, jnp.asarray(ci[e].numpy()), A.jax_scene(e))
        np.testing.assert_allclose(lam_n[e].numpy(), np.asarray(j_force_mag(d, 1e4, 0.002)), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(n_dir[e].numpy(), np.asarray(n), atol=1e-5)
        vj = jnp.asarray(valid[e].numpy())
        np.testing.assert_allclose(lam_p[e].numpy(), np.asarray(jnp.where(vj, j_force_mag(d_p, 1e4, 0.002), 0.0)),
                                   rtol=1e-4, atol=1e-6 * float(lam_p.max()))
        n_j = (xk[:, None, :] - qp) / jnp.maximum(d_p, 1e-9)[..., None]
        np.testing.assert_allclose(n_p[e].numpy(), np.asarray(n_j), atol=1e-5)
        A_k, t_k = (np.asarray(a) for a in tabd.q_to_affine(q_k[e]))
        A0, t0 = (np.asarray(a) for a in tabd.q_to_affine(q_t[e]))
        tbe = tb[e].numpy()
        pl = np.einsum("vkij,vkj->vki", np.asarray(jnp.linalg.inv(jnp.asarray(A_k)))[tbe], np.asarray(qp) - t_k[tbe])
        np.testing.assert_allclose(p_local[e].numpy(), pl, atol=1e-6)
        np.testing.assert_allclose(q_p0[e].numpy(), np.einsum("vkij,vkj->vki", A0[tbe], pl) + t0[tbe], atol=1e-6)


def test_energy_gradient_and_dense_hessian_match_jax():
    model_j, model_t, _ = A.models()
    q_t, q_k, q_tilde, x0, cand, ee_cand, lags = _iterate()
    assert lags[1] is not None and ee_cand is not None
    energy = _port_energy(model_t, q_tilde, q_t, x0, cand, ee_cand, lags)
    e_t, g_t, H_t = model_t._dense_hessian(energy, q_k.flatten(1))
    assert H_t.shape == (A.N, 12 * A.B, 12 * A.B)
    for e in range(A.N):
        e_j, g_j, H_j = _jax_derivatives()(jnp.asarray(q_k[e].flatten().numpy()), _env(q_tilde, e), A.jax_scene(e),
                                           _env(q_t, e), _env(x0, e), _env(lags[0], e), _env(cand, e),
                                           _env(lags[1], e), _env(ee_cand, e))
        np.testing.assert_allclose(e_t[e].item(), float(e_j), rtol=REL)
        _close(g_t[e].numpy(), g_j)
        _close(H_t[e].numpy(), H_j)


def test_analytic_hessian_matches_autodiff():
    """The J^T G J assembly (scene barrier and friction, vertex-triangle
    pairs, pair friction; edge-edge pairs off, as it predates them) against
    the port's autograd Hessian and the JAX package's assembly."""
    model_j, model_t, _ = A.models(ee_contact_k=0)
    q_t, q_k, q_tilde, x0, cand, ee_cand, lags = _iterate(ee_contact_k=0)
    assert ee_cand is None
    _, _, H_auto = model_t._dense_hessian(_port_energy(model_t, q_tilde, q_t, x0, cand, None, lags), q_k.flatten(1))
    H = model_t._assemble_hessian(q_k, A.port_scene(), torch.zeros_like(q_t), x0, lags[0], cand, lags[1])
    _close(H.numpy(), H_auto.numpy())
    assemble = jax.jit(model_j._assemble_hessian)
    for e in range(A.N):
        H_j = assemble(jnp.asarray(q_k[e].numpy()), _env(q_tilde, e), A.jax_scene(e), jnp.zeros((A.B, 12)),
                       _env(x0, e), _env(lags[0], e), _env(cand, e), _env(lags[1], e))
        _close(H[e].numpy(), H_j)


def test_batched_threads_match_jax_vmap():
    """Three envs, each with its own two threads (one env's second thread
    disabled), (N, P, 3) points against (N, T, 12) threads beside the other
    primitives, through ``scene_sdf`` and ``RigidSdfScene.sdf``."""
    rng = np.random.default_rng(2)
    n, p = 3, 48
    prims = _prims(rng)
    keys = ("spheres", "boxes", "capsules", "planes")
    batched = {k: np.stack([prims[k]] * n) for k in keys}
    threads = np.stack([prims["threads"]] * n)
    threads[:, :, 0:3] += rng.uniform(-0.002, 0.002, (n, 2, 3)).astype(np.float32)
    threads[:, :, 8] *= rng.uniform(0.8, 1.2, (n, 2)).astype(np.float32)
    threads[2, 1, 11] = 0.0
    pts = np.stack([_off_crest(rng.uniform(-0.02, 0.025, (4 * p, 3)).astype(np.float32), threads[e])[:p]
                    for e in range(n)])
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    args_j = [jnp.asarray(batched[k]) for k in keys] + [jnp.asarray(threads)]
    vj = jax.jit(jax.vmap(jsdf.scene_sdf))(jnp.asarray(pts), *args_j)
    scene = tipc.RigidSdfScene(*(T(batched[k]) for k in keys), threads=T(threads))
    vt = tsdf.scene_sdf(T(pts), *(T(batched[k]) for k in keys), T(threads))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=VALUE_ATOL)
    np.testing.assert_array_equal(scene.sdf(T(pts)).numpy(), vt.numpy())
    per_thread = np.asarray(jax.jit(jax.vmap(jsdf.sdf_threads))(jnp.asarray(pts), jnp.asarray(threads)))
    np.testing.assert_allclose(tsdf.sdf_threads(T(pts), T(threads)).numpy(), per_thread, atol=VALUE_ATOL)
    assert (per_thread[2, :, 1] >= jsdf.BIG).all() and (per_thread[:, :, 0] < 1.0).all()
    w = rng.uniform(0.5, 1.5, (n, p)).astype(np.float32)
    gj = jax.jit(jax.grad(lambda x, *a: (jax.vmap(jsdf.scene_sdf)(x, *a) * w).sum()))(jnp.asarray(pts), *args_j)
    gt = torch.func.grad(lambda x: (scene.sdf(x) * T(w)).sum())(T(pts))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=GRAD_ATOL)
    empty = tipc.RigidSdfScene.empty(n, t=2, device="cpu")
    assert empty.threads.shape == (n, 2, 12) and tipc.RigidSdfScene.empty(n, device="cpu").threads is None
    assert (empty.sdf(T(pts)) >= jsdf.BIG).all()


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_step_raises_for_inputs_that_require_grad(solver):
    _, model_t, _ = A.models(linear_solver=solver)
    q, qd = A.state()
    with pytest.raises(RuntimeError, match="no gradient"):
        model_t.step(tabd.AbdState(torch.from_numpy(q).requires_grad_(True), torch.from_numpy(qd)), A.port_scene())
