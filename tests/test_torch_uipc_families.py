"""The soft model's contact families, port against the JAX package: FEM self
contact and edge-edge contact on the two-gel union of
``tests/test_fem_fem_contact.py`` pressed to 0.3 mm (``_torch_contact``),
static trimesh colliders on the drape of ``tests/test_soft_ipc.py`` (its
(6, 6, 2) gel lowered to 0.6 mm above the icosphere), and the broad-phase
counters on the stacked slabs of ``tests/test_broad_phase_overflow.py``.

Tolerances (f32): candidate sets exactly, as sets of vertex tuples (the
JAX mesh lists its surface triangles in another order); the energy rtol
1e-6 and its gradient within 1e-4 of its norm (the pair sums run in
another order); one ``SoftBodyModel.step`` ``_torch_contact.ATOL``
(1.5e-5 m) at ``velocity_tol = 0``; the overflow counts exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_contact import ATOL, N, as_torch, pair_sets, pressed, union_models
from tacex_tpu.assets.meshes import icosphere
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh

setup_torch()

UNION = {"self": dict(self_contact_k=4), "ee": dict(ee_contact_k=4), "self+ee": dict(self_contact_k=4, ee_contact_k=4)}
SPHERE = np.asarray(icosphere(0.03, 1), np.float32) + np.array([0, 0, 0.03], np.float32)
DRAPE_CFG = dict(dt=1 / 60, d_hat=0.002, newton_max_iter=4, cg_iters=16)


@functools.lru_cache(maxsize=None)
def drape_models():
    """(JAX model, port model) of a gel 0.6 mm above the icosphere's top."""
    args = ((0.06, 0.06, 0.01), (6, 6, 2))
    center = (0.0, 0.0, 0.06 + 0.0006 + 0.005)
    mj = jipc.SoftBodyModel(jmesh.box_tet_mesh(*args, center=center), youngs_modulus=3e4,
                            cfg=jipc.IpcSolverCfg(**DRAPE_CFG), static_tris=SPHERE)
    mt = tipc.SoftBodyModel(tmesh.box_tet_mesh(*args, center=center), youngs_modulus=3e4,
                            cfg=tipc.IpcSolverCfg(**DRAPE_CFG), static_tris=SPHERE, device="cpu")
    return mj, mt


def _inputs(model_t, family):
    """numpy (x0, x_k, x_tilde, aim): a pressed start x0, an iterate a seeded
    50 um step away and the inertia target."""
    rng = np.random.default_rng(9)
    if family == "static":
        pts = model_t.mesh.points
        x0 = (pts[None] + rng.normal(0, 2e-5, (N,) + pts.shape)).astype(np.float32)
        aim = np.zeros((N, 1, 3), np.float32)
    else:
        _, _, anchors, n_bot = union_models(**UNION[family])
        x0, aim = pressed(model_t, anchors, n_bot)
    x_k = (x0 + rng.normal(0, 5e-5, x0.shape)).astype(np.float32)
    x_tilde = (x0 + rng.normal(0, 1e-4, x0.shape)).astype(np.float32)
    return x0, x_k, x_tilde, aim


def _models(family):
    if family == "static":
        return drape_models()
    return union_models(**UNION[family])[:2]


@pytest.mark.parametrize("family", ["self", "ee", "self+ee", "static"])
def test_energy_and_gradient_match(family):
    model_j, model_t = _models(family)
    x0, x_k, x_tilde, aim = _inputs(model_t, family)
    sc_j, sc_t = jipc.RigidSdfScene.empty(N), tipc.RigidSdfScene.empty(N, device="cpu")
    c = model_j.cfg

    def one(xk, xt, a, x_start, scene):
        self_cand = model_j._select_candidates(x_start) if c.self_contact_k > 0 else None
        ee_cand = model_j._select_ee_candidates(x_start) if model_j.edges is not None else None
        st = model_j._static_candidates(x_start[model_j.surface_verts]) if model_j.static_tris is not None else None
        return model_j._energy(xk, xt, scene, a, x_start, None, self_cand, st, ee_cand)

    e_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(one)))(*map(jnp.asarray, (x_k, x_tilde, aim, x0)), sc_j)
    t_k, t_tilde, t_aim, t0 = as_torch(x_k, x_tilde, aim, x0)
    fam = model_t._families(t0)
    e_t, g_t, _ = tipc.derivatives(lambda x: model_t._energy(x, t_tilde, sc_t, t_aim, t0, None, c.dt, fam), t_k)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-6)
    g_j = np.asarray(g_j)
    for i in range(N):
        assert np.linalg.norm(g_t[i].numpy() - g_j[i]) <= 1e-4 * np.linalg.norm(g_j[i])
    # the family's barrier is active: its energy is nonzero at the iterate
    xs = t_k.index_select(1, model_t.surface_verts)
    assert float(model_t._family_energy(t_k, xs, fam).min()) > 0.0


def test_self_and_edge_candidates_match_as_sets():
    model_j, model_t, anchors, n_bot = union_models(**UNION["self+ee"])
    x0, _ = pressed(model_t, anchors, n_bot)
    cj, vj = jax.vmap(model_j._select_candidates)(jnp.asarray(x0))
    ct, vt = model_t._select_candidates(torch.from_numpy(x0))
    assert pair_sets(model_t.surface_tris.numpy(), ct.numpy(), vt.numpy()) == pair_sets(
        np.asarray(model_j.surface_tris), cj, vj)
    assert 0.0 < float(vt.float().mean()) and np.asarray(vj).any()
    # edges: both sides list the unique sorted surface edges in one order
    np.testing.assert_array_equal(model_t.edges.numpy(), np.asarray(model_j.edges))
    ej, evj = jax.vmap(model_j._select_ee_candidates)(jnp.asarray(x0))
    et, evt = model_t._select_ee_candidates(torch.from_numpy(x0))
    assert pair_sets(model_t.edges.numpy(), et.numpy(), evt.numpy()) == pair_sets(np.asarray(model_j.edges), ej, evj)
    assert evt.any() and not evt.all()


def test_static_candidates_match_as_sets():
    model_j, model_t = drape_models()
    x0, *_ = _inputs(model_t, "static")
    xs_j = jnp.asarray(x0)[:, np.asarray(model_j.surface_verts)]
    cj = np.asarray(jax.vmap(model_j._static_candidates)(xs_j))
    ct = model_t._static_candidates(torch.from_numpy(x0).index_select(1, model_t.surface_verts)).numpy()
    np.testing.assert_array_equal(np.sort(ct, -1), np.sort(cj, -1))


def test_step_matches_with_self_and_edge_contact():
    """One step of the pressed union with self_contact_k = ee_contact_k = 4:
    the top slab's targets drive it onto the bottom one."""
    model_j, model_t, anchors, n_bot = union_models(**UNION["self+ee"])
    x0, aim = pressed(model_t, anchors, n_bot)
    v = np.zeros_like(x0)
    s_j = jax.jit(model_j.step)(jipc.SoftBodyState(x=jnp.asarray(x0), v=jnp.asarray(v)), jipc.RigidSdfScene.empty(N),
                                jnp.asarray(aim))
    tx, tv, taim = as_torch(x0, v, aim)
    s_t = model_t.step(tipc.SoftBodyState(x=tx, v=tv), tipc.RigidSdfScene.empty(N, device="cpu"), taim)
    np.testing.assert_allclose(s_t.x.numpy(), np.asarray(s_j.x), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s_t.v.numpy(), np.asarray(s_j.v), atol=ATOL / model_t.cfg.dt, rtol=0)
    moved = np.abs(s_t.x.numpy() - x0).max()
    assert moved > 5e-5, moved
    # the step kept the slabs apart: every self pair of the new state is above the floor
    fam = model_t._families(s_t.x)
    xs = s_t.x.index_select(1, model_t.surface_verts)
    assert float(torch.where(fam.self_valid, model_t._pair_distances(s_t.x, xs, fam.self_idx), 1.0).min()) > 1e-6


def _stacked(module, k: int, ee_k: int):
    """A model of the two stacked (4, 4, 1) slabs 0.5 mm apart (d_hat 0.5 mm),
    with the top faces of a third slab 0.3 mm under the stack as its static
    colliders."""
    kw = {} if module is jipc else dict(device="cpu")
    mm = jmesh if module is jipc else tmesh
    parts = [mm.box_tet_mesh((0.02, 0.02, 0.004), (4, 4, 1), center=(0, 0, cz)) for cz in (0.002, 0.0065)]
    mesh, _ = mm.union_meshes(parts)
    floor = tmesh.box_tet_mesh((0.02, 0.02, 0.004), (4, 4, 1), center=(0, 0, -0.0023))
    tris = floor.points[floor.surface_tris]
    tris = tris[tris[:, :, 2].min(1) > -0.0004]  # its top face
    cfg = module.IpcSolverCfg(d_hat=5e-4, self_contact_k=k, ee_contact_k=ee_k, static_contact_k=k)
    return module.SoftBodyModel(mesh, cfg=cfg, static_tris=tris.astype(np.float32), **kw), mesh.points


@pytest.mark.parametrize("k, ee_k", [(1, 1), (24, 128)], ids=["saturated", "clean"])
def test_broad_phase_overflow_matches(k, ee_k):
    model_j, pts = _stacked(jipc, k, ee_k)
    model_t, _ = _stacked(tipc, k, ee_k)
    x = np.broadcast_to(pts, (N,) + pts.shape).astype(np.float32)
    x = x + np.random.default_rng(3).normal(0, 1e-5, x.shape).astype(np.float32)
    cj = jax.vmap(model_j.broad_phase_overflow)(jnp.asarray(x))
    ct = model_t.broad_phase_overflow(torch.from_numpy(x))
    assert sorted(ct) == sorted(cj) == ["ee", "vt_self", "vt_static"]
    for key in cj:
        np.testing.assert_array_equal(ct[key].numpy(), np.asarray(cj[key]))
    assert all((ct[key] > 0).all() for key in ct) if k == 1 else all(int(ct[key].sum()) == 0 for key in ct)
