"""The UIPC scene API's union and coupled worlds on the port, against the
JAX package where the scene is cheap enough to compile there.

  * The two-gel squeeze of ``tests/test_fem_fem_contact.py:136-200`` through
    ``UipcSim`` (one union model with self contact at K = 4, two envs): the
    top gel's attachment is driven 0.3 mm lower each step, 5 steps at 3
    Newton x 8 CG iterations with the convergence stop off; positions held
    to JAX within ``_torch_uipc_api.ATOL`` (1.5e-5 m), and the squeeze
    transmits force and stays penetration-free. Two changes to that scene
    keep the comparison clear of float-noise decisions (ROADMAP Queue 3):
    the top gel sits 0.3 / 0.2 mm off in x / y (with the grids exactly
    aligned, each top vertex moves straight at a bottom vertex and the
    line search's crossing test sits on its eps bound, where the two
    solvers' f32 rounding decides; the packages then part by up to 6e-5 m
    a step), and both sides mesh the gels with the port's numpy mesher
    (the JAX package's ``use_native=False``), so that tied centroid
    distances at the rest grid pick the same candidates.
  * A vertex write through the union, the union beside an affine body (the
    coupled world, ``tests/test_uipc_api.py``'s mixed scene), and
    ``step_n(n)`` against n ``step``s within 1e-6 on a FEM-only scene with
    provider-less attachments and on the coupled scene of
    ``tests/test_uipc_api.py:450``, on the port alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_uipc_api import ATOL, J, T, is_jax, new_sim, numpy, single_env_steps
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import mesh as tmesh

setup_torch()

GAP = 0.0012
SIZE = (0.01, 0.01, 0.004)
RES = (3, 3, 2)
DROP = 3e-4
STEPS = 5
SHIFT = (3e-4, 2e-4)


def _two_gels(M, k=4):
    cfg = M.UipcSimCfg(num_envs=2, gravity=(0.0, 0.0, 0.0),
                       newton=M.UipcSimCfg.Newton(max_iter=3, velocity_tol=0.0),
                       linear_system=M.UipcSimCfg.LinearSystem(max_iter=24))
    cfg.contact.self_contact_k = k
    cfg.contact.d_hat = 0.0005
    cfg.contact.resistance = 1e3
    cfg.contact.friction = False
    sim = new_sim(M, cfg)
    kw = dict(use_native=False) if is_jax(M) else {}
    mm = jmesh if is_jax(M) else tmesh
    con = M.UipcObjectCfg(constitution=M.StableNeoHookeanCfg(youngs_modulus=0.145))
    bottom = M.UipcObject(con, sim, mesh=mm.box_tet_mesh(SIZE, RES, center=(0.0, 0.0, 0.0), **kw))
    top = M.UipcObject(con, sim, mesh=mm.box_tet_mesh(SIZE, RES, center=SHIFT + (SIZE[2] + GAP,), **kw))
    z_b, z_t = bottom.mesh.points[:, 2], top.mesh.points[:, 2]
    bot_anchor = np.where(z_b < z_b.min() + 1e-6)[0]
    top_anchor = np.where(z_t > z_t.max() - 1e-6)[0]
    drop = {"d": 0.0}
    if is_jax(M):
        rest_b = jnp.asarray(bottom.mesh.points[bot_anchor])[None].repeat(2, 0)
        rest_t = jnp.asarray(top.mesh.points[top_anchor])[None].repeat(2, 0)
        top_aim = lambda: rest_t.at[:, :, 2].add(-drop["d"])  # noqa: E731
    else:
        rest_b = torch.as_tensor(bottom.mesh.points[bot_anchor])[None].repeat(2, 1, 1)
        rest_t = torch.as_tensor(top.mesh.points[top_anchor])[None].repeat(2, 1, 1)
        ez = torch.tensor([0.0, 0.0, 1.0])
        top_aim = lambda: rest_t - drop["d"] * ez  # noqa: E731
    bottom.set_attachments(bot_anchor, aim_provider=lambda: rest_b)
    top.set_attachments(top_anchor, aim_provider=top_aim)
    sim.setup_sim()
    if is_jax(M):
        single_env_steps(sim)
    return sim, bottom, top, drop


def test_two_gel_squeeze_through_sim_api_matches_jax():
    out = {}
    for M in (J, T):
        sim, bottom, top, drop = _two_gels(M)
        assert sim._union_model is not None
        for i in range(STEPS):
            drop["d"] = DROP * (i + 1)
            sim.step()
        out[M] = numpy(bottom.state.x), numpy(top.state.x)
    for a, b in zip(out[T], out[J]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    xb, xt = out[T]
    rest_b = bottom.mesh.points
    face = rest_b[:, 2] > rest_b[:, 2].max() - 1e-6
    assert (rest_b[:, 2] - xb[0, :, 2])[face].max() > 2e-4  # force transmitted
    assert xt[0, :, 2].min() - xb[0, face, 2].max() > -1e-4  # penetration-free
    np.testing.assert_allclose(xb[0], xb[1], atol=1e-6)  # identical envs solve alike
    counts = sim.check_health()
    assert sorted(counts) == ["vt_self"] and counts["vt_self"].shape == (2,)


def test_vertex_write_through_union():
    sim, bottom, top, drop = _two_gels(T)
    drop["d"] = 1e-3
    for _ in range(2):
        sim.step()
    assert np.abs(top.state.x[0].numpy() - top.mesh.points).max() > 1e-5
    nb = bottom.mesh.num_vertices
    before = sim._union_state.x[:, :nb].clone()
    top.write_vertex_positions_to_sim(top.mesh.points)
    np.testing.assert_allclose(top.state.x[0].numpy(), top.mesh.points, atol=0)
    np.testing.assert_allclose(sim._union_state.x[0, nb:].numpy(), top.mesh.points, atol=0)
    assert torch.equal(sim._union_state.x[:, :nb], before) and torch.equal(bottom.state.x, before)


def _cube_tris():
    return np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)


def _cube_pts(s, z):
    return np.array([[x, y, zz] for x in (-s, s) for y in (-s, s) for zz in (-s, s)], np.float64) + np.array([0, 0, z])


def test_union_beside_an_affine_body():
    """Two gels with self contact and a dynamic cube: one coupled world; the
    provider-less anchor holds its gel near its start and the cube falls."""
    sim = T.UipcSim(T.UipcSimCfg(num_envs=1, dt=1 / 120, enable_ground=True,
                                 newton=T.UipcSimCfg.Newton(max_iter=3),
                                 linear_system=T.UipcSimCfg.LinearSystem(max_iter=8),
                                 contact=T.UipcSimCfg.Contact(self_contact_k=4, d_hat=0.002)), device="cpu")

    def gel(c):
        return T.UipcObjectCfg(mesh_cfg=T.objects.TetMeshCfg(size=(0.02, 0.02, 0.02), resolution=(2, 2, 2), center=c),
                               constitution=T.StableNeoHookeanCfg())

    T.UipcObject(gel((0.0, 0.0, 0.03)), sim)
    g2 = T.UipcObject(gel((0.0, 0.0, 0.08)), sim)
    top = np.where(g2.mesh.points[:, 2] > 0.089)[0].astype(np.int32)
    g2.set_attachments(top, strength_ratio=200.0)
    cube = T.UipcObject(T.UipcObjectCfg(constitution=T.AffineBodyConstitutionCfg()), sim,
                        points=_cube_pts(0.005, 0.0) + np.array([0.1, 0.0, 0.05]), triangles=_cube_tris())
    sim.setup_sim()
    assert sim._union_model is not None and sim._coupled is not None
    for _ in range(3):
        sim.step()
    counts = sim.check_health()
    assert {"vt_cross_a", "vt_cross_b", "vt_self"} <= set(counts)
    assert float(g2.nodal_pos_w[0, top, 2].mean()) > 0.085
    assert float(cube.root_pos_w[0, 2]) < 0.05 and float(sim.abd_body_pose(cube)[0, 2]) < 0.0
    cube.write_vertex_positions_to_sim(cube.mesh.points + np.array([0.0, 0.0, 0.01], np.float32))
    np.testing.assert_allclose(sim.abd_body_pose(cube)[0, :3].numpy(), [0.0, 0.0, 0.01], atol=1e-6)
    sim.reset_abd_object(cube)
    np.testing.assert_allclose(sim.abd_body_pose(cube)[0].numpy(), [0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1], atol=0)


def _fem_scene():
    """A gel of (3, 3, 2) cells hung by its mount without a provider, and a
    second gel falling onto the ground, each with its own model."""
    sim = T.UipcSim(T.UipcSimCfg(dt=1 / 60, num_envs=2, enable_ground=True,
                                 newton=T.UipcSimCfg.Newton(max_iter=3),
                                 linear_system=T.UipcSimCfg.LinearSystem(max_iter=8)), device="cpu")
    hung = T.UipcObject(T.UipcObjectCfg(constitution=T.StableNeoHookeanCfg(youngs_modulus=0.1)), sim,
                        mesh=tmesh.box_tet_mesh((0.03, 0.03, 0.01), (3, 3, 2), center=(0, 0, 0.05)))
    hung.set_attachments(np.where(hung.mesh.points[:, 2] > 0.055 - 1e-9)[0].astype(np.int32))
    T.UipcObject(T.UipcObjectCfg(constitution=T.StableNeoHookeanCfg(youngs_modulus=0.1)), sim,
                 mesh=tmesh.box_tet_mesh((0.02, 0.02, 0.01), (2, 2, 1), center=(0.1, 0, 0.006)))
    sim.setup_sim()
    return sim


def _coupled_scene():
    """``tests/test_uipc_api.py:450``: a gel on the ground and a dynamic cube
    above it in one coupled world."""
    sim = T.UipcSim(T.UipcSimCfg(dt=1 / 100, num_envs=1, enable_ground=True,
                                 newton=T.UipcSimCfg.Newton(max_iter=3),
                                 linear_system=T.UipcSimCfg.LinearSystem(max_iter=8),
                                 contact=T.UipcSimCfg.Contact(coupling_k=4)), device="cpu")
    T.UipcObject(T.UipcObjectCfg(constitution=T.StableNeoHookeanCfg(youngs_modulus=0.1)), sim,
                 mesh=tmesh.box_tet_mesh((0.03, 0.03, 0.01), (3, 3, 2), center=(0, 0, 0.005)))
    T.UipcObject(T.UipcObjectCfg(constitution=T.AffineBodyConstitutionCfg(m_kappa=100.0)), sim,
                 points=_cube_pts(0.006, 0.02), triangles=_cube_tris())
    sim.setup_sim()
    assert sim._coupled is not None
    return sim


@pytest.mark.parametrize("scene, steps", [(_fem_scene, 4), (_coupled_scene, 3)], ids=["fem", "coupled"])
def test_step_n_matches_step(scene, steps):
    a, b = scene(), scene()
    for _ in range(steps):
        a.step()
    b.step_n(steps)
    for oa, ob in zip(a.objects, b.objects):
        np.testing.assert_allclose(oa.nodal_pos_w.numpy(), ob.nodal_pos_w.numpy(), atol=1e-6, rtol=0)
    if a._abd_model is not None:
        np.testing.assert_allclose(a._abd_state.q.numpy(), b._abd_state.q.numpy(), atol=1e-6, rtol=0)
    assert b._frame_counter == steps and "step_n" in b.get_sim_time_report(as_json=True)
    assert np.abs(a.objects[0].nodal_pos_w.numpy() - a.objects[0].init_vertex_pos).max() > 1e-5
