"""Shells (cloth) of the port against the JAX package: ``codim.py``'s element
bundle and energies, ``ShellModel.step`` and ``msh_io.load_msh``.

  * The element bundle is built by the same numpy code on both sides, so it
    is held equal array for array (dtypes too), alone, offset into a larger
    vertex array and merged with ``merge_shell_elements``.
  * The membrane and bending energies of a 6 x 6 cloth deformed by seeded
    1 cm noise at 3 envs, and their gradients (autograd against
    ``jax.grad``), with rtol 1e-5. The membrane gradient sums the
    contributions of up to six triangles a vertex, and either side's f32
    gradient lies ~1e-5 of its largest entry from a float64 evaluation
    (measured), so the gradients also get an atol of 5e-5 of that entry.
  * One ``ShellModel.step`` of ``tests/_torch_shell.py``'s 5 x 5 cloth at 2
    envs (ground, a sphere collider, a kinematic icosphere soup, pinned
    corners, friction) at 2 Newton x 6 CG x 4 line-search iterations with
    the convergence stop off, against one jit of the JAX
    ``_step_single`` called env by env, within 1e-5 m.
  * ``load_msh`` of an MSH 2.2 and an MSH 4.1 text of one two-tet mesh
    gives the same arrays on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_shell as S
from _torch_bins import setup_torch
from _torch_uipc_api import per_env_step
from tacex_tpu.physics.soft import codim as jcodim
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import msh_io as jmsh
from tacex_tpu.physics.soft.shell import grid_cloth
from tacex_tpu_torch.physics.soft import codim as tcodim
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import load_msh

setup_torch()

MSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
5 1 1 1
$EndNodes
$Elements
3
1 4 2 0 1 1 2 3 4
2 4 2 0 1 2 3 4 5
3 2 2 0 1 1 2 3
$EndElements
"""
# the same mesh in MSH 4.1: one node block, a triangle block (skipped) and a tet block
MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Nodes
1 5 1 5
3 1 0 5
1
2
3
4
5
0 0 0
1 0 0
0 1 0
0 0 1
1 1 1
$EndNodes
$Elements
2 3 1 3
2 1 2 1
3 1 2 3
3 1 4 2
1 1 2 3 4
2 2 3 4 5
$EndElements
"""


def assert_bundles_equal(a, b):
    for f in ("tris", "d_inv", "rest_area", "mu", "lam", "thickness", "masses", "hinges", "hinge_w", "theta0"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_shell_elements_equal_jax():
    P, T = grid_cloth(6, 6, size=0.2, z=0.1)
    kw = dict(youngs_modulus=2e4, poisson_ratio=0.35, thickness=0.002, mass_density=150.0, bending_stiffness=5.0)
    assert_bundles_equal(tcodim.build_shell_elements(P, T, **kw), jcodim.build_shell_elements(P, T, **kw))
    # two parts offset into one vertex array of 100, then merged
    P2, T2 = grid_cloth(4, 4, size=0.1, z=0.3)
    parts = {}
    for name, M in (("t", tcodim), ("j", jcodim)):
        a = M.build_shell_elements(P, T, num_vertices=100, vertex_offset=10, **kw)
        b = M.build_shell_elements(P2, T2, num_vertices=100, vertex_offset=60)
        parts[name] = M.merge_shell_elements([a, b], 100)
    assert_bundles_equal(parts["t"], parts["j"])
    assert parts["t"].num_tris == 50 + 18 and parts["t"].hinges.shape == (65 + 21, 4)
    assert parts["t"].masses[:10].sum() == 0 and (parts["t"].masses[10:46] > 0).all()


def test_energies_and_gradients_match_jax():
    P, T = grid_cloth(6, 6, size=0.2, z=0.1)
    e = jcodim.build_shell_elements(P, T)
    ej, et = jcodim.ShellElementsJax(e), tcodim.ShellElementsTorch(e, "cpu")
    x = (P[None] + np.random.default_rng(0).normal(0.0, 0.01, (3,) + P.shape)).astype(np.float32)
    for fj, ft in ((jcodim.membrane_energy, tcodim.membrane_energy),
                   (jcodim.bending_energy, tcodim.bending_energy)):
        vj, gj = (np.asarray(a) for a in jax.jit(jax.vmap(jax.value_and_grad(lambda xx: fj(xx, ej))))(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        vt = ft(xt, et)
        (gt,) = torch.autograd.grad(vt.sum(), xt)
        assert vt.shape == (3,) and (vj > 0).all()
        np.testing.assert_allclose(vt.detach().numpy(), vj, rtol=1e-5, err_msg=fj.__name__)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5, atol=5e-5 * np.abs(gj).max(), err_msg=fj.__name__)
    # an empty bundle: zeros of shape (N,), on the input's device
    empty = tcodim.ShellElementsTorch(jcodim.build_shell_elements(P, T[:0]), "cpu")
    for ft in (tcodim.membrane_energy, tcodim.bending_energy):
        out = ft(torch.from_numpy(x), empty)
        assert out.shape == (3,) and not out.any()


def test_shell_model_step_matches_jax():
    mj, mt = S.models()
    np.testing.assert_array_equal(mt.masses.numpy(), np.asarray(mj.masses))
    np.testing.assert_array_equal(mt.attachment_k[:, 0].numpy(), np.asarray(mj.attachment_k))
    sj, st = S.scenes(S.scene_arrays())
    x, v = S.start()
    aim = np.broadcast_to(S.cloth()[0][S.CORNERS], (S.N, len(S.CORNERS), 3)).astype(np.float32)
    out_j = per_env_step(mj)(jipc.SoftBodyState(x=jnp.asarray(x), v=jnp.asarray(v)), sj, jnp.asarray(aim))
    out_t = mt.step(tipc.SoftBodyState(x=torch.from_numpy(x), v=torch.from_numpy(v)), st, torch.from_numpy(aim))
    xj, vj = np.array(out_j.x), np.array(out_j.v)
    np.testing.assert_allclose(out_t.x.numpy(), xj, rtol=0, atol=S.ATOL)
    np.testing.assert_allclose(out_t.v.numpy(), vj, rtol=0, atol=S.ATOL / S.CFG["dt"])
    # the step moved the cloth, and each contact kind was within the barrier's reach
    assert np.abs(xj - x).max() > 10 * S.ATOL
    d_hat = S.CFG["d_hat"]
    assert (xj[1, :, 2] - 0.0195).min() < d_hat, "env 1's plane"
    assert (np.linalg.norm(xj[:, 22] - [0.04, 0.0, 0.0095], axis=-1) - 0.01).max() < d_hat, "the sphere"
    tri = torch.from_numpy(S.static_tris())
    d_soup = tipc._point_triangle_distance(torch.from_numpy(xj)[:, :, None], tri[:, 0], tri[:, 1], tri[:, 2])
    assert d_soup.amin((1, 2)).max() < d_hat, "the static soup"


def test_shell_model_step_raises_for_grad():
    _, mt = S.models()
    _, st = S.scenes(S.scene_arrays())
    x, v = S.start()
    with pytest.raises(RuntimeError, match="no gradient"):
        mt.step(tipc.SoftBodyState(x=torch.from_numpy(x).requires_grad_(True), v=torch.from_numpy(v)), st)
    with torch.no_grad():
        out = mt.step(tipc.SoftBodyState(x=torch.from_numpy(x).requires_grad_(True), v=torch.from_numpy(v)), st)
    assert torch.isfinite(out.x).all()


@pytest.mark.parametrize("text", [MSH22, MSH41], ids=["msh2.2", "msh4.1"])
def test_load_msh_matches_jax(tmp_path, text):
    f = tmp_path / "t.msh"
    f.write_text(text)
    mt, mj = load_msh(f), jmsh.load_msh(f)
    assert mt.num_vertices == 5 and len(mt.tets) == 2  # the triangle element is skipped
    for k in ("points", "tets", "surface_tris", "surface_verts"):
        a, b = getattr(mt, k), getattr(mj, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (mt.rest_volumes() > 0).all()
