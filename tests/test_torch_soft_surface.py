"""The port's FEM-surface modules against the JAX package: the embedded
dense face grid, the FEM marker flow, and the textured-filming rasterizer
and texture fetch. Host-side bindings (numpy copies) are equal; the per-step
tensor paths agree to 1e-5 (pixels) or 1e-6 (metres, texels)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu.physics.soft.embed import EmbeddedFaceGrid as JGrid
from tacex_tpu.render import mesh_raster as jraster
from tacex_tpu.sensors.gelsight.fem import marker_flow as jflow
from tacex_tpu_torch.physics.soft.embed import EmbeddedFaceGrid as TGrid
from tacex_tpu_torch.render import mesh_raster as traster
from tacex_tpu_torch.sensors.gelsight.fem import marker_flow as tflow

setup_torch()

RES = (8, 10, 2)
H = 0.0045


def _gel():
    """The UIPC envs' "low" gel in the tool frame and its contact-face grid."""
    mesh = jmesh.box_tet_mesh((0.020750, 0.025250, H), RES, center=(0.0, 0.0, -H / 2), use_native=False)
    p = mesh.points
    ids = np.where(np.abs(p[:, 2]) < 1e-9)[0]
    order = np.lexsort((p[ids, 0], p[ids, 1]))
    grid = ids[order].reshape(RES[1] + 1, RES[0] + 1)
    st = np.asarray(mesh.surface_tris)
    on_face = np.abs(p[:, 2]) < 1e-9
    return mesh, grid, st[on_face[st].all(axis=1)]


def _deformed(mesh, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (mesh.points[None] + rng.normal(scale=2e-4, size=(n,) + mesh.points.shape)).astype(np.float32)


@pytest.mark.parametrize("with_face_tris", [True, False], ids=["triangle-weights", "bilinear"])
def test_embedded_face_grid_matches_jax(with_face_tris):
    mesh, grid, face_tris = _gel()
    kw = dict(face_tris=face_tris) if with_face_tris else {}
    gj = JGrid(grid, mesh.points, (51, 41), **kw)
    gt = TGrid(grid, mesh.points, (51, 41), device="cpu", **kw)
    assert gt.shape == gj.shape == (51, 41)
    np.testing.assert_array_equal(gt.rest_points, gj.rest_points)
    np.testing.assert_array_equal(gt.triangles, gj.triangles)
    np.testing.assert_array_equal(gt.weights.numpy(), np.asarray(gj.weights))
    x = _deformed(mesh)
    np.testing.assert_allclose(gt.positions(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(gj.positions)(jnp.asarray(x))),
                               atol=1e-7)


def _flows(cfg_kw):
    mesh, _, _ = _gel()
    remap = -np.ones(mesh.num_vertices, np.int64)
    remap[mesh.surface_verts] = np.arange(len(mesh.surface_verts))
    tris = remap[mesh.surface_tris].astype(np.int32)
    rest = mesh.points[mesh.surface_verts].copy()
    rest[:, 2] += 0.0285
    fj = jflow.FemMarkerFlow(jflow.ManiSkillSimulatorCfg().replace(**cfg_kw), rest.astype(np.float32), tris, seed=0)
    ft = tflow.FemMarkerFlow(tflow.ManiSkillSimulatorCfg().replace(**cfg_kw), rest.astype(np.float32), tris, seed=0,
                             device="cpu")
    surf = _deformed(mesh)[:, mesh.surface_verts]
    surf[..., 2] += 0.0285
    return fj, ft, surf


@pytest.mark.parametrize(
    "cfg_kw",
    [{}, dict(marker_random_noise=0.5, marker_lose_tracking_probability=0.3, normalize=True, marker_flow_size=40)],
    ids=["default", "noise-dropout-normalize"],
)
def test_fem_marker_flow_matches_jax(cfg_kw):
    """The binding is equal; ``flow`` with JAX's draws injected (the keep
    test's uniforms, the pixel noise and the subsample scores of the three
    keys ``flow`` splits) gives JAX's flow."""
    fj, ft, surf = _flows(cfg_kw)
    assert ft.num_bound == fj.num_bound > 0
    np.testing.assert_array_equal(ft.tri_ids.numpy(), np.asarray(fj.tri_ids))
    np.testing.assert_array_equal(ft.weights.numpy(), np.asarray(fj.weights))
    np.testing.assert_allclose(ft.init_pts.numpy(), np.asarray(fj.init_pts), atol=1e-9)
    key = jax.random.PRNGKey(7)
    n, m = surf.shape[0], fj.num_bound
    k_drop, k_noise, k_sample = jax.random.split(key, 3)
    draws = {
        "keep": jax.random.uniform(k_drop, (n, m)),
        "noise": jax.random.normal(k_noise, (n, 2, m, 2)),
        "score": jax.random.uniform(k_sample, (n, m)),
    }
    out_j = np.asarray(jax.jit(fj.flow)(jnp.asarray(surf), key))
    out_t = ft.flow(torch.from_numpy(surf), draws={k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})
    assert out_t.shape == out_j.shape == (n, 2, ft.cfg.marker_flow_size, 2)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5 if not cfg_kw else 1e-6)
    # drawn from a generator: the same shape, finite
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(ft.flow(torch.from_numpy(surf), g)).all()


@pytest.mark.parametrize("chunk", [None, 64], ids=["one-chunk", "chunks-of-64"])
def test_raster_attributes_matches_jax(chunk):
    """Overlapping random triangles (some degenerate, some behind ``near``)
    with per-vertex UVs, against JAX's per-camera call; chunking changes
    nothing."""
    rng = np.random.default_rng(3)
    b, t = 2, 300
    verts = np.concatenate([rng.uniform(-1, 1, (b, t, 3, 2)), rng.uniform(-0.1, 2.0, (b, t, 3, 1))], -1).astype(np.float32)
    verts[:, :5, 2] = verts[:, :5, 1]  # degenerate: two equal corners
    attrs = rng.uniform(0, 1, (t, 3, 2)).astype(np.float32)
    px = np.linspace(-1, 1, 24, dtype=np.float32)
    pix = np.stack(np.meshgrid(px, px), -1).reshape(-1, 2)
    raster = jax.jit(jax.vmap(lambda tc: jraster.raster_attributes(tc, jnp.asarray(attrs), jnp.asarray(pix), near=1e-4)))
    d_j, a_j = (np.asarray(v) for v in raster(jnp.asarray(verts)))
    d_t, a_t = traster.raster_attributes(torch.from_numpy(verts), torch.from_numpy(attrs), torch.from_numpy(pix),
                                        near=1e-4, chunk=chunk)
    hit = d_j < jraster.BIG * 0.5
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_array_equal(d_t.numpy() < traster.BIG * 0.5, hit)
    np.testing.assert_allclose(d_t.numpy()[hit], d_j[hit], atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), a_j, atol=1e-4)
    assert (a_t.numpy()[~hit] == 0).all()


def test_sample_texture_bilinear_matches_jax():
    rng = np.random.default_rng(4)
    tex = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (2, 500, 2)).astype(np.float32)
    uv[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    out_j = np.asarray(jax.jit(jraster.sample_texture_bilinear)(jnp.asarray(tex), jnp.asarray(uv)))
    out_t = traster.sample_texture_bilinear(torch.from_numpy(tex), torch.from_numpy(uv))
    assert out_t.shape == (2, 500, 3)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-6)
