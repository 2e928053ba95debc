"""The port's SDFs, their ``torch.func`` gradients and the mesh rasterizer
against the JAX package, on inputs made with numpy.

Tolerances: SDF values 1e-6 m and gradients 1e-5 (f32 sums and square roots
in another order, on distances of a few cm); raster depths 1e-6 m (an
affine plane evaluated at ~3 cm).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.assets import meshes
from tacex_tpu.ops import sdf as jsdf
from tacex_tpu.render import depth_camera as jd
from tacex_tpu.render import mesh_raster as jr
from tacex_tpu_torch.ops import sdf as tsdf
from tacex_tpu_torch.render import depth_camera as td
from tacex_tpu_torch.render import mesh_raster as tr

setup_torch()

VALUE_ATOL = 1e-6
GRAD_ATOL = 1e-5
DEPTH_ATOL = 1e-6
T = lambda a: torch.from_numpy(np.array(a, np.float32))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _prims(rng):
    """Two of each primitive, the second of each disabled."""
    spheres = np.array([[0.01, 0.0, 0.02, 0.008], [0.0, 0.0, 0.0, 0.0]], np.float32)
    boxes = np.zeros((2, 10), np.float32)
    boxes[0] = [-0.01, 0.005, 0.0, *_quats(rng, 1)[0], 0.006, 0.004, 0.009]
    capsules = np.array([[0.0, -0.01, -0.01, 0.005, 0.01, 0.012, 0.003, 1.0], [0] * 8], np.float32)
    planes = np.array([[0.0, 0.0, 1.0, -0.02], [0.0, 0.0, 0.0, 0.0]], np.float32)
    threads = np.array(
        [[0.0, 0.0, -0.01, 0.1, 0.05, 1.0, 0.004, 0.0012, 0.003, -0.005, 0.012, 1.0],
         [0.0, 0.01, 0.0, 1.0, 0.0, 0.0, 0.006, 0.001, 0.002, -0.01, 0.01, -1.0]],
        np.float32,
    )
    gears = np.array([[0.0, 0.0, 0.009, 0.012, 12.0, -0.005, 0.01, 0.0218]], np.float32)
    return dict(spheres=spheres, boxes=boxes, capsules=capsules, planes=planes, threads=threads, gears=gears)


FNS = {
    "spheres": (jsdf.sdf_spheres, tsdf.sdf_spheres),
    "boxes": (jsdf.sdf_boxes, tsdf.sdf_boxes),
    "capsules": (jsdf.sdf_capsules, tsdf.sdf_capsules),
    "planes": (jsdf.sdf_planes, tsdf.sdf_planes),
    "threads": (jsdf.sdf_threads, tsdf.sdf_threads),
    "gears": (jsdf.sdf_gear, tsdf.sdf_gear),
}


def _points(rng, n=96):
    return rng.uniform(-0.02, 0.025, (n, 3)).astype(np.float32)


def _off_crest(pts, threads):
    """The points whose helicoidal coordinate u / pitch lies at least 1e-3
    from an integer for every thread: there ``floor`` is not about to jump."""
    keep = np.ones(len(pts), bool)
    for th in threads:
        axis = th[3:6] / np.linalg.norm(th[3:6])
        seed = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0, 1.0, 0])
        b1 = np.cross(axis, seed)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(axis, b1)
        rel = pts - th[:3]
        u = rel @ axis - th[8] * np.arctan2(rel @ b2, rel @ b1) / (2 * np.pi)
        f = u / th[8] - np.floor(u / th[8])
        keep &= np.minimum(f, 1 - f) > 1e-3
    return pts[keep]


@pytest.mark.parametrize("name", sorted(FNS))
def test_sdf_and_gradient_match_jax(name):
    rng = np.random.default_rng(0)
    prims = _prims(rng)[name]
    pts = _points(rng)
    if name == "threads":
        pts = _off_crest(pts, prims)
        assert len(pts) > 60
    fj, ft = FNS[name]
    fj = jax.jit(fj)
    np.testing.assert_allclose(ft(T(pts), T(prims)).numpy(), np.asarray(fj(jnp.asarray(pts), jnp.asarray(prims))),
                               atol=VALUE_ATOL)
    # the gradient of a weighted sum reaches every (point, primitive) entry;
    # disabled primitives (BIG, constant) get weight 0
    w = rng.uniform(0.5, 1.5, (len(pts), len(prims))).astype(np.float32)
    w[:, np.asarray(fj(jnp.asarray(pts), jnp.asarray(prims)))[0] >= jsdf.BIG] = 0.0
    gj = jax.jit(jax.grad(lambda p: (fj(p, jnp.asarray(prims)) * w).sum()))(jnp.asarray(pts))
    gt = torch.func.grad(lambda p: (ft(p, T(prims)) * T(w)).sum())(T(pts))
    assert np.isfinite(gt.numpy()).all()
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=GRAD_ATOL)


def test_thread_sdf_on_a_crest():
    """A point whose u / pitch is an integer (on the helix's seam, where
    ``floor`` jumps): the same f32 value and gradient as JAX."""
    th = np.array([[0, 0, 0, 0, 0, 1, 0.004, 0.0012, 0.003, -0.01, 0.02, 1.0]], np.float32)
    pts = np.array([[0.0045, 0.0, 0.006], [0.0035, 0.0, 0.003], [0.0045, 0.0, 0.0]], np.float32)
    u = pts[:, 2] / th[0, 8]
    assert np.all(u == np.round(u))
    vj = np.asarray(jax.jit(jsdf.sdf_threads)(jnp.asarray(pts), jnp.asarray(th)))
    np.testing.assert_allclose(tsdf.sdf_threads(T(pts), T(th)).numpy(), vj, atol=VALUE_ATOL)
    gj = jax.jit(jax.grad(lambda p: jsdf.sdf_threads(p, jnp.asarray(th)).sum()))(jnp.asarray(pts))
    gt = torch.func.grad(lambda p: tsdf.sdf_threads(p, T(th)).sum())(T(pts))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=GRAD_ATOL)


def test_scene_sdf_and_zero_gradient_safety():
    rng = np.random.default_rng(1)
    pr = _prims(rng)
    keys = ("spheres", "boxes", "capsules", "planes", "threads")
    pts = _off_crest(_points(rng), pr["threads"])
    vj = jax.jit(jsdf.scene_sdf)(jnp.asarray(pts), *(jnp.asarray(pr[k]) for k in keys))
    vt = tsdf.scene_sdf(T(pts), *(T(pr[k]) for k in keys))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=VALUE_ATOL)
    # _safe_norm's eps: a point on a sphere's centre has a finite gradient
    g = torch.func.grad(lambda p: tsdf.sdf_spheres(p, T(pr["spheres"]))[:, 0].sum())(T(pr["spheres"][:1, :3]))
    assert torch.isfinite(g).all()


def _cam_tris(rng, t):
    """``t`` camera-frame triangles in front of a 1 cm window, some
    overlapping, one degenerate, plus zero padding."""
    c = rng.uniform(-0.004, 0.004, (t, 1, 3)).astype(np.float32)
    c[..., 2] = rng.uniform(0.02, 0.03, (t, 1))
    tris = c + rng.uniform(-0.004, 0.004, (t, 3, 3)).astype(np.float32) * np.array([1, 1, 0.1], np.float32)
    tris[1, 2] = tris[1, 1]  # degenerate
    tris[-3:] = 0.0  # padding
    return tris


def _pix(w=16, h=12, extent=(0.01, 0.008)):
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w * extent[0] - extent[0] / 2
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h * extent[1] - extent[1] / 2
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([xx, yy], -1).reshape(-1, 2)


@pytest.mark.parametrize("chunk", [None, 16], ids=["unchunked", "chunked"])
def test_raster_depth_matches_jax(chunk):
    """40 triangles rasterized whole, and in chunks of 16 (the JAX side pads
    the last chunk and scans); the port takes a batch of 3 cameras."""
    rng = np.random.default_rng(2)
    tris = np.stack([_cam_tris(rng, 40) for _ in range(3)])
    pix = _pix()
    kw = {} if chunk is None else {"chunk": chunk}
    raster_j = jax.jit(jax.vmap(lambda t_, p_: jr.raster_depth(t_, p_, **kw), in_axes=(0, None)))
    dj = np.asarray(raster_j(jnp.asarray(tris), jnp.asarray(pix)))
    dt = tr.raster_depth(T(tris), T(pix), chunk=chunk)
    assert dt.shape == (3, len(pix))
    np.testing.assert_allclose(dt.numpy(), dj, atol=DEPTH_ATOL)
    assert 0.2 < (dj < jr.BIG).mean() < 1.0
    # the degenerate triangle and the padding are poisoned on both sides
    coeffs_j = np.asarray(jax.jit(jr.triangle_affine_coeffs)(jnp.asarray(tris[0])))
    coeffs_t = tr.triangle_affine_coeffs(T(tris[0])).numpy()
    for i in (1, 37, 38, 39):
        assert coeffs_t[i, 2, 0] == coeffs_j[i, 2, 0] == -jr.BIG


def test_transforms_and_render_depth_with_triangles_match_jax():
    """A peg mesh placed by ``transform_tris``, seen by 3 tilted cameras
    through ``render_depth_batch`` (a sphere in the scene too), and one
    camera through ``render_depth``."""
    rng = np.random.default_rng(3)
    mesh = meshes.cylinder_mesh(0.004, 0.05, segments=24)
    n = 3
    pos = np.array([[0.6, 0.0, 0.05]] * n, np.float32) + rng.uniform(-0.001, 0.001, (n, 3)).astype(np.float32)
    quat = _quats(rng, n) * 0.1 + np.array([1, 0, 0, 0], np.float32)
    quat = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    tris_j = jax.jit(jax.vmap(lambda p, q: jr.transform_tris(p, q, jnp.asarray(mesh))))(jnp.asarray(pos), jnp.asarray(quat))
    tris_t = tr.transform_tris(T(pos), T(quat), T(mesh))
    np.testing.assert_allclose(tris_t.numpy(), np.asarray(tris_j), atol=1e-7)
    cam_quat = np.tile(np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0], np.float32), (n, 1))
    cam_pos = pos + np.array([0.0, 0.0285, 0.03], np.float32)
    np.testing.assert_allclose(
        tr.world_tris_to_cam(T(cam_pos), T(cam_quat), tris_t).numpy(),
        np.asarray(jax.jit(jax.vmap(jr.world_tris_to_cam))(jnp.asarray(cam_pos), jnp.asarray(cam_quat), tris_j)),
        atol=1e-7,
    )
    z = lambda *s: np.zeros((n,) + s, np.float32)
    spheres = z(1, 4)
    spheres[0, 0] = [*(pos[0] + [0.002, 0.0, 0.028]), 0.002]
    scene_j = jd.SdfScene(jnp.asarray(spheres), jnp.asarray(z(1, 10)), jnp.asarray(z(1, 8)), jnp.asarray(z(1, 4)),
                          triangles=tris_j)
    scene_t = td.SdfScene(T(spheres), T(z(1, 10)), T(z(1, 8)), T(z(1, 4)), triangles=tris_t)
    args = ((32, 32), (0.0189, 0.0142), 0.029)
    render_j = jax.jit(jd.render_depth_batch, static_argnums=(3, 4, 5))
    dj = np.asarray(render_j(jnp.asarray(cam_pos), jnp.asarray(cam_quat), scene_j, *args))
    dt = td.render_depth_batch(T(cam_pos), T(cam_quat), scene_t, *args)
    # the world sits 0.6 m out, where one f32 step is 6e-8 m: a pixel centre
    # within a few steps of a silhouette edge may fall on either side
    close = np.abs(dt.numpy() - dj) <= DEPTH_ATOL
    assert close.mean() > 0.995, close.mean()
    assert 0.1 < (dj < 0.029).mean() < 0.9
    one = td.render_depth(T(cam_pos[1]), T(cam_quat[1]), T(spheres[1]), T(z(1, 10)[0]), T(z(1, 8)[0]),
                          T(z(1, 4)[0]), *args, scene_triangles=tris_t[1])
    np.testing.assert_allclose(one.numpy(), dt[1].numpy(), atol=0)
