"""The edge-edge primitives, ``scene_motion`` and the FEM geometry helpers,
port against the JAX package, on seeded random inputs.

Segment pairs are drawn with numpy from a seed, kept clear of parallels
(sin^2 of their angle above 0.05: at exact parallels JAX's closest point
has a NaN gradient where the port's may be finite, ROADMAP Queue 3) and of
the clamp boundaries' kinks. Tolerances (f32): closest points and
distances 1e-6 (absolute, unit-scale inputs), their gradients 1e-4
relative to the largest; crossing tests and masks exactly; the mollifier
1e-6 and its gradient 1e-4; ``scene_motion`` rtol 1e-6 and its gradient
1e-5; the Kabsch transform 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.sensors.gelsight.fem import geometry as jgeo
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.sensors.gelsight.fem import geometry as tgeo

setup_torch()

P = 256


def _segments(seed: int, n: int = P) -> np.ndarray:
    """(4, n, 3) endpoints p1, p2, q1, q2 of n non-parallel segment pairs."""
    rng = np.random.default_rng(seed)
    out = np.empty((4, 0, 3), np.float32)
    while out.shape[1] < n:
        s = rng.normal(size=(4, 4 * n, 3)).astype(np.float32)
        d1, d2 = s[1] - s[0], s[3] - s[2]
        c = np.cross(d1, d2)
        sin2 = (c * c).sum(-1) / ((d1 * d1).sum(-1) * (d2 * d2).sum(-1))
        out = np.concatenate([out, s[:, sin2 > 0.05]], 1)
    return out[:, :n]


def _grads_t(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(out.sum(), ts)]


def _grads_j(fn, args):
    args = [jnp.asarray(a) for a in args]
    g = jax.grad(lambda *a: fn(*a).sum(), argnums=tuple(range(len(args))))(*args)
    return np.asarray(fn(*args)), [np.asarray(x) for x in g]


def _close_grads(gt, gj, rtol=1e-4):
    for a, b in zip(gt, gj):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=rtol * max(np.abs(b).max(), 1.0), rtol=0)


def test_segment_segment_closest_and_distance():
    s = _segments(0)
    cj = [np.asarray(a) for a in jipc._segment_segment_closest(*map(jnp.asarray, s))]
    ct = [a.numpy() for a in tipc._segment_segment_closest(*map(torch.from_numpy, s))]
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    dt, gt = _grads_t(tipc._edge_edge_distance, s)
    dj, gj = _grads_j(jipc._edge_edge_distance, s)
    np.testing.assert_allclose(dt, dj, atol=1e-6, rtol=0)
    _close_grads(gt, gj)
    # the cascade's regions are all visited: interior points and clamped ends
    assert (dt > 0).all() and np.isclose(np.linalg.norm(cj[0] - s[0], axis=-1), 0).any()


def test_edge_pair_crossed():
    a = _segments(1)
    rng = np.random.default_rng(2)
    b = (a + rng.normal(0, 0.6, a.shape)).astype(np.float32)
    cj = np.asarray(jipc._edge_pair_crossed(*map(jnp.asarray, a), *map(jnp.asarray, b)))
    ct = tipc._edge_pair_crossed(*map(torch.from_numpy, a), *map(torch.from_numpy, b)).numpy()
    np.testing.assert_array_equal(ct, cj)
    assert 0 < cj.sum() < len(cj)


@pytest.mark.parametrize("scale", [0.3, 3.0])
def test_edge_edge_mollifier(scale):
    """Near-parallel and far-from-parallel pairs, at eps_x below and above |d1 x d2|^2."""
    s = _segments(3)
    rng = np.random.default_rng(4)
    c = np.cross(s[1] - s[0], s[3] - s[2])
    eps = (scale * (c * c).sum(-1) * rng.uniform(0.5, 1.5, P)).astype(np.float32)
    mt, gt = _grads_t(lambda p1, p2, q1, q2: tipc.edge_edge_mollifier(p1, p2, q1, q2, torch.from_numpy(eps)), s)
    mj, gj = _grads_j(lambda p1, p2, q1, q2: jipc.edge_edge_mollifier(p1, p2, q1, q2, jnp.asarray(eps)), s)
    np.testing.assert_allclose(mt, mj, atol=1e-6, rtol=0)
    _close_grads(gt, gj)
    assert (mt < 1.0).any() == (scale > 1.0)


def _scenes(seed: int, n: int = 8):
    """Two frames of random scenes (every family, some primitives disabled)."""
    rng = np.random.default_rng(seed)

    def frame():
        sph = rng.normal(0, 0.02, (n, 3, 4)).astype(np.float32)
        sph[..., 3] = np.abs(sph[..., 3]) * (rng.uniform(size=(n, 3)) > 0.3)
        box = rng.normal(0, 0.02, (n, 2, 10)).astype(np.float32)
        box[..., 3:7] /= np.linalg.norm(box[..., 3:7], axis=-1, keepdims=True)
        box[..., 7:] = np.abs(box[..., 7:])
        cap = rng.normal(0, 0.02, (n, 2, 8)).astype(np.float32)
        cap[..., 7] = np.abs(cap[..., 7])
        pl = rng.normal(0, 1.0, (n, 2, 4)).astype(np.float32)
        pl[:, 1, :3] = 0.0  # a disabled plane
        return sph, box, cap, pl

    return frame(), frame()


def test_scene_motion():
    prev, curr = _scenes(5)
    mj = np.asarray(jipc.scene_motion(jipc.RigidSdfScene(*map(jnp.asarray, prev)),
                                      jipc.RigidSdfScene(*map(jnp.asarray, curr))))
    ct = [torch.tensor(a, requires_grad=True) for a in curr]
    mt = tipc.scene_motion(tipc.RigidSdfScene(*map(torch.from_numpy, prev)), tipc.RigidSdfScene(*ct))
    np.testing.assert_allclose(mt.detach().numpy(), mj, rtol=1e-6)
    gt = torch.autograd.grad(mt.sum(), ct)
    gj = jax.grad(lambda *c: jipc.scene_motion(jipc.RigidSdfScene(*map(jnp.asarray, prev)),
                                               jipc.RigidSdfScene(*c)).sum(), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, curr))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 * max(np.abs(np.asarray(b)).max(), 1.0))
    # a sphere moved 2 cm measures 2 cm; an unmoved scene 0
    one = tipc.RigidSdfScene.empty(1, device="cpu")
    a = tipc.RigidSdfScene(torch.tensor([[[0.0, 0.0, 0.0, 0.005]]]), one.boxes, one.capsules, one.planes)
    b = tipc.RigidSdfScene(torch.tensor([[[0.0, 0.0, 0.02, 0.005]]]), one.boxes, one.capsules, one.planes)
    np.testing.assert_allclose(tipc.scene_motion(a, b).numpy(), [0.02], rtol=1e-5)
    np.testing.assert_allclose(tipc.scene_motion(a, a).numpy(), [0.0], atol=1e-9)


def test_rigid_transform_and_transform_pts():
    rng = np.random.default_rng(6)
    src = rng.normal(size=(3, 12, 3)).astype(np.float32)
    ang = rng.uniform(-2, 2, 3)
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]] for a in ang]).astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    dst = np.asarray(jgeo.transform_pts(jnp.asarray(src), jnp.asarray(R), jnp.asarray(t)))
    dst_t = tgeo.transform_pts(torch.from_numpy(src), torch.from_numpy(R), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(dst_t, dst, atol=1e-6)
    noisy = (dst + rng.normal(0, 1e-3, dst.shape)).astype(np.float32)
    Rj, tj = jgeo.estimate_rigid_transform(jnp.asarray(src), jnp.asarray(noisy))
    Rt, tt = tgeo.estimate_rigid_transform(torch.from_numpy(src), torch.from_numpy(noisy))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert np.abs(Rt.numpy() - R).max() < 1e-2


def test_polygon_hull_and_rectangle():
    rng = np.random.default_rng(7)
    poly = np.array([[0.0, 0.0], [1.0, 0.0], [1.3, 0.8], [0.4, 1.2], [-0.2, 0.6]], np.float32)
    q = rng.uniform(-0.5, 1.5, (2, 200, 2)).astype(np.float32)
    ij = np.asarray(jgeo.points_in_polygon(jnp.asarray(q), jnp.asarray(poly)))
    it = tgeo.points_in_polygon(torch.from_numpy(q), torch.from_numpy(poly)).numpy()
    np.testing.assert_array_equal(it, ij)
    assert 0 < ij.sum() < ij.size
    hull = rng.normal(size=(20, 3))
    pts = rng.normal(size=(50, 3))
    np.testing.assert_array_equal(tgeo.in_hull(pts, hull), jgeo.in_hull(pts, hull))
    args = ((0.1, -0.2), 0.3, 0.2, 0.4)
    np.testing.assert_allclose(tgeo.random_rectangle_points(np.random.default_rng(0), *args),
                               jgeo.random_rectangle_points(np.random.default_rng(0), *args), atol=1e-12)


def test_fit_affine_pose():
    """The least-squares affine pose of positions an affine map of the rest
    points: exact (1e-5) and as the JAX package's."""
    from tacex_tpu.uipc.objects import _fit_affine_pose as jfit
    from tacex_tpu_torch.uipc.objects import _fit_affine_pose as tfit

    rng = np.random.default_rng(8)
    rest = rng.normal(0, 0.01, (8, 3)).astype(np.float32)
    A = (np.eye(3) + rng.normal(0, 0.1, (3, 3, 3))).astype(np.float32)
    t = rng.normal(0, 0.05, (3, 3)).astype(np.float32)
    pos = np.einsum("nij,vj->nvi", A, rest) + t[:, None]
    q_t = tfit(rest, torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(q_t, np.asarray(jfit(rest, jnp.asarray(pos))), atol=1e-5)
    np.testing.assert_allclose(q_t[:, :3], t, atol=1e-5)
    np.testing.assert_allclose(q_t[:, 3:].reshape(3, 3, 3), A, atol=1e-4)


def test_sensor_data_fields():
    from tacex_tpu.sensors.gelsight.sensor_data import GelSightSensorData as J
    from tacex_tpu_torch.sensors.gelsight.sensor_data import GelSightSensorData as T

    import dataclasses

    assert [f.name for f in dataclasses.fields(T)] == [f.name for f in dataclasses.fields(J)]
    d = T(pos_w=torch.zeros((2, 3)), output={"height_map": torch.zeros((2, 4, 5))})
    assert d.output["height_map"].shape == (2, 4, 5) and d.quat_w is None
