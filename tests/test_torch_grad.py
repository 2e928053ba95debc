"""Gradients of the port against the JAX package's, on the CPU.

The inputs are made with numpy from a seed and go through both packages.

- K1's plain adjoint (``deformation_pyramid_backward_plain``) equals
  autograd of the plain pyramid to 1e-5 of the gradient's largest value,
  at the flagship's sigmas and where the reflect fold reaches the border.
- The height-map VJP of ``compute_gel_deformation`` and the height-map
  gradient of ``render(interp="bilinear")`` equal JAX's to 1e-5 and 1e-4
  of the gradient's norm. The render loss weighs only pixels of a
  well-sloped ring of the press: where the slope is float noise
  (|grad| ~ 1e-8 out of contact, and at the press's flat bottom) the
  direction's derivative is 1 / |grad| times that noise.
- ``SoftBodyModel.step``'s gradient in the sphere, ``x``, ``v`` and the
  aim equals one jitted JAX gradient to 1e-2 of each gradient's norm. The
  gel is ``tests/test_soft_ipc.py::TestDiffSim``'s, one step with friction
  and ``velocity_tol=0``, at 3 Newton x 3 CG iterations. With 12 CG
  iterations the unrolled gradient of either package moves by up to its own
  size under a 1e-9 m jolt of ``x``: CG's later iterations run on a
  residual at the float32 rounding level, and their step lengths' tangents
  are ratios of rounding noise. At 3 x 3 both packages move by at most
  2e-3 of the norm under that jolt, and the two agree to 3.5e-3.
- With ``ccd_substeps=2`` the port's gradient in the ball's height agrees
  with its own central difference within ``TestDiffSim``'s bounds, and the
  graph-carrying step's primal equals the step without a gradient bit for
  bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _reference_oracle import sphere_height_map
from _torch_bins import setup_torch
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu.sensors.gelsight.taxim import calib as jcalib
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch.ops import pyramid as tpyr
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

HW = (24, 32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def calibs():
    return jcalib.load_calib().at_resolution(HW), tcalib.load_calib().at_resolution(HW)


def _press_maps(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, h, w) sphere presses (mm, 0 = gel top) and each pixel's distance
    in pixels from its press's centre."""
    h, w = HW
    pix = 0.0295 * 640 / w
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    maps, radii = [], []
    for i in range(n):
        c = (h / 2.0 + 1.5 * i - 0.7, w / 2.0 - 2.0 * i + 1.3)
        maps.append(sphere_height_map(h, w, radius_mm=4.0, pixmm=pix, center=c) - (0.6 + 0.4 * i))
        radii.append(np.hypot(yy - c[0], xx - c[1]))
    return np.stack(maps).astype(np.float32), np.stack(radii)


@pytest.mark.parametrize("case", ["flagship", "reflect_fold"])
def test_plain_adjoint_equals_autograd(calibs, case):
    """The explicit adjoint is the transpose of the plain pyramid; near the
    border the folded-in reflection makes the transposed blur differ from
    the blur, which the second case probes (half-widths 14 of 16 columns and
    10 of 12 rows)."""
    _, cal_t = calibs
    if case == "flagship":
        sim, hw = cal_t.sim_params, HW
        sigmas = list(sim.deform_pyramid_sigma(hw)) + [sim.deform_final_sigma(hw)]
    else:
        hw, sigmas = (12, 16), [(7.0, 4.6), (1.0, 1.0), (7.0, 4.6)]
        taps, ky, kx = tpyr._packed_taps(tuple(sigmas), *hw)
        assert (ky[0] - 1) // 2 == hw[0] - 2 and (kx[0] - 1) // 2 == hw[1] - 2
    rng = np.random.default_rng(3)
    joined = torch.from_numpy(rng.normal(size=(3,) + hw).astype(np.float32)).requires_grad_(True)
    mask = torch.from_numpy(rng.random((3,) + hw) < 0.3)
    g = torch.from_numpy(rng.normal(size=(3,) + hw).astype(np.float32))
    (auto,) = torch.autograd.grad(tpyr.deformation_pyramid_plain(joined, mask, sigmas), joined, g)
    plain = tpyr.deformation_pyramid_backward_plain(g, mask, sigmas)
    assert float((plain - auto).abs().max()) <= 1e-5 * float(auto.abs().max())
    # the CPU wrapper takes the plain adjoint
    torch.testing.assert_close(tpyr.deformation_pyramid_backward(g, mask, sigmas), plain, rtol=0, atol=0)
    # the transposed blur is not the blur at the border
    blurred = tpyr.deformation_pyramid_plain(g, torch.zeros_like(mask), sigmas[:1])
    assert not torch.allclose(tpyr.deformation_pyramid_backward_plain(g, torch.zeros_like(mask), sigmas[:1]), blurred)


def test_deformation_vjp_matches_jax(calibs):
    cal_j, cal_t = calibs
    hm, _ = _press_maps(2)
    # no height equals the gel surface, so minimum's tie rule plays no part
    assert not np.any(hm == cal_t.gel_map.numpy())
    cot = np.random.default_rng(5).normal(size=hm.shape).astype(np.float32)
    (g_j,) = jax.jit(lambda x, c: jax.vjp(lambda y: joptical.compute_gel_deformation(cal_j, y)[0], x)[1](c))(
        jnp.asarray(hm), jnp.asarray(cot))
    x = torch.from_numpy(hm).requires_grad_(True)
    (g_t,) = torch.autograd.grad(toptical.compute_gel_deformation(cal_t, x)[0], x, torch.from_numpy(cot))
    assert _rel(g_j, g_t.numpy()) <= 1e-5


def test_render_bilinear_gradient_matches_jax(calibs):
    cal_j, cal_t = calibs
    hm, radius = _press_maps(2)
    assert not np.any(hm == cal_t.gel_map.numpy())
    rng = np.random.default_rng(7)
    ring = ((radius > 2.0) & (radius < 5.0)).astype(np.float32)
    weight = (ring[..., None] * rng.uniform(0.5, 1.5, hm.shape + (3,))).astype(np.float32)
    g_j = jax.jit(jax.grad(
        lambda x: (jnp.asarray(weight) * joptical.render(cal_j, x, with_shadow=False, interp="bilinear")).sum()
    ))(jnp.asarray(hm))
    x = torch.from_numpy(hm).requires_grad_(True)
    img = toptical.render(cal_t, x, with_shadow=False, interp="bilinear")
    (g_t,) = torch.autograd.grad((torch.from_numpy(weight) * img).sum(), x)
    g_j = np.asarray(g_j)
    assert np.isfinite(g_t.numpy()).all() and np.abs(g_j).max() > 0
    assert _rel(g_j, g_t.numpy()) <= 1e-4


# ----------------------------------------------------------- the soft step
GEL = dict(size=(0.02, 0.02, 0.008), res=(4, 4, 2), center=(0.0, 0.0, -0.004))


def _soft_cfg(module, **kw):
    return module.IpcSolverCfg(dt=1 / 60, newton_max_iter=3, cg_iters=3, d_hat=5e-4, kappa=2e4, friction_mu=0.5,
                               velocity_tol=0.0).replace(**kw)


def _soft_inputs():
    """(JAX mesh, rest points, mount ids, sphere, x, v, aim, loss weights),
    the arrays numpy:
    TestDiffSim's gel and ball, a random velocity and a 0.3 mm lift of the
    mount."""
    mesh = jmesh.box_tet_mesh(GEL["size"], GEL["res"], center=GEL["center"], use_native=False)
    pts = mesh.points.astype(np.float32)
    mount = np.where(pts[:, 2] < -0.008 + 1e-9)[0].astype(np.int32)
    rng = np.random.default_rng(0)
    x = pts[None].copy()
    v = (rng.normal(size=x.shape) * 1e-3).astype(np.float32)
    aim = (pts[mount][None] + np.array([0.0, 0.0, 3e-4], np.float32)).astype(np.float32)
    sph = np.array([[[0.0005, -0.0003, 0.003, 0.004]]], np.float32)
    weights = rng.normal(size=x.shape).astype(np.float32)
    return mesh, pts, mount, sph, x, v, aim, weights


def _torch_model(mesh, mount, **kw):
    m = tmesh.box_tet_mesh(GEL["size"], GEL["res"], center=GEL["center"])
    assert np.array_equal(m.tets, mesh.tets)
    return tipc.SoftBodyModel(m, youngs_modulus=1e5, cfg=_soft_cfg(tipc, **kw), attachment_verts=mount, device="cpu")


def _torch_scene(sph, boxes=None):
    boxes = torch.zeros((1, 1, 10)) if boxes is None else boxes
    return tipc.RigidSdfScene(sph, boxes, torch.zeros((1, 1, 8)), torch.zeros((1, 1, 4)))


@pytest.fixture(scope="module")
def soft_jax_grad():
    """One jit of JAX's gradient of the loss in (sphere, x, v, aim), through
    the one env's ``_step_single`` (``step`` is its vmap; tracing the vmap
    costs another second)."""
    mesh, pts, mount, sph, x, v, aim, weights = _soft_inputs()
    model = jipc.SoftBodyModel(mesh, youngs_modulus=1e5, cfg=_soft_cfg(jipc), attachment_verts=mount)

    def loss(s, x, v, a):
        scene = jipc.RigidSdfScene(s[0], jnp.zeros((1, 10)), jnp.zeros((1, 8)), jnp.zeros((1, 4)))
        x1, v1 = model._step_single(x[0], v[0], scene, a[0])
        return jnp.sum((x1 - pts) ** 2) * 1e4 + jnp.sum(weights[0] * v1) * 1e-2

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(t) for t in (sph, x, v, aim)))
    return [np.asarray(g) for g in grads]


def test_soft_step_gradient_matches_jax(soft_jax_grad):
    mesh, pts, mount, sph, x, v, aim, weights = _soft_inputs()
    model = _torch_model(mesh, mount)
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (sph, x, v, aim)]
    st = model.step(tipc.SoftBodyState(x=ins[1], v=ins[2]), _torch_scene(ins[0]), ins[3])
    assert st.x.grad_fn is not None and st.v.grad_fn is not None
    loss = ((st.x[0] - torch.from_numpy(pts)) ** 2).sum() * 1e4 + (torch.from_numpy(weights) * st.v).sum() * 1e-2
    grads = torch.autograd.grad(loss, ins)
    for name, g_j, g_t in zip(("sphere", "x", "v", "aim"), soft_jax_grad, grads):
        assert np.linalg.norm(g_j) > 0, name
        assert _rel(g_j, g_t.numpy()) <= 1e-2, (name, _rel(g_j, g_t.numpy()))
    # the ball is in contact: its height moves the solve
    assert abs(float(grads[0][0, 0, 2])) > 1.0


def test_ccd_substep_gradient_against_finite_difference():
    """Two CCD substeps against a ball that comes down from 0.6 to 0.2 mm
    above the gel over the step (the lerped scene; ``scene_prev``'s box
    takes the quaternion flip): the gradient in the ball's end height
    against the port's own central difference, with TestDiffSim's bounds;
    and the graph-carrying path's primal equal to the step without a
    gradient bit for bit.

    The ball starts clear of the gel. From TestDiffSim's start, 1 mm deep,
    the two packages' gradients agree (250.48 here, 250.38 in JAX) but the
    solve is not smooth there: without friction its central difference
    changes sign with the step size."""
    mesh, pts, mount, sph, x, v, aim, _ = _soft_inputs()
    sph[0, 0, 2] = 0.0042
    model = _torch_model(mesh, mount, ccd_substeps=2)
    box_prev = torch.zeros((1, 1, 10))
    box_prev[0, 0, 3:7] = torch.tensor([0.0, 0.0, 0.0, -1.0])  # the far hemisphere of the identity
    box = torch.zeros((1, 1, 10))
    box[0, 0, 6] = 1.0
    sph_prev = torch.from_numpy(sph.copy())
    sph_prev[0, 0, 2] += 4e-4
    rest = torch.from_numpy(pts)

    def step(z, boxes_prev):
        s = torch.cat([torch.from_numpy(sph[..., :2]), z.reshape(1, 1, 1), torch.from_numpy(sph[..., 3:])], -1)
        return model.step(tipc.SoftBodyState(x=torch.from_numpy(x), v=torch.from_numpy(v)), _torch_scene(s, box),
                          torch.from_numpy(aim), scene_prev=_torch_scene(sph_prev, boxes_prev))

    def loss(st):
        return ((st.x[0] - rest) ** 2).sum() * 1e4

    z0 = float(sph[0, 0, 2])
    z = torch.tensor(z0, requires_grad=True)
    boxes_prev = box_prev.clone().requires_grad_(True)
    st = step(z, boxes_prev)
    g, g_box = torch.autograd.grad(loss(st), (z, boxes_prev))
    with torch.no_grad():
        plain = step(torch.tensor(z0), box_prev)
        h = 2e-5
        fd = (float(loss(step(torch.tensor(z0 + h), box_prev))) - float(loss(step(torch.tensor(z0 - h), box_prev)))) / (2 * h)
    assert torch.equal(st.x.detach(), plain.x) and torch.equal(st.v.detach(), plain.v)
    assert np.isfinite(float(g)) and torch.isfinite(g_box).all()
    assert float(g) < 0 and fd < 0, (float(g), fd)
    assert 0.2 < float(g) / fd < 5.0, (float(g), fd)


def test_contact_families_differentiate():
    """The nodal contact families (self, edge-edge, static triangles) ride
    on the same solve: a step with all three on gives a finite gradient in
    the aim, and its primal equals the step without a gradient."""
    mesh, pts, mount, sph, x, v, aim, _ = _soft_inputs()
    tri = np.array([[[-0.01, -0.01, 0.0012], [0.01, -0.01, 0.0012], [0.0, 0.01, 0.0012]]], np.float32)
    m = tmesh.box_tet_mesh(GEL["size"], GEL["res"], center=GEL["center"])
    model = tipc.SoftBodyModel(m, youngs_modulus=1e5, attachment_verts=mount, static_tris=tri, device="cpu",
                               cfg=_soft_cfg(tipc, self_contact_k=2, ee_contact_k=2, newton_max_iter=2))
    a = torch.from_numpy(aim).requires_grad_(True)
    scene = _torch_scene(torch.from_numpy(sph))
    st = model.step(tipc.SoftBodyState(x=torch.from_numpy(x), v=torch.from_numpy(v)), scene, a)
    (g,) = torch.autograd.grad((st.x[..., 2] ** 2).sum(), a)
    with torch.no_grad():
        plain = model.step(tipc.SoftBodyState(x=torch.from_numpy(x), v=torch.from_numpy(v)), scene, torch.from_numpy(aim))
    assert torch.equal(st.x.detach(), plain.x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
