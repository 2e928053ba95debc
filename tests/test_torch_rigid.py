"""Parity of the port's maths, Franka kinematics, contact model and depth
camera with JAX, on random inputs made with numpy. Tolerance 1e-5 (f32
transcendentals and short sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.core import maths as jm
from tacex_tpu.physics.rigid import contact as jc
from tacex_tpu.physics.rigid import franka as jf
from tacex_tpu.render import depth_camera as jd
from tacex_tpu_torch.core import maths as tm
from tacex_tpu_torch.physics.rigid import contact as tc
from tacex_tpu_torch.physics.rigid import franka as tf
from tacex_tpu_torch.render import depth_camera as td

setup_torch()

T = lambda a: torch.tensor(np.asarray(a))
J = jnp.asarray
ATOL = 1e-5


def close(a, b, atol=ATOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize(
    "name",
    ["quat_mul", "quat_apply", "quat_apply_inverse", "quat_conjugate", "quat_normalize", "matrix_from_quat",
     "quat_from_matrix", "euler_xyz_from_quat", "yaw_from_quat", "axis_angle_from_quat", "quat_from_angle_axis"],
)
def test_maths(name):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    q1[:8] = [1, 0, 0, 0]  # identity: the axis-angle and matrix branches
    q1[8:16, 0] *= -1  # negative w
    v = rng.normal(size=(64, 3)).astype(np.float32)
    args = {
        "quat_mul": (q1, q2),
        "quat_apply": (q1, v),
        "quat_apply_inverse": (q1, v),
        "quat_conjugate": (q1,),
        "quat_normalize": (q1 * 3.0,),
        "matrix_from_quat": (q1,),
        "quat_from_matrix": (np.asarray(jm.matrix_from_quat(J(q1))),),
        "euler_xyz_from_quat": (q1,),
        "yaw_from_quat": (q1,),
        "axis_angle_from_quat": (q1,),
        "quat_from_angle_axis": (rng.uniform(-3, 3, 64).astype(np.float32), v / np.linalg.norm(v, axis=-1, keepdims=True)),
    }[name]
    out_t = getattr(tm, name)(*[T(a) for a in args])
    out_j = getattr(jm, name)(*[J(a) for a in args])
    for a, b in zip(out_t if isinstance(out_t, tuple) else (out_t,), out_j if isinstance(out_j, tuple) else (out_j,)):
        close(a, b)


def test_identity():
    close(tm.quat_identity((3,)), jm.quat_identity((3,)))


class TestFranka:
    def _q(self, n=16):
        rng = np.random.default_rng(1)
        lo, hi = np.asarray(jf.Q_LOWER), np.asarray(jf.Q_UPPER)
        return rng.uniform(lo, hi, (n, 7)).astype(np.float32)

    def test_fk_and_jacobian(self):
        q = self._q()
        off = (0.0, 0.0, 0.131)
        out_t = tf.forward_kinematics(T(q), ee_offset_pos=off)
        out_j = jax.jit(jf.forward_kinematics)(J(q), ee_offset_pos=J(off))
        for a, b in zip(out_t, out_j):
            close(a, b)
        close(tf.geometric_jacobian(*out_t[:1], *out_t[2:]), jf.geometric_jacobian(out_j[0], out_j[2], out_j[3]))

    def test_dls_ik_servo_and_delta_pose(self):
        rng = np.random.default_rng(2)
        q = self._q()
        dpos = rng.uniform(-0.01, 0.01, (16, 3)).astype(np.float32)
        drot = rng.uniform(-0.05, 0.05, (16, 3)).astype(np.float32)
        limits = tf.ArmLimits.on()
        off = (0.0, 0.0, 0.131)
        st_j = jax.jit(jf.apply_delta_pose_ik)(jf.ArmState.init(16, J(q)), J(dpos), J(drot), ee_offset_pos=J(off))
        st_t = tf.apply_delta_pose_ik(tf.ArmState.init(16, T(q)), T(dpos), T(drot), limits, ee_offset_pos=off)
        close(st_t.q_target, st_j.q_target)
        for _ in range(4):
            st_j = jf.servo_step(st_j, 1.0 / 240.0)
            st_t = tf.servo_step(st_t, 1.0 / 240.0, limits)
        close(st_t.q, st_j.q)
        close(st_t.qd, st_j.qd)


class TestContact:
    def _case(self, n=32):
        rng = np.random.default_rng(3)
        pos = rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32)
        pos[:, 2] = rng.uniform(0.002, 0.012, n)
        lin = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
        ang = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
        box_pos = (pos + rng.uniform(-0.008, 0.008, (n, 3))).astype(np.float32)
        box_pos[:4] = pos[:4]  # centre inside the box
        box_quat = _quats(rng, n)
        box_vel = rng.normal(scale=0.02, size=(n, 3)).astype(np.float32)
        mass = rng.uniform(0.005, 0.015, n).astype(np.float32)
        fric = rng.uniform(0.2, 1.0, n).astype(np.float32)
        rest = rng.uniform(0.0, 0.5, n).astype(np.float32)
        return pos, lin, ang, box_pos, box_quat, box_vel, mass, fric, rest

    def test_sphere_box_and_plane(self):
        pos, lin, ang, bp, bq, bv, mass, fric, rest = self._case()
        half = np.array([0.0104, 0.0126, 0.00225], np.float32)
        p_j = jc.SphereParams(radius=0.005, mass=J(mass), restitution=J(rest), friction=J(fric))
        p_t = tc.SphereParams(radius=0.005, mass=T(mass), restitution=T(rest), friction=T(fric))
        dt = 1.0 / 240.0
        box_j = jax.jit(lambda *a: jc.sphere_box_contact(*a, p_j, dt, stiffness_scale=0.35))
        out_j = box_j(J(pos), J(lin), J(ang), J(bp), J(bq), J(bv), J(half))
        out_t = tc.sphere_box_contact(T(pos), T(lin), T(ang), T(bp), T(bq), T(bv), T(half), p_t, dt, stiffness_scale=0.35)
        assert np.abs(np.asarray(out_j[0])).max() > 0
        for a, b in zip(out_t, out_j):  # angular impulses scale with 1/(m r^2): 1e-5 relative
            close(a, b, atol=ATOL * max(1.0, float(np.abs(np.asarray(b)).max())))
        out_j = jc.sphere_plane_contact(J(pos), J(lin), J(ang), (0.0, 0.0, 1.0), 0.0026, p_j, dt)
        out_t = tc.sphere_plane_contact(T(pos), T(lin), T(ang), (0.0, 0.0, 1.0), 0.0026, p_t, dt)
        for a, b in zip(out_t, out_j):
            close(a, b, atol=ATOL * max(1.0, float(np.abs(np.asarray(b)).max())))
        close(tc.closest_point_on_box(T(pos), T(bp), T(bq), T(half)), jc.closest_point_on_box(J(pos), J(bp), J(bq), J(half)))

    def test_sphere_box_lock_rotation(self):
        """The opposing-pinch model (k_t = 1/m, no angular friction impulse)
        against JAX's, and apart from the free sphere's response."""
        pos, lin, ang, bp, bq, bv, mass, fric, rest = self._case()
        half = np.array([0.0104, 0.0126, 0.00225], np.float32)
        p_j = jc.SphereParams(radius=0.005, mass=J(mass), restitution=J(rest), friction=J(fric))
        p_t = tc.SphereParams(radius=0.005, mass=T(mass), restitution=T(rest), friction=T(fric))
        dt = 1.0 / 240.0
        box_j = jax.jit(lambda *a: jc.sphere_box_contact(*a, p_j, dt, stiffness_scale=0.35, lock_rotation=True))
        out_j = box_j(J(pos), J(lin), J(ang), J(bp), J(bq), J(bv), J(half))
        args_t = (T(pos), T(lin), T(ang), T(bp), T(bq), T(bv), T(half), p_t, dt)
        out_t = tc.sphere_box_contact(*args_t, stiffness_scale=0.35, lock_rotation=True)
        for a, b in zip(out_t, out_j):
            close(a, b, atol=ATOL * max(1.0, float(np.abs(np.asarray(b)).max())))
        free_t = tc.sphere_box_contact(*args_t, stiffness_scale=0.35)
        for locked, free in zip(out_t, free_t):
            assert (locked - free).abs().max() > 1e3 * ATOL * max(1.0, float(free.abs().max()))


def test_render_depth_batch():
    rng = np.random.default_rng(4)
    n = 4
    cam_pos = np.zeros((n, 3), np.float32)
    cam_pos[:, :2] = rng.uniform(-0.002, 0.002, (n, 2))
    cam_quat = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    cam_quat[1] = _quats(rng, 1)[0] * 0.05 + np.array([1, 0, 0, 0])
    cam_quat /= np.linalg.norm(cam_quat, axis=-1, keepdims=True)
    spheres = np.zeros((n, 2, 4), np.float32)
    spheres[:, 0] = [0.0, 0.0, 0.03, 0.005]
    spheres[:, 1] = [0.004, -0.003, 0.027, 0.002]
    boxes = np.zeros((n, 1, 10), np.float32)
    boxes[:2, 0] = [-0.005, 0.004, 0.028, 1, 0, 0, 0, 0.002, 0.002, 0.002]
    boxes[1, 0, 3:7] = _quats(rng, 1)[0]
    capsules = np.zeros((n, 1, 8), np.float32)
    capsules[2:, 0] = [-0.006, -0.004, 0.026, 0.006, -0.004, 0.027, 0.0015, 1.0]
    planes = np.tile(np.array([0.0, 0.0, -1.0, -0.031], np.float32), (n, 1, 1))
    scene_j = jd.SdfScene(J(spheres), J(boxes), J(capsules), J(planes))
    scene_t = td.SdfScene(T(spheres), T(boxes), T(capsules), T(planes))
    extent = (0.0295 * 640 / 1000.0, 0.0295 * 480 / 1000.0)
    out_j = jax.jit(jd.render_depth_batch, static_argnums=(3, 4, 5))(J(cam_pos), J(cam_quat), scene_j, (32, 24), extent, 0.029)
    out_t = td.render_depth_batch(T(cam_pos), T(cam_quat), scene_t, (32, 24), extent, 0.029)
    assert out_t.shape == (n, 24, 32)
    close(out_t, out_j)
    assert (np.asarray(out_j) < 0.029).mean() > 0.05
    one_t = td.render_depth(T(cam_pos[0]), T(cam_quat[0]), T(spheres[0]), T(boxes[0]), T(capsules[0]), T(planes[0]), (32, 24), extent, 0.029)
    close(one_t, out_j[0])


def test_triangle_scenes_raise_until_the_rasterizer_is_ported():
    """The rasterizer is ported now: a scene with triangles (one real, one
    zero padding) renders as in the JAX package, to 1e-5 m."""
    z = lambda shape: np.zeros(shape, np.float32)
    tris = z((2, 2, 3, 3))
    tris[:, 0] = [[-0.004, -0.004, 0.027], [0.004, -0.003, 0.026], [0.0, 0.004, 0.028]]
    tris[1, 0, :, 2] += 0.001
    scene_j = jd.SdfScene(J(z((2, 1, 4))), J(z((2, 1, 10))), J(z((2, 1, 8))), J(z((2, 1, 4))), triangles=J(tris))
    scene_t = td.SdfScene(T(z((2, 1, 4))), T(z((2, 1, 10))), T(z((2, 1, 8))), T(z((2, 1, 4))), triangles=T(tris))
    cam_pos, cam_quat = z((2, 3)), np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1))
    out_j = jax.jit(jd.render_depth_batch, static_argnums=(3, 4, 5))(J(cam_pos), J(cam_quat), scene_j, (8, 6), (0.01, 0.01), 0.03)
    out_t = td.render_depth_batch(T(cam_pos), T(cam_quat), scene_t, (8, 6), (0.01, 0.01), 0.03)
    close(out_t, out_j)
    assert 0.1 < (np.asarray(out_j) < 0.03).mean() < 0.9
