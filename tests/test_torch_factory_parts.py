"""The Factory tasks' parts in the port against the JAX package: the fixed
assets' SDFs and their ``torch.func`` normals, the held assets' sample
points, one ``held_asset_step`` (4 contact substeps) of every task, and, for
GearMesh and NutThread, the fingers' depth render and the 32x32 sensor. The
whole PegInsert step is in ``test_torch_factory.py``.

Tolerances: SDF values 1e-6 m and normals 5e-5 (the thread's and the
gears' angle goes through atan2, whose f32 result differs by an ulp between
XLA and PyTorch, and their profiles' slopes scale it); the held asset after
a step 1e-6 m, and 1e-4 relative to the largest value (quaternion, m/s,
rad/s), and so the diagnostics (N, N m, m): the world sits 0.6 m out, where
one f32 step is 6e-8 m, and the contact stiffness (2e4 N/m) turns that into
~1e-3 N on forces of up to a few hundred N, which the substeps on a 50 g
part carry into the velocities. Depth
maps 1e-6 m, except at the few pixel centres within f32 noise of a
silhouette edge. The tactile images, on the same depth, under the bin rule
of ``_torch_bins`` with both sides' bins and its ``FINGER_NOISE_FLOOR``
(tan|grad| 1e-4: a 32x32 gel keeps f32 blur noise gradients up to ~2e-5,
whose direction, and so whose magnitude-bin-0 row, is decided by the order
of the sums).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, lut_spread, setup_torch
from tacex_tpu.core import maths as jm
from tacex_tpu.envs.factory import contact as jc
from tacex_tpu.envs.factory import env as jenv
from tacex_tpu.physics.rigid import articulation as ja
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch.envs.factory import contact as tc
from tacex_tpu_torch.envs.factory import env as tenv
from tacex_tpu_torch.physics.rigid import articulation as ta
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

TASKS = ["peg_insert", "gear_mesh", "nut_thread"]
TASK_CFG = {"peg_insert": jenv.peg_insert_task, "gear_mesh": jenv.gear_mesh_task, "nut_thread": jenv.nut_thread_task}
N = 3
T = lambda a: torch.from_numpy(np.array(a, np.float32))
J = lambda a: jnp.asarray(np.asarray(a, np.float32))
TOL = {"pos": 1e-6, "quat": 1e-4, "linvel": 1e-4, "angvel": 1e-4}  # all but pos relative to max(1, |value|)
NORMAL_ATOL = 5e-5
SUBSTEPS = 4  # of held_asset_step: half the env's 8, to halve the JAX side's compile


def _near_surface(task, rng, n=200):
    """Points in the fixed asset's frame around its top, where the hole,
    shaft, gears or thread are; those within 1e-4 of the thread's seam
    (where ``floor`` jumps) are left out."""
    t = TASK_CFG[task]()
    top = t.fixed_size[2] / 2
    r = max(t.hole_diameter, t.held_diameter)
    pts = rng.uniform([-r, -r, top - t.hole_depth], [r, r, top + t.hole_depth], (n, 3)).astype(np.float32)
    if task == "nut_thread":
        u = pts[:, 2] - t.thread_pitch * np.arctan2(pts[:, 1], pts[:, 0]) / (2 * np.pi)
        f = u / t.thread_pitch - np.floor(u / t.thread_pitch)
        pts = pts[np.minimum(f, 1 - f) > 1e-3]
    return pts


@pytest.mark.parametrize("task", TASKS)
def test_fixed_sdf_normals_and_held_points_match_jax(task):
    t = TASK_CFG[task]()
    sdf_j, sdf_t = jc.make_fixed_sdf(task, t), tc.make_fixed_sdf(task, t, device="cpu")
    pts = _near_surface(task, np.random.default_rng(0))
    g_j, v_j = jax.jit(jax.vmap(jax.value_and_grad(sdf_j)))(J(pts))[::-1]
    g_t, v_t = torch.func.vmap(torch.func.grad_and_value(sdf_t))(T(pts))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=NORMAL_ATOL)
    assert (np.asarray(v_j) < 0).any() and (np.asarray(v_j) > 0).any()
    np.testing.assert_array_equal(tc.make_held_points(task, t), jc.make_held_points(task, t))


@functools.lru_cache(maxsize=None)
def _held_inputs(task):
    """N envs with the held asset just above its target, tilted and off
    centre, the grasp target 1 mm lower: contact on the first substeps."""
    t = TASK_CFG[task]()
    rng = np.random.default_rng(1)
    fixed_pos = np.array(t.fixed_init_pos, np.float32) + rng.uniform(-0.01, 0.01, (N, 3)).astype(np.float32)
    fixed_quat = np.tile(np.array([1, 0, 0, 0], np.float32), (N, 1))
    top = fixed_pos + np.array([0, 0, t.fixed_size[2] / 2], np.float32)
    lift = {"peg_insert": 0.0002, "gear_mesh": 0.002, "nut_thread": 0.001}[task]
    pos = top + np.concatenate([rng.uniform(-0.002, 0.002, (N, 2)), np.full((N, 1), lift)], -1).astype(np.float32)
    quat = np.concatenate([np.ones((N, 1)), rng.normal(0, 0.03, (N, 3))], -1)
    quat = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    held = dict(pos=pos, quat=quat, linvel=rng.normal(0, 0.01, (N, 3)).astype(np.float32),
                angvel=rng.normal(0, 0.1, (N, 3)).astype(np.float32))
    grasp_pos = pos - np.array([0, 0, 0.001], np.float32)
    return t, held, grasp_pos, quat, fixed_pos, fixed_quat


@pytest.mark.parametrize("task", TASKS)
def test_held_asset_step_matches_jax(task):
    t, held, grasp_pos, grasp_quat, fixed_pos, fixed_quat = _held_inputs(task)
    pts = jc.make_held_points(task, t)
    params, dt = jc.ContactParams(), 1.0 / 120.0
    sdf_j = jc.make_fixed_sdf(task, t)
    step_j = jax.jit(lambda s, *a: jc.held_asset_step(s, *a, J(pts), sdf_j, params, task, dt, substeps=SUBSTEPS))
    st_j, diag_j = step_j(jc.HeldState(**{k: J(v) for k, v in held.items()}),
                          *(J(a) for a in (grasp_pos, grasp_quat, fixed_pos, fixed_quat)))
    st_t, diag_t = tc.held_asset_step(
        tc.HeldState(**{k: T(v) for k, v in held.items()}), *(T(a) for a in (grasp_pos, grasp_quat, fixed_pos, fixed_quat)),
        T(pts), tc.make_fixed_sdf(task, t, device="cpu"), tc.ContactParams(), task, dt, substeps=SUBSTEPS,
    )
    for k, atol in TOL.items():
        v = np.asarray(getattr(st_j, k))
        scale = 1.0 if k == "pos" else max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(getattr(st_t, k).numpy(), v, atol=atol * scale, err_msg=k)
    for k, v in diag_j.items():
        v = np.asarray(v)
        np.testing.assert_allclose(diag_t[k].numpy(), v, atol=1e-4 * max(1.0, float(np.abs(v).max())), err_msg=k)
    assert float(np.asarray(diag_j["max_penetration"]).max()) > 1e-5, "no contact: the contact path was not exercised"
    assert float(np.abs(np.asarray(diag_j["contact_force"])).max()) > 0.1


@functools.lru_cache(maxsize=None)
def _env_pair(task):
    kw = dict(num_envs=2)
    env_j = jenv.FactoryEnv(jenv.FactoryEnvCfg(task=TASK_CFG[task](), **kw))
    env_t = tenv.FactoryEnv(tenv.FactoryEnvCfg(task=getattr(tenv, f"{task}_task")(), **kw), device="cpu")
    return env_j, env_t


@pytest.mark.parametrize("task", ["gear_mesh", "nut_thread"])
def test_finger_depths_and_sensor_match_jax(task):
    """The held asset, tilted in the grasp, rendered from both fingers
    (one rasterizer call for the 2N cameras), then the 32x32 sensor on the
    same depth maps."""
    env_j, env_t = _env_pair(task)
    c = env_j.cfg
    rng = np.random.default_rng(2)
    q = np.concatenate([np.tile(np.asarray(c.reset_joints, np.float32), (2, 1)),
                        np.full((2, 2), env_j._grip_half, np.float32)], -1)
    q[:, :7] += rng.normal(0, 0.02, (2, 7)).astype(np.float32)
    tool_pos, tool_quat = env_j._tool_pose(J(q))
    gpos, gquat = env_j._grasp_pose(tool_pos, tool_quat, J(rng.uniform(-0.002, 0.002, (2, 3))))
    tilt = np.concatenate([np.ones((2, 1)), rng.normal(0, 0.02, (2, 3))], -1)
    tilt = (tilt / np.linalg.norm(tilt, axis=-1, keepdims=True)).astype(np.float32)
    held = dict(pos=np.asarray(gpos), quat=np.asarray(jm.quat_mul(gquat, J(tilt))), linvel=np.zeros((2, 3), np.float32),
                angvel=np.zeros((2, 3), np.float32))
    arm = dict(q=q, qd=np.zeros_like(q), q_target=q)
    d_j = np.asarray(jax.jit(env_j._finger_depths)(ja.GripperArmState(**{k: J(v) for k, v in arm.items()}),
                                                   jc.HeldState(**{k: J(v) for k, v in held.items()})))
    d_t = env_t._finger_depths(ta.GripperArmState(**{k: T(v) for k, v in arm.items()}),
                               tc.HeldState(**{k: T(v) for k, v in held.items()})).numpy()
    assert d_t.shape == d_j.shape == (4, 32, 32)
    close = np.abs(d_t - d_j) <= 1e-6
    assert close.mean() > 0.99, close.mean()
    far = env_j.sensor.cfg.sensor_camera_cfg.clipping_range[1]
    assert ((d_j < far).reshape(4, -1).mean(1) > 0.05).all(), "a finger does not see the held asset"

    # the 32x32 sensor (pyramid and shading, plain versions here) on JAX's depth
    _, out_j = jax.jit(env_j.sensor.update)(env_j.sensor.init_state(), J(d_j))
    _, out_t = env_t.sensor.update(env_t.sensor.init_state(), T(d_j))
    np.testing.assert_allclose(out_t["indentation_depth"].numpy(), np.asarray(out_j["indentation_depth"]), atol=1e-4)
    assert (np.asarray(out_j["indentation_depth"]) > 0).all(), "a finger's gel is not pressed"
    grads = []
    for sensor, opt, depth in ((env_j.sensor, joptical, J(d_j)), (env_t.sensor, toptical, T(d_j))):
        hm = sensor.height_map_from_depth(depth)
        shifted = opt.shift_height_map(hm, sensor.compute_indentation_depth(hm))
        deformed, _ = opt.compute_gel_deformation(sensor.calib, shifted)
        grads.append(opt.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm))
    calib = env_t.sensor.calib
    nb = calib.sensor_params.num_bins
    bins_j = toptical.lut_bins(calib, T(grads[0][0]), T(grads[0][1]))
    bins_t = toptical.lut_bins(calib, *grads[1])
    gm_j, gd_j = (np.asarray(g) for g in grads[0])
    spread = lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb)
    assert_bin_rule(out_t["tactile_rgb"], out_j["tactile_rgb"], gm_j, gd_j, nb, spread, bins_t=bins_t, bins_j=bins_j,
                    noise_floor=FINGER_NOISE_FLOOR)
    assert (np.tan(gm_j) > FINGER_NOISE_FLOOR).mean() > 0.05, "the gel shows no contact gradient"
