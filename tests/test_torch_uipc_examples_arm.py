"""``examples/single_uipc_attachment_torch.py`` on the port against its JAX
scene on the CPU: a (6, 8, 2) gel pad on the Franka flange driven down over
a fixed 6 mm sphere, 2 envs, 2 steps through ``main(argv)``, against the
JAX script's scene built here as the script builds it (its ``main()`` takes
no arguments): the gel's positions within ``_torch_uipc_api.ATOL``
(1.5e-5 m).
"""

import runpy

import numpy as np

import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_uipc_api import ATOL, J, single_env_steps

setup_torch()

STEPS = 2


def _jax_single_attachment():
    from tacex_tpu.core import maths
    from tacex_tpu.physics.rigid import franka
    from tacex_tpu.physics.soft.ipc import RigidSdfScene

    n = 2
    sim = J.UipcSim(J.UipcSimCfg(num_envs=n, dt=1 / 60))
    gel = J.UipcObject(J.UipcObjectCfg(
        mesh_cfg=J.objects.TetMeshCfg(size=(0.0208, 0.0252, 0.0045), resolution=(6, 8, 2), center=(0, 0, -0.00225)),
        constitution=J.StableNeoHookeanCfg(youngs_modulus=0.145, poisson_rate=0.45)), sim)
    att = J.UipcIsaacAttachments(J.UipcIsaacAttachmentsCfg(attachment_points_radius=5e-4), gel)
    att.compute_attachment_data(np.zeros(3), np.array([1.0, 0, 0, 0]))
    sim.setup_sim()
    single_env_steps(sim)
    arm = franka.ArmState.init(n)
    tool_pos0, tool_quat0 = franka.forward_kinematics(arm.q)[:2]
    gel.write_vertex_positions_to_sim(
        maths.transform_points(jnp.asarray(gel.init_vertex_pos)[None], tool_pos0, tool_quat0))
    for i in range(STEPS):
        delta = jnp.tile(jnp.array([[0.15 if i > 15 else 0.0, 0.0, -0.2 if i <= 15 else 0.0, 0, 0, 0]]), (n, 1)) * 0.05
        arm = franka.apply_delta_pose_ik(arm, delta[:, :3], delta[:, 3:6])
        arm = franka.servo_step(arm, sim.cfg.dt)
        tool_pos, tool_quat = franka.forward_kinematics(arm.q)[:2]
        gel._aim_provider = lambda: att.aim_positions(tool_pos, tool_quat)
        if i == 0:
            sphere0 = jnp.concatenate([tool_pos + jnp.array([0.0, 0.0, -0.012]), jnp.full((n, 1), 0.006)], -1)
        scene = RigidSdfScene(spheres=sphere0[:, None, :], boxes=jnp.zeros((n, 1, 10)),
                              capsules=jnp.zeros((n, 1, 8)), planes=jnp.zeros((n, 1, 4)))
        sim.step(scene)
    return np.asarray(gel.nodal_pos_w)


def test_single_uipc_attachment_matches_jax_scene():
    out = runpy.run_path("examples/single_uipc_attachment_torch.py")["main"](["--steps", str(STEPS), "--device", "cpu"])
    x_j = _jax_single_attachment()
    np.testing.assert_allclose(out["x"], x_j, atol=ATOL, rtol=0)
    assert out["x"].shape == (2, 189, 3)
