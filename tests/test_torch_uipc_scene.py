"""``UipcInteractiveScene`` on the port against the JAX package's, on the
scene of ``tests/test_uipc_api.py::TestInteractiveScene``: the Franka
articulation, a 20 x 25 x 4.5 mm gel of (4, 5, 2) cells falling from 5 cm
onto the ground, a free 5 mm ball on the ground below it (two-way coupled
through the gel's barrier reaction) and a GelSight Mini sensor at 32 x 24,
two envs at dt 1/120 and 4 Newton x 12 CG iterations. After 2 updates the
gel's positions are held to JAX within ``_torch_uipc_api.ATOL`` (1.5e-5 m)
and the ball's within 1e-6 m; then the scene resets and is looked up by
name. From the third update on, the falling gel's line search accepts or
rejects steps whose energy decrease is at the f32 resolution of its
elastic energy, a float-noise decision (ROADMAP Queue 3) on which the two
packages part by up to 1.6 mm.
"""

import numpy as np
import pytest
import torch

from _torch_bins import setup_torch
from _torch_uipc_api import ATOL, J, T, numpy
from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor

setup_torch()

UPDATES = 2


def _scene(M):
    from tacex_tpu.assets import robots as jrobots
    from tacex_tpu.sensors.gelsight.sensor_cfg import gelsight_mini_cfg as jcfg
    from tacex_tpu_torch.assets import robots as trobots
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg as tcfg

    jax_side = M is J
    robots, sensor_cfg = (jrobots, jcfg) if jax_side else (trobots, tcfg)
    sim_cfg = M.UipcSimCfg(num_envs=2, dt=1 / 120, enable_ground=True,
                           newton=M.UipcSimCfg.Newton(max_iter=4),
                           linear_system=M.UipcSimCfg.LinearSystem(max_iter=12))
    cfg = M.UipcInteractiveSceneCfg(num_envs=2, uipc_sim=sim_cfg)
    entities = {
        "robot": robots.FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_CFG,
        "gel": M.UipcObjectCfg(
            mesh_cfg=M.objects.TetMeshCfg(size=(0.02, 0.025, 0.0045), resolution=(4, 5, 2), center=(0, 0, 0.05)),
            constitution=M.StableNeoHookeanCfg(),
        ),
        "ball": M.RigidObjectCfg(shape="sphere", size=(0.005,), init_pos=(0, 0, 0.03)),
        "gsmini": sensor_cfg(camera_resolution=(32, 24)),
    }
    return M.UipcInteractiveScene(cfg, entities=entities) if jax_side else M.UipcInteractiveScene(
        cfg, entities=entities, device="cpu")


def test_build_update_reset_lookup_match_jax():
    out = {}
    for M in (J, T):
        scene = _scene(M)
        scene.setup()
        assert sorted(scene.keys()) == ["ball", "gel", "gsmini", "robot"]
        z0 = float(scene["gel"].root_pos_w[0, 2])
        for _ in range(UPDATES):
            scene.update()
        assert float(scene["gel"].root_pos_w[0, 2]) < z0  # the gel fell a bit
        out[M] = numpy(scene["gel"].nodal_pos_w), numpy(scene["ball"].pos), numpy(scene["ball"].lin_vel)
    np.testing.assert_allclose(out[T][0], out[J][0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[T][1], out[J][1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(out[T][2], out[J][2], atol=1e-6 * 120, rtol=0)
    assert scene["robot"].joint_pos.shape == (2, 9)
    assert isinstance(scene["gsmini"], GelSightSensor) and scene.sensor_state("gsmini") is not None
    scene.reset()
    np.testing.assert_allclose(scene["ball"].pos[0].numpy(), [0, 0, 0.03])
    np.testing.assert_allclose(scene["gel"].nodal_pos_w[1].numpy(), scene["gel"].init_vertex_pos, atol=0)
    with pytest.raises(KeyError):
        scene["nope"]


def test_rigid_primitives_join_the_scene():
    """Box and plane entities append to the colliders a step sees; a kinematic
    sphere stays put."""
    cfg = T.UipcInteractiveSceneCfg(num_envs=2)
    scene = T.UipcInteractiveScene(cfg, entities={
        "box": T.RigidObjectCfg(shape="box", size=(0.01, 0.02, 0.03), init_pos=(0.1, 0, 0)),
        "floor": T.RigidObjectCfg(shape="plane", size=(0.0, 0.0, 1.0, -0.01)),
        "peg": T.RigidObjectCfg(shape="sphere", size=(0.004,), kinematic=True),
    }, device="cpu")
    scene.setup()
    sc = T.sim.RigidSdfScene.empty(2, device="cpu")
    for name in ("box", "floor", "peg"):
        sc = scene[name].as_scene_collider(sc)
    assert sc.boxes.shape == (2, 2, 10) and sc.planes.shape == (2, 2, 4) and sc.spheres.shape == (2, 2, 4)
    np.testing.assert_allclose(sc.boxes[0, 1].numpy(), [0.1, 0, 0, 1, 0, 0, 0, 0.01, 0.02, 0.03])
    scene.update()
    assert torch.equal(scene["peg"].pos, torch.zeros((2, 3)))
