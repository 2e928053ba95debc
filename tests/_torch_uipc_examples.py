"""Shared scenes of the example parity tests (``test_torch_uipc_examples*``):
the four FEM examples of the UIPC scene API, each at its own envs, mesh and
settings for 2 steps on the CPU:
``hello_uipc`` (one tet on the ground, 4 envs), ``floating_cube`` (a cube
hung from anchors on a circle, 2 envs), ``periodically_pressed_tetrahedron``
(an apex pressed by sin(pi t), 2 envs) and ``falling_gel_cubes`` (a cube
dropped, 4 envs). The port's scripts run in-process through ``main(argv)``
with ``--steps 2 --device cpu``; the JAX scripts' ``main()`` takes no
arguments and runs the full length, so each JAX scene is built here as its
script builds it, its FEM models stepped through ``single_env_steps``.
"""

import runpy

import numpy as np

import jax.numpy as jnp

from _torch_uipc_api import J, single_env_steps

STEPS = 2


def port(path):
    return runpy.run_path(path)["main"](["--steps", str(STEPS), "--device", "cpu"])


def jax_hello():
    sim = J.UipcSim(J.UipcSimCfg(num_envs=4, dt=1 / 60, enable_ground=True))
    points = 0.1 * np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], np.float32) + np.array(
        [0.0, 0.0, 0.15], np.float32)
    tet = J.UipcObject(J.UipcObjectCfg(constitution=J.StableNeoHookeanCfg(youngs_modulus=0.1)), sim, points=points,
                       tets=np.array([[1, 0, 2, 3]], np.int32))
    sim.setup_sim()
    single_env_steps(sim)
    for _ in range(STEPS):
        sim.step()
    return np.asarray(tet.nodal_pos_w)


def jax_floating_cube():
    n, dt = 2, 1 / 60
    sim = J.UipcSim(J.UipcSimCfg(num_envs=n, dt=dt, enable_ground=True))
    cube = J.UipcObject(J.UipcObjectCfg(
        mesh_cfg=J.objects.TetMeshCfg(size=(0.04, 0.04, 0.04), resolution=(3, 3, 3), center=(0, 0, 0.1)),
        constitution=J.StableNeoHookeanCfg(youngs_modulus=0.05)), sim)
    top = np.where(cube.mesh.points[:, 2] > 0.12 - 1e-6)[0].astype(np.int32)
    rest_top = jnp.asarray(cube.mesh.points[top])
    frame = {"i": 0}

    def animate_anchors():
        t = frame["i"] * dt
        off = jnp.array([0.03 * np.sin(t), 0.03 * (1 - np.cos(t)), 0.0], jnp.float32)
        return jnp.broadcast_to(rest_top + off, (n, len(top), 3))

    cube.set_attachments(top, aim_provider=animate_anchors, strength_ratio=200.0)
    sim.setup_sim()
    single_env_steps(sim)
    for i in range(STEPS):
        frame["i"] = i
        sim.step()
    return np.asarray(cube.nodal_pos_w)


def jax_pressed_tet():
    n, dt = 2, 0.02
    sim = J.UipcSim(J.UipcSimCfg(num_envs=n, dt=dt, enable_ground=True,
                                 contact=J.UipcSimCfg.Contact(default_friction_ratio=0.1)))
    points = np.array([[0.0, 0.0, 0.12], [0.08, 0.0, 0.0], [-0.04, 0.06, 0.0], [-0.04, -0.06, 0.0]], np.float32)
    tet = J.UipcObject(J.UipcObjectCfg(constitution=J.StableNeoHookeanCfg(youngs_modulus=0.05)), sim, points=points,
                       tets=np.array([[1, 0, 2, 3]], np.int32))
    frame = {"i": 0}
    rest_apex = jnp.asarray(points[0])

    def animate_apex():
        y = -np.sin(np.pi * frame["i"] * dt) * 0.05
        return jnp.broadcast_to(rest_apex + jnp.array([0.0, 0.0, y]), (n, 1, 3))

    tet.set_attachments(np.array([0]), aim_provider=animate_apex, strength_ratio=100.0)
    sim.setup_sim()
    single_env_steps(sim)
    for i in range(STEPS):
        frame["i"] = i
        sim.step()
    return np.asarray(tet.nodal_pos_w)


def jax_falling_cubes():
    sim = J.UipcSim(J.UipcSimCfg(num_envs=4, dt=1 / 120, enable_ground=True))
    cube = J.UipcObject(J.UipcObjectCfg(
        mesh_cfg=J.objects.TetMeshCfg(size=(0.04, 0.04, 0.04), resolution=(3, 3, 3), center=(0, 0, 0.08)),
        constitution=J.StableNeoHookeanCfg(youngs_modulus=0.05, poisson_rate=0.45)), sim)
    sim.setup_sim()
    single_env_steps(sim)
    for _ in range(STEPS):
        sim.step()
    return np.asarray(cube.nodal_pos_w)
