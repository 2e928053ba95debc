"""Shared scenes of the ABD sample parity tests (``test_torch_abd_examples*``):
the four affine-body samples of the UIPC scene API for 2 steps on the CPU:
``ramp_sliding`` (a cube flush on a ramp, one scene for each friction
ratio), ``walking_cube`` (a motor-driven cube on a free board),
``wrecking_balls`` (a 2x2 brick wall and two balls) and ``screw_and_nut``
(a motor-driven screw in an analytic nut thread). The port's scripts run
in-process through ``main(argv)`` with ``--steps 2 --device cpu``; the JAX
scripts' ``main()`` takes no arguments and runs the full length, so each
JAX scene is built here as its script builds it (the screw's mesh, nut row
and assembly phase come from the JAX script itself), and its ABD model
stepped by ``_torch_abd.per_env_abd_step`` in place of the sim's jit of
the vmapped ``AbdModel.step`` (``setup``): the same function, ~5 s less to
trace.
"""

import runpy

import numpy as np

import jax.numpy as jnp

from tacex_tpu.assets.meshes import box_mesh, icosphere, weld_soup
from tacex_tpu.physics.soft.ipc import RigidSdfScene

from _torch_abd import per_env_abd_step
from _torch_uipc_api import J

STEPS = 2
SAMPLES = "examples/libuipc_samples/"


def setup(sim):
    """``sim.setup_sim()``, then its ABD model stepped by ``per_env_abd_step``."""
    sim.setup_sim()
    sim._abd_step_fn = per_env_abd_step(sim._abd_model)


def port(name):
    return runpy.run_path(f"{SAMPLES}{name}_torch.py")["main"](["--steps", str(STEPS), "--device", "cpu"])


def jax_ramp(mu: float, tilt: float = 0.35) -> np.ndarray:
    n_vec = np.array([-np.sin(tilt), 0.0, np.cos(tilt)], np.float32)
    sim = J.UipcSim(J.UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=False, contact=J.UipcSimCfg.Contact(
        default_friction_ratio=mu, d_hat=0.002, resistance=1e4)))
    half = 0.02
    p, t = weld_soup(box_mesh(half, half, half))
    R = np.array([[np.cos(-tilt), 0.0, np.sin(-tilt)], [0.0, 1.0, 0.0], [-np.sin(-tilt), 0.0, np.cos(-tilt)]],
                 np.float32)
    p = p @ R.T + (half + 0.0015) * n_vec
    cube = J.UipcObject(J.UipcObjectCfg(constitution=J.objects.AffineBodyConstitutionCfg(m_kappa=100.0)), sim,
                        points=p.astype(np.float32), triangles=t)
    setup(sim)
    ramp = RigidSdfScene.empty(1)
    ramp = RigidSdfScene(ramp.spheres, ramp.boxes, ramp.capsules, ramp.planes.at[0, 0].set(jnp.asarray([*n_vec, 0.0])))
    for _ in range(STEPS):
        sim.step(ramp)
    return np.asarray(cube.nodal_pos_w)


def jax_walking_cube():
    """(every vertex (1, V, 3), broad_phase_overflow) after the steps."""
    sim = J.UipcSim(J.UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=True, newton=J.UipcSimCfg.Newton(max_iter=8),
                                 contact=J.UipcSimCfg.Contact(default_friction_ratio=0.5, d_hat=0.002,
                                                              resistance=1e4)))
    abd = J.objects.AffineBodyConstitutionCfg
    bp, bt = weld_soup(box_mesh(0.15, 0.08, 0.01))
    board = J.UipcObject(J.UipcObjectCfg(constitution=abd(m_kappa=10.0), mass_density=500.0), sim,
                         points=bp + np.array([0.0, 0.0, 0.0125], np.float32), triangles=bt)
    cp, ct = weld_soup(box_mesh(0.04, 0.04, 0.04))
    cube = J.UipcObject(J.UipcObjectCfg(constitution=abd(m_kappa=100.0)), sim,
                        points=cp + np.array([-0.08, 0.0, 0.068], np.float32), triangles=ct)
    cube.set_rotating_motor(axis=(0.0, 1.0, 0.0), rot_vel=0.5 * np.pi, strength=300.0)
    setup(sim)
    for _ in range(STEPS):
        sim.step()
    return np.concatenate([np.asarray(board.nodal_pos_w), np.asarray(cube.nodal_pos_w)], 1), sim.broad_phase_overflow()


def jax_wrecking_balls():
    """(every vertex (1, V, 3), broad_phase_overflow) after the steps."""
    sim = J.UipcSim(J.UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=True, contact=J.UipcSimCfg.Contact(
        default_friction_ratio=0.5, d_hat=0.004, resistance=1e4)))
    abd = J.objects.AffineBodyConstitutionCfg(m_kappa=10.0)
    half = 0.05
    bodies = []
    for ix in range(2):
        for iz in range(2):
            p, t = weld_soup(box_mesh(half, half, half))
            off = np.array([(-0.06 + 0.12 * ix), 0.0, half + 0.004 + iz * (2 * half + 0.006)], np.float32)
            bodies.append(J.UipcObject(J.UipcObjectCfg(constitution=abd), sim, points=p + off, triangles=t))
    for ib in range(2):
        p, t = weld_soup(icosphere(0.05, 1))
        off = np.array([(-0.05 + 0.1 * ib), 0.01, 0.45 + 0.14 * ib], np.float32)
        bodies.append(J.UipcObject(J.UipcObjectCfg(constitution=abd), sim, points=p + off, triangles=t))
    setup(sim)
    for _ in range(STEPS):
        sim.step()
    return np.concatenate([np.asarray(b.nodal_pos_w) for b in bodies], 1), sim.broad_phase_overflow()


def jax_screw_and_nut() -> np.ndarray:
    script = runpy.run_path(f"{SAMPLES}screw_and_nut.py")
    sim = J.UipcSim(J.UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=False, newton=J.UipcSimCfg.Newton(max_iter=8),
                                 contact=J.UipcSimCfg.Contact(friction=True, default_friction_ratio=0.5,
                                                              d_hat=0.0004, resistance=2e4)))
    sp, st = script["screw_mesh"]()
    screw = J.UipcObject(J.UipcObjectCfg(constitution=J.objects.AffineBodyConstitutionCfg(m_kappa=100.0)), sim,
                         points=sp, triangles=st)
    screw.set_rotating_motor(axis=(0.0, 0.0, 1.0), rot_vel=-np.pi, strength=2000.0)
    setup(sim)
    bz = script["assemble_phase"](sp)
    sc = RigidSdfScene.empty(1)
    scene = RigidSdfScene(sc.spheres, sc.boxes, sc.capsules, sc.planes,
                          threads=jnp.asarray(script["nut_thread"](bz))[None])
    for _ in range(STEPS):
        sim.step(scene)
    return np.asarray(sim.abd_body_pose(screw))
