"""``examples/grasp_lift_torch.py`` on the port against the JAX script's
scene on the CPU: two (2, 4, 4) gel pads and a free 15 mm affine cube in
the coupled FEM+ABD world (one dynamic body, so no body-body contact), 2
envs at dt 1/100, 2 steps of the squeeze through ``main(argv)``, against
the JAX script's scene built here as the script builds it (its ``main()``
takes no arguments), at the script's own 8 Newton x 24 CG iterations.
Tolerances: the pads' positions ``_torch_uipc_api.ATOL`` (1.5e-5 m), the
cube's pose 1.5e-5 (``tests/_torch_coupled.py``'s Q_ATOL). The JAX side
traces and compiles its coupled solve once (~20 s on the CPU), as
``_torch_coupled.per_env_step`` in place of the sim's jit of the vmapped
``CoupledModel.step``.
"""

import runpy

import numpy as np

import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_coupled import per_env_step
from _torch_uipc_api import ATOL, J

setup_torch()

STEPS = 2
Q_ATOL = 1.5e-5
SCRIPT = runpy.run_path("examples/grasp_lift_torch.py")


def _jax_scene():
    from tacex_tpu.physics.soft.mesh import box_tet_mesh

    n = 2
    sim = J.UipcSim(J.UipcSimCfg(num_envs=n, dt=1 / 100))
    pads = []
    for sgn in (-1.0, +1.0):
        mesh = box_tet_mesh((0.01, 0.03, 0.03), (2, 4, 4), center=(sgn * 0.0135, 0, 0))
        pad = J.UipcObject(J.UipcObjectCfg(constitution=J.StableNeoHookeanCfg(youngs_modulus=0.1), mass_density=1000.0),
                           sim, mesh=mesh)
        mount = np.where(sgn * mesh.points[:, 0] > 0.0185 - 1e-9)[0].astype(np.int32)
        pad._ctrl = {"mount": mount, "rest": mesh.points[mount].copy(), "sgn": sgn}
        pads.append(pad)
    pts, tris = SCRIPT["cube_surface"]()
    cube = J.UipcObject(J.UipcObjectCfg(constitution=J.AffineBodyConstitutionCfg(m_kappa=100.0, kinematic=False),
                                        mass_density=2000.0), sim, points=pts, triangles=tris)
    ctrl = {"squeeze": 0.0, "lift": 0.0}
    for pad in pads:
        c = pad._ctrl

        def provider(c=c):
            aim = c["rest"] + np.array([-c["sgn"] * ctrl["squeeze"], 0.0, ctrl["lift"]])
            return jnp.broadcast_to(jnp.asarray(aim, jnp.float32), (n,) + aim.shape)

        pad.set_attachments(c["mount"], aim_provider=provider)
    sim.setup_sim()
    assert sim._coupled is not None
    sim._coupled_step_fn = per_env_step(sim._coupled)
    for i in range(STEPS):
        SCRIPT["advance_ctrl"](ctrl, i)
        sim.step()
    return np.concatenate([np.asarray(p.nodal_pos_w) for p in pads], 1), np.asarray(sim.abd_body_pose(cube))


def test_grasp_lift_matches_jax_scene():
    out = SCRIPT["main"](["--steps", str(STEPS), "--device", "cpu"])
    x_j, q_j = _jax_scene()
    np.testing.assert_allclose(out["x"], x_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["q"], q_j, atol=Q_ATOL, rtol=0)
    assert np.abs(out["q"][:, 2]).max() > 0 and out["lift"] == 0.0  # the cube settles into the squeeze
