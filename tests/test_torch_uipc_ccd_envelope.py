"""``scripts/benchmarking/ccd_envelope_torch.py`` on the port against the JAX
script, on the CPU. The script's slab (the JAX script's ``build_model``:
(6, 7, 2) cells hung by the rim) with 2 substeps, its sphere flying down at
0.2 m/s, 2 frames swept from the previous frame's pose (``scene_prev``):
positions within ``_torch_uipc_api.ATOL`` (1.5e-5 m); the slab is pushed
~2 mm and the packages agree to ~5e-8 m. And the script's own rows at one
configuration inside the envelope (0.8 m/s at dt 1/60) and one outside it
(1.6 m/s) against the JAX script's ``run`` (its loop here, on one jitted
step for both velocities): the verdict exactly, the largest
deflection within 5% (1e-3 mm when the slab never reacted). Over a whole
fly-through the deflection's size depends on the frames that start with the
sphere inside the slab, where the no-worsening floor and the energy test
decide on f32 noise (ROADMAP Queue 3); from the third frame at 0.2 m/s the
packages part by up to 1.3 mm.
"""

import functools
import runpy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_uipc_api import ATOL, J, T

setup_torch()

STEPS = 2
CCD = runpy.run_path("scripts/benchmarking/ccd_envelope.py")
CCD_T = runpy.run_path("scripts/benchmarking/ccd_envelope_torch.py")


def test_ccd_envelope_slab_matches_jax():
    dt, vel = 1 / 60, 0.2
    m_j, m_t = CCD["build_model"](dt, 2), CCD_T["build_model"](dt, 2, "cpu")
    aim = m_t.mesh.points[m_t.attachment_verts.numpy()][None]
    z = [CCD["R_SPH"] + CCD["THICK"] / 2 + 2 * CCD["D_HAT"] + 0.002 - vel * dt * i for i in range(STEPS + 1)]
    s_j = J.sim.SoftBodyState.init(1, m_j.mesh.points)
    s_t = T.sim.SoftBodyState.init(1, m_t.mesh.points, device="cpu")
    step_j = jax.jit(lambda s, sc, scp: m_j.step(s, sc, jnp.asarray(aim), scene_prev=scp))
    zt = torch.tensor(np.asarray(z, np.float32))
    for i in range(1, STEPS + 1):
        s_j = step_j(s_j, CCD["sphere_scene"](z[i]), CCD["sphere_scene"](z[i - 1]))
        s_t = m_t.step(s_t, CCD_T["sphere_scene"](zt[i], "cpu"), torch.from_numpy(aim),
                       scene_prev=CCD_T["sphere_scene"](zt[i - 1], "cpu"))
    np.testing.assert_allclose(s_t.x.numpy(), np.asarray(s_j.x), atol=ATOL, rtol=0)
    assert np.abs(s_t.x.numpy()[0] - m_t.mesh.points).max() > 1e-3  # the sphere pushed the slab


@functools.lru_cache(maxsize=None)
def _jax_stepper(dt: float, substeps: int):
    """The JAX script's model and jitted step for (dt, substeps), compiled once
    for every velocity (its ``run`` compiles one per call)."""
    m = CCD["build_model"](dt, substeps)
    aim = jnp.asarray(m.mesh.points[np.asarray(m.attachment_verts)])[None]
    return m, jax.jit(lambda s, sc, scp: m.step(s, sc, aim, scene_prev=scp))


def _jax_row(dt: float, vel: float, substeps: int) -> dict:
    """The JAX script's ``run(dt, vel, substeps)``, line for line, on the shared step."""
    m, step = _jax_stepper(dt, substeps)
    state = J.sim.SoftBodyState.init(1, m.mesh.points)
    x0 = jnp.asarray(m.mesh.points)
    z_start = CCD["R_SPH"] + CCD["THICK"] / 2 + 2 * CCD["D_HAT"] + 0.002
    n_frames = int(np.ceil(2 * z_start / (vel * dt))) + 2
    max_defl, z_prev = 0.0, z_start
    for i in range(1, n_frames + 1):
        z = z_start - vel * dt * i
        state = step(state, CCD["sphere_scene"](z), CCD["sphere_scene"](z_prev))
        z_prev = z
        max_defl = max(max_defl, float(jnp.abs(state.x[0] - x0).max()))
    return {"dt": round(dt, 6), "velocity_mps": vel, "step_disp_mm": round(1e3 * vel * dt, 3), "substeps": substeps,
            "max_deflection_mm": round(1e3 * max_defl, 4), "tunneled": bool(max_defl < 2e-4)}


@pytest.mark.parametrize("vel", [0.8, 1.6], ids=["inside", "outside"])
def test_ccd_envelope_rows_match_jax(vel):
    dt = 1 / 60
    row_t = CCD_T["run"](dt, vel, 1, "cpu")
    row_j = _jax_row(dt, vel, 1)
    assert row_t.keys() == row_j.keys() and row_t["tunneled"] == row_j["tunneled"] == (vel > 1.0)
    defl_t, defl_j = row_t["max_deflection_mm"], row_j["max_deflection_mm"]
    assert abs(defl_t - defl_j) <= max(0.05 * defl_j, 1e-3), (defl_t, defl_j)
    assert {k: row_t[k] for k in ("dt", "velocity_mps", "step_disp_mm", "substeps")} == {
        k: row_j[k] for k in ("dt", "velocity_mps", "step_disp_mm", "substeps")}
