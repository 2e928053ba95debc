"""The sensor-only demos of the port against the JAX calls their JAX
counterparts make, on the same numpy inputs:

  * ``render_library`` (``check_taxim_sim_torch.py``) on six library shapes
    at 48x64 against ``check_taxim_sim.py``'s one ``render``, under the bin
    rule of ``_torch_bins`` with the Factory fingers' noise floor (tan 1e-4)
    and "near a bin edge" widened to ``SEAM_BINS``: beside the cube's
    straight edge the gradient is ~3e-5 along one axis and float noise
    (~1e-8) across it, so its direction moves by ~3e-4 rad between two blur
    orders, and on the +-pi seam of the direction axis the sign of that noise
    picks the first or the last direction bin;
  * ``fots_cases`` (``check_fots_sim_torch.py``) against
    ``check_fots_sim.py``'s deformation and four ``marker_motion`` calls, at
    48x64 and at the demo's 240x320, within 1e-5 px and one f32 spacing of
    the coordinate (the final sum's rounding: 1.5e-5 px past 128 px); the
    cases' shear and centres lie away from FOTS's int-truncation steps;
  * ``ManiSkillSimulator.marker_motion_simulation`` against JAX's on one
    displaced gel state, with JAX's draws for its key injected into the
    port, compared as sets of markers as ``test_torch_uipc_embedded.py``
    does.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, lut_spread, setup_torch
from _torch_uipc import marker_sets
from tacex_tpu.assets.shapes import shape_height_map
from tacex_tpu.sensors.gelsight import taxim as jtx
from tacex_tpu.sensors.gelsight.fem import ManiSkillSimulatorCfg as JCfg
from tacex_tpu.sensors.gelsight.fem.mani_skill_sim import ManiSkillSimulator as JSim
from tacex_tpu.sensors.gelsight.fots import marker_motion as jfots
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu.physics.soft.ipc import SoftBodyState as JState
from tacex_tpu_torch.physics.soft.ipc import SoftBodyState
from tacex_tpu_torch.physics.soft.mesh import box_tet_mesh
from tacex_tpu_torch.sensors.gelsight import taxim as ttx
from tacex_tpu_torch.sensors.gelsight.fem import ManiSkillSimulatorCfg
from tacex_tpu_torch.sensors.gelsight.fem.mani_skill_sim import ManiSkillSimulator
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical

setup_torch()

DEMOS = Path(__file__).resolve().parents[1] / "scripts" / "demos"
SMALL = (48, 64)
SHAPES = ["sphere_small", "sphere_medium", "cube_edge", "cross", "ring", "wave_ridges"]
MARKER_ATOL = 1e-5
MARKER_RTOL = float(np.finfo(np.float32).eps)
SEAM_BINS = 1e-3


@pytest.fixture(scope="module")
def calibs():
    return jtx.load_calib(), ttx.load_calib()


def _script(name):
    return runpy.run_path(str(DEMOS / name))


def test_render_library_matches_jax(calibs):
    cal_j, cal_t = calibs
    render_library = _script("check_taxim_sim_torch.py")["render_library"]
    press = 1.0
    rgb_t = render_library(cal_t, SHAPES, SMALL, press, False, "cpu").numpy()
    # check_taxim_sim.py:40-43
    cal_js = cal_j.at_resolution(SMALL)
    hms = np.stack([shape_height_map(n, SMALL) for n in SHAPES])
    pd = jnp.full((len(SHAPES),), press)
    rgb_j = np.asarray(jtx.render(cal_js, jnp.asarray(hms), press_depth=pd, with_shadow=False))
    assert rgb_t.shape == rgb_j.shape == (len(SHAPES),) + SMALL + (3,)

    # the bins of both sides, for the bin rule
    cal_ts = cal_t.at_resolution(SMALL)
    d_t, _ = toptical.compute_gel_deformation(cal_ts, toptical.shift_height_map(torch.from_numpy(hms),
                                                                                torch.full((len(SHAPES),), press)))
    gm_t, gd_t = toptical.generate_normals(cal_ts, -d_t / cal_ts.sensor_params.pixmm)
    d_j, _ = joptical.compute_gel_deformation(cal_js, joptical.shift_height_map(jnp.asarray(hms), pd))
    gm_j, gd_j = (np.asarray(g) for g in joptical.generate_normals(cal_js, -d_j / cal_js.sensor_params.pixmm))
    nb = cal_ts.sensor_params.num_bins
    x_binr, y_binr = np.float32(0.5 * np.pi / (nb - 1)), np.float32(2.0 * np.pi / (nb - 1))
    bins_j = [np.clip(np.floor(gm_j / x_binr), 0, nb - 1), np.clip(np.floor((gd_j + np.float32(np.pi)) / y_binr), 0, nb - 1)]
    bins_t = [b.numpy() for b in toptical.lut_bins(cal_ts, gm_t, gd_t)]
    spread = lut_spread(cal_ts.poly_lut.numpy(), cal_ts.features.numpy(), nb)
    held = assert_bin_rule(rgb_t, rgb_j, gm_j, gd_j, nb, spread, bins_t=bins_t, bins_j=bins_j, edge_bins=SEAM_BINS,
                           noise_floor=FINGER_NOISE_FLOOR)
    assert held > 0.3
    # every shape pressed in: each image differs from the background somewhere
    assert (np.abs(rgb_j - rgb_j[:, :1, :1]).reshape(len(SHAPES), -1).max(-1) > 0.05).all()


@pytest.mark.parametrize("res", [SMALL, (240, 320)], ids=["48x64", "240x320"])
def test_fots_cases_match_jax(calibs, res):
    cal_j, cal_t = calibs
    demo = _script("check_fots_sim_torch.py")
    cases_t = demo["fots_cases"](cal_t, res, "cpu")
    cfg_t = demo["marker_cfg"](res)

    # check_fots_sim.py:40-66, with the demo's grid margins at res
    cal_js = cal_j.at_resolution(res)
    cfg = jfots.FOTSMarkerCfg(num_markers_row=9, num_markers_col=11, x0=cfg_t.x0, y0=cfg_t.y0,
                              tactile_img_width=res[1], tactile_img_height=res[0], mm_to_pixel=cfg_t.mm_to_pixel)
    if res == (240, 320):
        assert cfg == jfots.FOTSMarkerCfg(num_markers_row=9, num_markers_col=11, x0=15, y0=26)
    init_m = jfots.init_marker_grid(cfg)
    hm = shape_height_map("sphere_medium", res)
    hm_p = jnp.asarray(hm[None]) - hm.min() - 1.2
    deformed, mask = joptical.compute_gel_deformation(cal_js, hm_p)
    depth = deformed.max(axis=(-2, -1), keepdims=True) - deformed
    assert list(cases_t) == list(demo["CASES"]) == ["press", "shear", "twist", "shear+twist"]
    moved = {}
    for name, (t0, t1, valid) in demo["CASES"].items():
        m_j = np.asarray(jfots.marker_motion(cfg, depth, mask, jnp.asarray([t0]), jnp.asarray([t1]),
                                             jnp.asarray([valid]), init_m))
        m_t = cases_t[name].numpy()
        assert m_t.shape == m_j.shape == (1, 99, 2)
        np.testing.assert_allclose(m_t, m_j, atol=MARKER_ATOL, rtol=MARKER_RTOL, err_msg=name)
        moved[name] = float(np.abs(m_j - np.asarray(init_m)).max())
    assert moved["press"] > 0.1 and min(moved.values()) == moved["press"]


def _displaced(points: np.ndarray, n: int) -> np.ndarray:
    """A press in env 0, a press with a shear in x in env 1: (n, V, 3)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    bump = np.exp(-(x ** 2 + y ** 2) / (2 * 0.003 ** 2)) * (z > -1e-9)
    out = np.repeat(points[None], n, 0).astype(np.float32)
    out[:, :, 2] -= 0.0008 * bump
    out[1, :, 0] += 0.0006 * bump
    return out


def test_mani_skill_marker_flow_matches_jax_as_sets():
    size = (0.018, 0.014, 0.004)
    mesh = box_tet_mesh(size, (8, 7, 2), center=(0.0, 0.0, -size[2] / 2))  # check_mani_skill_marker.py's gel
    sim_t = ManiSkillSimulator(ManiSkillSimulatorCfg(), mesh, device="cpu")
    sim_j = JSim(JCfg(), mesh)
    m = sim_t.flow_gen.num_bound
    assert m == sim_j.flow_gen.num_bound > 50
    n = 2
    x = _displaced(mesh.points, n)
    cam_pos = np.broadcast_to(np.array([0.0, 0.0, -0.0285], np.float32), (n, 3)).copy()
    cam_quat = np.broadcast_to(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 4)).copy()
    surf = np.asarray(mesh.surface_verts)

    key = jax.random.PRNGKey(3)
    flow_j = np.asarray(sim_j.marker_motion_simulation(JState(x=jnp.asarray(x), v=jnp.zeros_like(x)), surf,
                                                       jnp.asarray(cam_pos), jnp.asarray(cam_quat), key))
    # the draws JAX's FemMarkerFlow.flow takes from its key
    k_drop, k_noise, k_sample = jax.random.split(key, 3)
    draws = {
        "keep": torch.from_numpy(np.array(jax.random.uniform(k_drop, (n, m)))),
        "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, (n, 2, m, 2)))),
        "score": torch.from_numpy(np.array(jax.random.uniform(k_sample, (n, m)))),
    }
    state = SoftBodyState(x=torch.from_numpy(x), v=torch.zeros(x.shape))
    flow_t = sim_t.marker_motion_simulation(state, torch.from_numpy(surf.astype(np.int64)),
                                            torch.from_numpy(cam_pos), torch.from_numpy(cam_quat), draws=draws)
    assert flow_t.shape == flow_j.shape == (n, 2, 128, 2)
    sets_j, sets_t = marker_sets(flow_j), marker_sets(flow_t.numpy())
    assert sets_t.shape == sets_j.shape and sets_j.shape[1] == m
    np.testing.assert_allclose(sets_t[..., :2], sets_j[..., :2], atol=1e-3)
    np.testing.assert_allclose(sets_t[..., 2:], sets_j[..., 2:], atol=1e-3)
    assert np.abs(sets_j[..., 2:] - sets_j[..., :2]).max() > 1.0, "no marker moved under the press"
    # the same draws from a generator give a flow of the same markers' kind
    g = torch.Generator().manual_seed(0)
    assert sim_t.marker_motion_simulation(state, torch.from_numpy(surf.astype(np.int64)), torch.from_numpy(cam_pos),
                                          torch.from_numpy(cam_quat), g).shape == (n, 2, 128, 2)
