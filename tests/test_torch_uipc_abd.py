"""The split ABD world of the port's UIPC scene API: affine bodies outside
the coupled world, stepped by ``AbdModel.step``, on ``walking_cube``'s scene
(a free board and a motor-driven cube on it, body-body contact and
friction, 1 env): 2 steps against the JAX scene built as its script builds
it (``_torch_abd_examples``), with the broad phase's ``abd_`` counts;
``step_n`` against per-frame ``step``; save / replay; ``check_health`` on
a diverged affine body.

Tolerance: every vertex within ``_torch_uipc_api.ATOL`` (1.5e-5 m; the two
sides agree to ~1e-8 here). ``step_n`` runs the same per-frame solve as
``step``, so it agrees to 1e-7 m.
"""

import runpy

import numpy as np
import pytest
import torch

import _torch_abd_examples as ex
from _torch_bins import setup_torch
from _torch_uipc_api import ATOL
from tacex_tpu_torch.physics.soft.abd import AbdState

setup_torch()

SCRIPT = "examples/libuipc_samples/walking_cube_torch.py"


def test_walking_cube_split_world_matches_jax():
    out = ex.port("walking_cube")
    x_j, overflow_j = ex.jax_walking_cube()
    assert out["x"].shape == x_j.shape == (1, 16, 3)
    np.testing.assert_allclose(out["x"], x_j, atol=ATOL, rtol=0)
    assert sorted(out["overflow"]) == sorted(overflow_j) == ["abd_ee", "abd_vt_body"]
    assert {k: v.tolist() for k, v in out["overflow"].items()} == {k: v.tolist() for k, v in overflow_j.items()}
    assert np.isfinite(out["x"]).all() and out["ms_per_step"] > 0


def test_step_n_save_and_replay():
    sim, board, cube = runpy.run_path(SCRIPT)["build"]("cpu")
    frame = sim.save_frame()
    for _ in range(2):
        sim.step()
    q_steps, aim_steps = sim._abd_state.q.clone(), sim._abd_aim_q.clone()
    x_cube = cube.nodal_pos_w.clone()
    assert float((x_cube - torch.from_numpy(cube.init_vertex_pos)).abs().max()) > 1e-4
    sim.replay_frame(frame)
    np.testing.assert_array_equal(cube.nodal_pos_w.numpy(), cube.init_vertex_pos[None])
    sim.step_n(2)
    np.testing.assert_allclose(sim._abd_state.q.numpy(), q_steps.numpy(), atol=1e-7, rtol=0)
    np.testing.assert_allclose(sim._abd_aim_q.numpy(), aim_steps.numpy(), atol=1e-7, rtol=0)
    assert sim._frame_counter == 2 and frame in sim._frames
    # the snapshot kept its values while the live state moved on
    sim.replay_frame(frame)
    assert float(sim._abd_state.q.sub(q_steps).abs().max()) > 1e-4


def test_check_health_names_a_diverged_affine_body():
    sim, board, cube = runpy.run_path(SCRIPT)["build"]("cpu")
    st = sim._abd_state
    q = st.q.clone()
    q[0, 1, 0] = float("nan")
    sim._abd_state = AbdState(q=q, qd=st.qd)
    with pytest.raises(FloatingPointError, match=r"soft body 0 diverged .* envs \[0\]"):
        sim.check_health()
