"""One step of the port's standalone ABD solve (``AbdModel.step``) against
the JAX package's, on ``_torch_abd``'s two-cube stack (env 0) and four-cube
pile (env 1): the dense Newton solve (the full (12B, 12B) Hessian) and the
CG one, with body-body vertex-triangle and edge-edge contact, scene and
pair friction; and the envs' independence.

Tolerances, each about the step's response to a 1e-7 jolt of its input
(measured on both packages): the dense step's q 1e-5 (its translation in
m, its affine entries dimensionless) against ~1.5 cm of motion, differing
by ~3e-6, the response ~2.5e-6; the CG step's q 1e-4, differing by
~2.3e-5, the response 4e-5 to 8e-5 (3 CG iterations on barrier curvatures
up to ~1e6 amplify f32 rounding, ROADMAP Queue 3); velocities those over
dt.
"""

import numpy as np
import pytest
import torch

import _torch_abd as A
from _torch_bins import setup_torch
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import ipc as tipc

setup_torch()

ATOL = {"dense": 1e-5, "cg": 1e-4}


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_step_matches_jax(solver):
    q, qd = A.state()
    q_j, qd_j = A.jax_step(q, qd, linear_solver=solver)
    q_t, qd_t = A.port_step(q, qd, linear_solver=solver)
    assert np.abs(q_t - q).max() > 50 * ATOL[solver]  # the bodies moved
    np.testing.assert_allclose(q_t, q_j, atol=ATOL[solver], rtol=0)
    np.testing.assert_allclose(qd_t, qd_j, atol=ATOL[solver] / 0.01, rtol=0)
    # the stack's and the pile's lowest bodies stay above the ground
    _, model_t, _ = A.models(linear_solver=solver)
    assert (A.port_scene().sdf(model_t.world_points(torch.from_numpy(q_t))) > 0).all()


def test_envs_are_independent():
    """Swapping the two envs swaps their results, and one env stepped alone
    gives its result in the batch (dense solve)."""
    q, qd = A.state()
    q_t, qd_t = A.port_step(q, qd)
    q_s, qd_s = A.port_step(q[::-1].copy(), qd[::-1].copy())
    np.testing.assert_allclose(q_s[::-1], q_t, atol=1e-7, rtol=0)
    np.testing.assert_allclose(qd_s[::-1], qd_t, atol=1e-5, rtol=0)
    _, model_t, _ = A.models()
    sc = A.port_scene()
    one = tipc.RigidSdfScene(sc.spheres[1:], sc.boxes[1:], sc.capsules[1:], sc.planes[1:])
    st = model_t.step(tabd.AbdState(torch.from_numpy(q[1:]), torch.from_numpy(qd[1:])), one)
    np.testing.assert_allclose(st.q.numpy(), q_t[1:], atol=1e-7, rtol=0)
