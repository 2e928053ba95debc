"""Thread colliders on the port:

  * ``screw_and_nut`` (a 2,922-vertex affine screw driven by a motor inside
    an analytic internal thread, friction on) for 2 steps against the JAX
    scene built as its script builds it (``_torch_abd_examples``): the
    screw's pose within 1.5e-5 (its translation in m, its affine entries
    dimensionless; the sides agree to ~1e-8);
  * one FEM step (``SoftBodyModel.step``) of ``_torch_soft``'s gel pad with
    a thread collider (N, 1, 12) in its scene, pressing the gel, against the
    JAX package's at ``test_torch_soft_ipc.STEP_ATOL``.
"""

import numpy as np
import torch

import jax.numpy as jnp

import _torch_abd_examples as ex
import _torch_soft as S
from _torch_bins import setup_torch
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch.physics.soft import ipc as tipc
from test_torch_soft_ipc import STEP_ATOL

setup_torch()


def test_screw_and_nut_matches_jax_scene():
    out = ex.port("screw_and_nut")
    q_j = ex.jax_screw_and_nut()
    assert out["q"].shape == q_j.shape == (1, 12)
    np.testing.assert_allclose(out["q"], q_j, atol=1.5e-5, rtol=0)
    assert out["overflow"] == {} and np.isfinite(out["dz"])


def test_fem_step_with_a_thread_collider_matches_jax():
    """The gel pad pressed 0.6 / 1.0 mm onto a bolt (an external thread along
    y, its crest 0.2 mm under the gel) in place of the ball, one step at
    velocity_tol = 0."""
    model_j, model_t, step_j = S.models(velocity_tol=0.0)
    x, v, aim, sph, planes = S.press_inputs(model_j)
    sph[..., 3] = 0.0  # no ball
    r_mid, depth = 0.003, 0.0008
    thread = np.zeros((S.N, 1, 12), np.float32)
    thread[:, 0, :3] = S.OFFSET + np.array([0.0, -0.02, -(r_mid + depth / 2) - 0.0002], np.float32)
    thread[:, 0, 3:] = [0.0, 1.0, 0.0, r_mid, depth, 0.002, 0.0, 0.04, 1.0]
    thread[1, 0, 0] += 0.0007
    sj, st = S.scenes(sph, planes)
    sj = jipc.RigidSdfScene(sj.spheres, sj.boxes, sj.capsules, sj.planes, jnp.asarray(thread))
    st = tipc.RigidSdfScene(st.spheres, st.boxes, st.capsules, st.planes, torch.from_numpy(thread))
    x_j = np.asarray(step_j(jipc.SoftBodyState(jnp.asarray(x), jnp.asarray(v)), sj, jnp.asarray(aim)).x)
    x_t = model_t.step(tipc.SoftBodyState(torch.from_numpy(x), torch.from_numpy(v)), st, torch.from_numpy(aim)).x
    d = st.sdf(x_t.index_select(1, model_t.surface_verts))
    assert float(d.min()) > 0 and float(d.min()) < 5e-4  # the gel reached the thread and stayed outside it
    assert np.abs(x_t.numpy() - x).max() > 1e-4
    np.testing.assert_allclose(x_t.numpy(), x_j, atol=STEP_ATOL, rtol=0)

