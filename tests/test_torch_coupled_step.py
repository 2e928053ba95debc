"""One ``CoupledModel.step`` of 2 envs, port against the JAX package, and the
envs' independence in the port's batched solve.

The scene is ``_torch_coupled.scene``: the Grasp-Lift pads pressed 0.4 mm
from the cube by hand, both solvers at the reduced iterations of
``_torch_coupled`` (2 Newton x 8 CG x 8 line-search trials) and
``velocity_tol = 0``. Tolerances: gel positions ``GEL_ATOL`` = 1.5e-5 m (the
drift of two f32 CG solves), the cube's q ``Q_ATOL``, velocities those over
dt; the envs' independence exactly (an env's result does not change by a
bit when another env's inputs do).
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from _torch_bins import setup_torch
from _torch_coupled import GEL_ATOL, N, Q_ATOL, scene
from tacex_tpu.physics.soft import abd as jabd
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import ipc as tipc

setup_torch()

T = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731


def _step_t(env_t, x, v, q, qd, aim):
    return env_t.world.step(tipc.SoftBodyState(T(x), T(v)), tabd.AbdState(T(q), T(qd)), env_t.scene, aim_pos=T(aim))


def test_one_solve_matches_jax():
    env_j, env_t, (x, v, q, qd, aim, _) = scene()
    assert env_j.world.fem.cfg.velocity_tol == env_t.world.fem.cfg.velocity_tol == 0.0
    assert env_t.world.fem.cfg.newton_max_iter == 2 and env_t.world.fem.cfg.cg_iters == 8
    # the JAX world's step, jitted (``_torch_coupled._share_world``)
    gel_j, cube_j = env_j.world.step(jipc.SoftBodyState(jnp.asarray(x), jnp.asarray(v)),
                                     jabd.AbdState(jnp.asarray(q), jnp.asarray(qd)), env_j.scene,
                                     aim_pos=jnp.asarray(aim))
    gel_t, cube_t = _step_t(env_t, x, v, q, qd, aim)
    dt = env_t.world.fem.cfg.dt
    disp = np.abs(np.asarray(gel_j.x) - x).max((1, 2))
    assert (disp > 1e-4).all(), disp
    np.testing.assert_allclose(gel_t.x.numpy(), np.asarray(gel_j.x), atol=GEL_ATOL, rtol=0)
    np.testing.assert_allclose(gel_t.v.numpy(), np.asarray(gel_j.v), atol=GEL_ATOL / dt, rtol=0)
    np.testing.assert_allclose(cube_t.q.numpy(), np.asarray(cube_j.q), atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(cube_t.qd.numpy(), np.asarray(cube_j.qd), atol=Q_ATOL / dt, rtol=0)
    assert np.abs(np.asarray(cube_j.q) - q).max() > 1e-5, "the cube did not move"


def test_envs_do_not_mix():
    """Env 1 pressed harder, its gel jolted and its cube turned: env 0's
    result is bit for bit the same, and env 1's is not."""
    env_j, env_t, (x, v, q, qd, aim, _) = scene()
    gel_a, cube_a = _step_t(env_t, x, v, q, qd, aim)
    x2, v2, q2, aim2 = x.copy(), v.copy(), q.copy(), aim.copy()
    aim2[1, :, 0] *= 0.999
    x2[1] += 1e-5
    v2[1] *= -1.0
    q2[1, 0, 3:] *= 1.001
    gel_b, cube_b = _step_t(env_t, x2, v2, q2, qd, aim2)
    for a, b in ((gel_a.x, gel_b.x), (gel_a.v, gel_b.v), (cube_a.q, cube_b.q), (cube_a.qd, cube_b.qd)):
        assert torch.equal(a[0], b[0])
        assert not torch.equal(a[1], b[1])


def test_step_raises_for_inputs_that_require_grad():
    _, env_t, (x, v, q, qd, aim, _) = scene()
    gel = tipc.SoftBodyState(T(x).requires_grad_(True), T(v))
    try:
        env_t.world.step(gel, tabd.AbdState(T(q), T(qd)), env_t.scene, aim_pos=T(aim))
    except RuntimeError as e:
        assert "no gradient" in str(e)
    else:
        raise AssertionError("CoupledModel.step took an input that requires grad")
    with torch.no_grad():
        out = env_t.world.step(dataclasses.replace(gel), tabd.AbdState(T(q), T(qd)), env_t.scene, aim_pos=T(aim))
    assert out[0].x.shape == (N,) + x.shape[1:]
