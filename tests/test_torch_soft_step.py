"""More steps of the port's soft FEM gel solver against the JAX package:
one CG iteration, the default convergence test, and CCD substeps. The
scene and tolerances are ``test_torch_soft_ipc.py``'s."""

import numpy as np

from _torch_bins import setup_torch
from _torch_soft import step_both
from test_torch_soft_ipc import STEP_ATOL, assert_steps_match

setup_torch()


def test_one_cg_iteration_agrees_to_rounding():
    """With one CG iteration a Newton direction is the preconditioned
    gradient scaled by one Rayleigh quotient: the two solves agree to
    rounding, so the drift at 16 iterations is the CG's amplification of
    it, not a different algorithm."""
    assert_steps_match(1e-7, min_disp=5e-5, velocity_tol=0.0, cg_iters=1)


def test_default_velocity_tol_matches_jax():
    """At the default velocity_tol (0.05 m/s) the solve stops once a Newton
    step's largest vertex rate falls below it. Here the first iteration
    moves the gel ~1e-4 m, a rate of ~6e-3 m/s: clear of the threshold, so
    both sides stop after it (the port's step equals its one-iteration
    solve) and agree."""
    x0, traj = step_both(1, newton_max_iter=1, velocity_tol=0.0, jax_side=False)
    one_iteration = traj[0][1]
    x0, traj = step_both(2)
    xj, xt = traj[0][:2]
    rate = np.abs(xj - x0).max(axis=(1, 2)) * 60.0
    assert (rate < 0.5 * 0.05).all(), rate
    np.testing.assert_array_equal(xt, one_iteration)
    for steps, (xj, xt, vj, vt) in enumerate(traj, 1):
        assert np.abs(xt - xj).max() <= STEP_ATOL, steps
        np.testing.assert_allclose(vt, vj, atol=60.0 * STEP_ATOL * steps)


def test_ccd_substeps_match_jax():
    """``ccd_substeps=2``: two solves at dt/2 against the scene interpolated
    from the previous frame (here the same frame, held)."""
    assert_steps_match(STEP_ATOL, velocity_tol=0.0, ccd_substeps=2)
