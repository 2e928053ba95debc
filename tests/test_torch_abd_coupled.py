"""The coupled FEM+ABD world with body-body contact: one step of the port's
``CoupledModel`` against the JAX package's, with a 40 x 40 x 4 mm gel pad
of (3, 3, 1) cells lying on a ground plane and two 2 cm affine cubes
stacked on it (the lower 0.5 mm over the gel, the upper 0.5 mm over the
lower, both turned by seeded 10-20 mrad rotations and falling at 5 cm/s),
2 envs, with the ABD model's body-body vertex-triangle pairs in the joint
energy, the floors and the crossing tests (``contact_k = 8``), and the
broad-phase counts with their ``abd_`` keys.

The JAX step is ``_torch_coupled.per_env_step`` (one jit of
``CoupledModel._step_single``, called env by env). Solver: dt 0.01, d_hat 1 mm, kappa 1e4, friction 0.3, 2 Newton x 2 CG x 8
line-search iterations, the convergence stop off (ROADMAP Queue 3). Both
packages mesh the gel with the numpy mesher (the same triangle order).

Tolerances: gel positions ``_torch_coupled.GEL_ATOL`` (1.5e-5 m, the drift
of two f32 CG solves); the cubes' q 1e-4 (m, and dimensionless for the
affine entries) against ~4 mm of motion: a 1e-7 jolt of the input moves
the step's q by ~5e-5 on either package (the stacked cubes' barriers
amplify f32 rounding through CG; the two sides differ by ~3e-5), and
velocities that over dt.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import _torch_abd as A
from _torch_bins import setup_torch
from _torch_coupled import GEL_ATOL, per_env_step
from tacex_tpu.physics.soft import abd as jabd
from tacex_tpu.physics.soft import coupled as jcoupled
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import coupled as tcoupled
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh

setup_torch()

N = 2
GEL = dict(size=(0.04, 0.04, 0.004), resolution=(3, 3, 1), center=(0.0, 0.0, 0.0021))
HALF = 0.01
Q_TOL = 1e-4


def _cfgs(module_ipc, module_abd):
    fem = module_ipc.IpcSolverCfg(dt=0.01, newton_max_iter=2, cg_iters=2, line_search_iters=8, d_hat=1e-3, kappa=1e4,
                                  friction_mu=0.3, velocity_tol=0.0)
    abd = module_abd.AbdSolverCfg(dt=0.01, d_hat=1e-3, kappa_contact=1e4, friction_mu=0.3, contact_k=8,
                                  velocity_tol=0.0)
    return fem, abd


@functools.lru_cache(maxsize=None)
def _worlds():
    P, T = A.cube(HALF)
    fem_j, abd_j = _cfgs(jipc, jabd)
    world_j = jcoupled.CoupledModel(jipc.SoftBodyModel(jmesh.box_tet_mesh(**GEL, use_native=False), cfg=fem_j),
                                    jabd.AbdModel([P, P], [T, T], cfg=abd_j))
    fem_t, abd_t = _cfgs(tipc, tabd)
    world_t = tcoupled.CoupledModel(
        tipc.SoftBodyModel(tmesh.box_tet_mesh(**GEL), cfg=fem_t, device="cpu"),
        tabd.AbdModel([P, P], [T, T], cfg=abd_t, device="cpu"),
    )
    return world_j, world_t


def _inputs():
    """numpy (x, q, qd) of the start state and the ground plane (N, 1, 4)."""
    rng = np.random.default_rng(4)
    pts = tmesh.box_tet_mesh(**GEL).points
    x = (pts[None] + rng.normal(0, 2e-5, (N,) + pts.shape)).astype(np.float32)
    q = np.zeros((N, 2, 12), np.float32)
    for e in range(N):
        for b in range(2):
            q[e, b, 3:] = A._rotation(rng.normal(size=3), rng.uniform(0.01, 0.02)).reshape(-1)
            q[e, b, :2] = rng.uniform(-0.001, 0.001, 2)
            q[e, b, 2] = 0.0041 + 0.0005 + HALF + b * (2 * HALF + 0.0005)
    qd = np.zeros_like(q)
    qd[..., 2] = -0.05
    plane = np.tile(np.array([0.0, 0.0, 1.0, 0.0], np.float32), (N, 1, 1))
    return x, q, qd, plane


def test_coupled_step_with_body_body_contact_matches_jax():
    world_j, world_t = _worlds()
    x, q, qd, plane = _inputs()
    sc_j = jipc.RigidSdfScene.empty(N)
    sc_j = jipc.RigidSdfScene(sc_j.spheres, sc_j.boxes, sc_j.capsules, jnp.asarray(plane))
    fem_j, abd_j = per_env_step(world_j)(jipc.SoftBodyState(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x))),
                                         jabd.AbdState(jnp.asarray(q), jnp.asarray(qd)), sc_j)
    sc_t = tipc.RigidSdfScene.empty(N, device="cpu")
    sc_t = tipc.RigidSdfScene(sc_t.spheres, sc_t.boxes, sc_t.capsules, torch.from_numpy(plane))
    fem_t, abd_t = world_t.step(tipc.SoftBodyState(torch.from_numpy(x), torch.zeros(x.shape)),
                                tabd.AbdState(torch.from_numpy(q), torch.from_numpy(qd)), sc_t)
    # the body-body pairs are live: the cubes start within barrier reach of each other
    y0 = world_t.abd.world_points(torch.from_numpy(q))
    assert world_t.abd._select_candidates(y0)[1].any()
    assert np.abs(abd_t.q.numpy() - q).max() > 10 * Q_TOL
    np.testing.assert_allclose(fem_t.x.numpy(), np.asarray(fem_j.x), atol=GEL_ATOL, rtol=0)
    np.testing.assert_allclose(abd_t.q.numpy(), np.asarray(abd_j.q), atol=Q_TOL, rtol=0)
    np.testing.assert_allclose(abd_t.qd.numpy(), np.asarray(abd_j.qd), atol=Q_TOL / 0.01, rtol=0)
    # the broad phase, with the ABD model's own families under abd_ keys
    counts = world_t.broad_phase_overflow(fem_t.x, abd_t.q)
    assert {"abd_vt_body", "abd_ee", "vt_cross_a", "vt_cross_b"} <= set(counts)
    for e in range(N):
        want = world_j.broad_phase_overflow(fem_j.x[e], abd_j.q[e])
        assert {k: int(v[e]) for k, v in counts.items()} == {k: int(v) for k, v in want.items()}
