"""Shared scenes of the standalone ABD parity tests (``test_torch_abd_*``).

Four 6 cm affine cubes (8 corners, 12 triangles each) over a ground plane,
2 envs: env 0 a two-cube stack (bodies 0 and 1, with bodies 2 and 3 resting
on the ground 25 cm to either side), env 1 a four-cube pile. Every body is
turned by a seeded 5-20 mrad rotation and shifted by up to 6 mm in x and y,
its bottom 1.2 mm over the ground or 0.8 mm over the body below (inside
the 2 mm barrier reach), and falls at 2-8 cm/s. The solver: dt 0.01,
d_hat 2 mm, friction 0.3, 8 vertex-triangle and 4 edge-edge candidates,
2 Newton x 6 line-search iterations (3 CG iterations on the CG path) with
the convergence stop off (``velocity_tol = 0``, a float-noise decision,
ROADMAP Queue 3).

The JAX reference step is ``AbdModel._step_single`` jitted once a solver
and process and called per env (``per_env_abd_step``): ``AbdModel.step`` is
its ``vmap`` over the envs, whose batching pass would add ~5 s of tracing
to each compile.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tacex_tpu.physics.soft import abd as jabd
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch.physics.soft import abd as tabd
from tacex_tpu_torch.physics.soft import ipc as tipc

N, B = 2, 4
HALF = 0.03


def cube(half=HALF):
    """(8 corners, 12 outward triangles) of a cube."""
    P = np.array([[x, y, z] for x in (-half, half) for y in (-half, half) for z in (-half, half)], np.float64)
    faces = [(0, 1, 3, 2, [-1, 0, 0]), (4, 6, 7, 5, [1, 0, 0]), (0, 4, 5, 1, [0, -1, 0]),
             (2, 3, 7, 6, [0, 1, 0]), (0, 2, 6, 4, [0, 0, -1]), (1, 5, 7, 3, [0, 0, 1])]
    T = []
    for a, b, c, d, n in faces:
        for tri in ((a, b, c), (a, c, d)):
            p0, p1, p2 = P[list(tri)]
            if np.dot(np.cross(p1 - p0, p2 - p0), n) < 0:
                tri = (tri[0], tri[2], tri[1])
            T.append(tri)
    return P, np.asarray(T, np.int64)


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def state(seed: int = 0):
    """numpy (q, qd) (N, B, 12) of the stack (env 0) and the pile (env 1)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((N, B, 12), np.float32)
    for e in range(N):
        for b in range(B):
            q[e, b, 3:] = _rotation(rng.normal(size=3), rng.uniform(0.005, 0.02)).reshape(-1)
            q[e, b, :2] = rng.uniform(-0.006, 0.006, 2)
            level = b if (e == 1 or b < 2) else 0
            q[e, b, 2] = HALF + 0.0012 + level * (2 * HALF + 0.0008)
    q[0, 2, 0] -= 0.25
    q[0, 3, 0] += 0.25
    qd = np.zeros((N, B, 12), np.float32)
    qd[..., 2] = -rng.uniform(0.02, 0.08, (N, B))
    return q, qd


def cfg_kw(**kw):
    return dict(dict(dt=0.01, newton_max_iter=2, line_search_iters=6, cg_iters=3, velocity_tol=0.0, d_hat=0.002,
                     friction_mu=0.3, contact_k=8, ee_contact_k=4), **kw)


@functools.lru_cache(maxsize=None)
def models(**kw):
    """(JAX model, port model, the JAX step ``per_env_abd_step``) at ``cfg_kw(**kw)``."""
    P, T = cube()
    model_j = jabd.AbdModel([P] * B, [T] * B, cfg=jabd.AbdSolverCfg(**cfg_kw(**kw)))
    model_t = tabd.AbdModel([P] * B, [T] * B, cfg=tabd.AbdSolverCfg(**cfg_kw(**kw)), device="cpu")
    return model_j, model_t, per_env_abd_step(model_j)


def jax_scene(env=None):
    """The ground plane: every env's scene, or env ``env``'s single-env view."""
    sc = jipc.RigidSdfScene.empty(N)
    sc = jipc.RigidSdfScene(sc.spheres, sc.boxes, sc.capsules, sc.planes.at[:, 0].set(jnp.array([0.0, 0.0, 1.0, 0.0])))
    if env is None:
        return sc
    return jipc.RigidSdfScene(sc.spheres[env], sc.boxes[env], sc.capsules[env], sc.planes[env])


def port_scene():
    sc = tipc.RigidSdfScene.empty(N, device="cpu")
    planes = torch.zeros_like(sc.planes)
    planes[:, 0, 2] = 1.0
    return tipc.RigidSdfScene(sc.spheres, sc.boxes, sc.capsules, planes)


def per_env_abd_step(model_j):
    """``model_j.step`` (``AbdModel.step``) as one jit of its ``_step_single``
    called env by env: ``step`` is that function's ``vmap`` over the envs
    with these defaults, and the batching pass adds ~5 s to the trace."""
    single = jax.jit(model_j._step_single)

    def step(state, scene, aim_q=None, aim_strength=None):
        n, nb = state.q.shape[:2]
        if aim_q is None:
            aim_q = state.q
        if aim_strength is None:
            aim_strength = jnp.zeros((n, nb, 12))
        elif aim_strength.ndim == 2:
            aim_strength = jnp.broadcast_to(aim_strength[..., None], (n, nb, 12))
        outs = [single(state.q[e], state.qd[e], jax.tree_util.tree_map(lambda a: a[e], scene), aim_q[e],
                       aim_strength[e]) for e in range(n)]
        return jabd.AbdState(q=jnp.stack([o[0] for o in outs]), qd=jnp.stack([o[1] for o in outs]))

    return step


def jax_step(q, qd, **kw):
    """numpy (q, qd) after one JAX step of every env (no constraints)."""
    _, _, step = models(**kw)
    out = step(jabd.AbdState(jnp.asarray(q), jnp.asarray(qd)), jax_scene())
    return np.asarray(out.q), np.asarray(out.qd)


def port_step(q, qd, **kw):
    _, model_t, _ = models(**kw)
    st = model_t.step(tabd.AbdState(torch.from_numpy(q), torch.from_numpy(qd)), port_scene())
    return st.q.numpy(), st.qd.numpy()
