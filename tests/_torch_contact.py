"""Shared scenes of the contact-family parity tests (``test_torch_uipc_*``).

The two-gel union of ``tests/test_fem_fem_contact.py``: two 10 x 10 x 4 mm
slabs of (3, 3, 2) cells, the top one 1.2 mm above the bottom one, the
bottom held by its bottom face and the top driven by its top face, at that
file's solver settings (d_hat 0.5 mm, kappa 1e3, no friction or gravity)
with fewer Newton and CG iterations (3 x 8) and the convergence stop off.
The pressed state: the top slab lowered 0.9 mm (0.3 mm from the bottom one,
inside the candidate cut), both jittered by 20 um of seeded noise so that
no two centroid distances tie, and the top slab's targets 0.2 and 0.3 mm
lower in the two envs.

The JAX side meshes through the JAX package's own path, its native mesher,
which lists the surface triangles in another order than the port's numpy
mesher (ROADMAP Queue 3): candidates are compared as sets of vertex tuples.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh

N = 2
GAP = 0.0012
SIZE = (0.01, 0.01, 0.004)
RES = (3, 3, 2)
LOWER = 0.0009
PRESS = np.array([2e-4, 3e-4], np.float32)
ATOL = 1.5e-5  # m: two f32 solves of the same step (tests/_torch_coupled.py's GEL_ATOL)


def solver_kw(**kw):
    return dict(dt=0.01, newton_max_iter=3, cg_iters=8, d_hat=0.0005, kappa=1e3, friction_mu=0.0,
                gravity=(0.0, 0.0, 0.0), velocity_tol=0.0, **kw)


def union_mesh(module):
    """(union mesh, vertex offsets) of the two slabs, by the module's mesher."""
    return module.union_meshes([module.box_tet_mesh(SIZE, RES, center=(0.0, 0.0, 0.0)),
                                module.box_tet_mesh(SIZE, RES, center=(0.0, 0.0, SIZE[2] + GAP))])


@functools.lru_cache(maxsize=None)
def union_models(**kw):
    """(JAX model, port model, anchors, number of bottom anchors) of the
    two-gel union at ``solver_kw(**kw)``."""
    mesh_j, off = union_mesh(jmesh)
    mesh_t, _ = union_mesh(tmesh)
    nb = int(off[1])
    z = mesh_t.points[:, 2]
    ids = np.arange(len(z))
    bot = np.where((ids < nb) & (z < z[:nb].min() + 1e-6))[0]
    top = np.where((ids >= nb) & (z > z.max() - 1e-6))[0]
    anchors = np.concatenate([bot, top]).astype(np.int32)
    model_j = jipc.SoftBodyModel(mesh_j, cfg=jipc.IpcSolverCfg(**solver_kw(**kw)), attachment_verts=anchors)
    model_t = tipc.SoftBodyModel(mesh_t, cfg=tipc.IpcSolverCfg(**solver_kw(**kw)), attachment_verts=anchors,
                                 device="cpu")
    return model_j, model_t, anchors, len(bot)


def pressed(model_t, anchors, n_bot, seed: int = 0):
    """numpy (x, aim) of the pressed state (see the module docstring)."""
    pts = model_t.mesh.points
    nb = int((np.arange(len(pts)) < len(pts) // 2).sum())
    rng = np.random.default_rng(seed)
    x = (pts[None] + rng.normal(0, 2e-5, (N,) + pts.shape)).astype(np.float32)
    x[:, nb:, 2] -= LOWER
    aim = x[:, anchors].copy()
    aim[:, n_bot:, 2] -= PRESS[:, None]
    return x, aim


def as_torch(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def pair_sets(elems, cand, valid):
    """Per (env, row): the sorted (candidate's sorted vertex tuple, valid) pairs,
    with ``elems`` the (T, k) vertex ids the candidate ids index."""
    tup = np.sort(np.asarray(elems)[np.asarray(cand)], -1)
    valid = np.asarray(valid)
    return [[sorted((tuple(tup[i, j, m]), bool(valid[i, j, m])) for m in range(tup.shape[2]))
             for j in range(tup.shape[1])] for i in range(tup.shape[0])]
