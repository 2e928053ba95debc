"""Shared scene of the soft-body parity tests (``test_torch_soft_*.py``).

The UIPC envs' ``"low"`` gel pad (box_tet_mesh (8, 10, 2) of the GelSight
Mini pad, 297 vertices, 960 tets) at the env's solver settings (dt 1/60,
4 Newton x 16 CG x 8 line-search iterations, d_hat 5e-4, kappa 2e4), its
mount face attached, placed where the envs put it (~0.35 m from the origin)
with its contact face down, 0.1-0.2 mm above a 5 mm ball. The attachment
targets are 0.6 and 1.0 mm lower in the two envs, so the step presses the
gel onto the ball; the plate is the envs' plane.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu.physics.soft import mesh as jmesh
from tacex_tpu_torch.physics.soft import ipc as tipc
from tacex_tpu_torch.physics.soft import mesh as tmesh

N = 2
H = 0.0045
SIZE = (0.020750, 0.025250, H)
RES = (8, 10, 2)
OFFSET = np.array([0.25, -0.35, 0.0101], np.float32)
RADIUS = 0.005
PLATE = (0.0, 0.0, 1.0, 0.0026)


def solver_cfg(module, **kw):
    return module.IpcSolverCfg(dt=1.0 / 60.0, newton_max_iter=4, cg_iters=16, d_hat=5e-4, kappa=2e4).replace(**kw)


@functools.lru_cache(maxsize=None)
def models(**kw):
    """(JAX model, port model, jitted JAX step) for solver overrides ``kw``."""
    mesh = jmesh.box_tet_mesh(SIZE, RES, center=(0.0, 0.0, H / 2), use_native=False)
    top = np.where(mesh.points[:, 2] > H - 1e-9)[0].astype(np.int32)
    model_j = jipc.SoftBodyModel(mesh, cfg=solver_cfg(jipc, **kw), attachment_verts=top)
    mesh_t = tmesh.box_tet_mesh(SIZE, RES, center=(0.0, 0.0, H / 2))
    model_t = tipc.SoftBodyModel(mesh_t, cfg=solver_cfg(tipc, **kw), attachment_verts=top, device="cpu")
    return model_j, model_t, jax.jit(model_j.step)


def press_inputs(model_j):
    """numpy (x, v, aim, spheres, planes) of the pressing step."""
    top = np.asarray(model_j.attachment_verts)
    x = np.broadcast_to(model_j.mesh.points + OFFSET, (N, model_j.mesh.num_vertices, 3)).astype(np.float32)
    press = np.array([0.6e-3, 1.0e-3], np.float32)
    aim = (x[:, top] - np.array([0.0, 0.0, 1.0], np.float32) * press[:, None, None]).astype(np.float32)
    sph = np.zeros((N, 1, 4), np.float32)
    sph[:, 0, :3] = OFFSET + np.array([[0.0005, -0.0003, -RADIUS - 0.0002], [-0.001, 0.0004, -RADIUS - 0.0001]], np.float32)
    sph[:, 0, 3] = RADIUS
    planes = np.broadcast_to(np.array(PLATE, np.float32), (N, 1, 4)).copy()
    return x.copy(), np.zeros_like(x), aim, sph, planes


def scenes(sph, planes):
    """(JAX scene, port scene) of the ball and the plate."""
    sj = jipc.RigidSdfScene(
        spheres=jnp.asarray(sph), boxes=jnp.zeros((N, 1, 10)), capsules=jnp.zeros((N, 1, 8)), planes=jnp.asarray(planes)
    )
    st = tipc.RigidSdfScene(
        spheres=torch.from_numpy(sph), boxes=torch.zeros((N, 1, 10)), capsules=torch.zeros((N, 1, 8)),
        planes=torch.from_numpy(planes),
    )
    return sj, st


def step_both(steps: int = 1, jax_side: bool = True, **kw):
    """Both solvers from the press state for ``steps`` steps -> the start x
    and, per step, (JAX x, port x, JAX v, port v) as numpy (JAX's None
    without ``jax_side``)."""
    model_j, model_t, step_j = models(**kw)
    x, v, aim, sph, planes = press_inputs(model_j)
    sj, st = scenes(sph, planes)
    s_j = jipc.SoftBodyState(x=jnp.asarray(x), v=jnp.asarray(v))
    s_t = tipc.SoftBodyState(x=torch.from_numpy(x), v=torch.from_numpy(v))
    out = []
    for _ in range(steps):
        if jax_side:
            s_j = step_j(s_j, sj, jnp.asarray(aim))
        s_t = model_t.step(s_t, st, torch.from_numpy(aim))
        out.append((np.asarray(s_j.x) if jax_side else None, s_t.x.numpy(),
                    np.asarray(s_j.v) if jax_side else None, s_t.v.numpy()))
    return x, out
