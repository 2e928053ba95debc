"""Shared scenes of the UIPC scene-API parity tests (``test_torch_uipc_api*``,
``test_torch_uipc_examples*``): each function below makes the same scene through
either package's ``uipc`` module, the JAX package's (``tacex_tpu.uipc``) or
the port's (``tacex_tpu_torch.uipc``, on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

import tacex_tpu.uipc as J
import tacex_tpu_torch.uipc as T

ATOL = 1.5e-5  # m: two f32 solves of the same steps (tests/_torch_coupled.py's GEL_ATOL)


def is_jax(M) -> bool:
    return M is J


def new_sim(M, cfg):
    return M.UipcSim(cfg) if is_jax(M) else M.UipcSim(cfg, device="cpu")


def tensor(M, a):
    """A float32 array of the package's kind."""
    return jnp.asarray(np.asarray(a, np.float32)) if is_jax(M) else torch.as_tensor(np.asarray(a, np.float32))


def numpy(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def per_env_step(model):
    """A JAX ``SoftBodyModel.step`` at one substep (or ``ShellModel.step``)
    as one jit of its ``_step_single`` called env by env, in the call
    signature of ``UipcSim``'s union step and ``UipcObject._advance``:
    ``step`` is that function's ``vmap``, whose batching pass costs ~2-10 s
    more to trace and compile on these scenes."""
    import jax

    from tacex_tpu.physics.soft import ipc as jipc

    assert getattr(model.cfg, "ccd_substeps", 1) <= 1
    single = jax.jit(model._step_single)

    def step(state, scene, aim_pos=None, scene_prev=None, aim_prev=None):
        n = state.x.shape[0]
        if aim_pos is None:
            aim_pos = jnp.zeros((n, max(int(model.attachment_verts.shape[0]), 1), 3))
        outs = [single(state.x[e], state.v[e], jax.tree_util.tree_map(lambda a: a[e], scene), aim_pos[e])
                for e in range(n)]
        x, v = (jnp.stack(parts) for parts in zip(*outs))
        return jipc.SoftBodyState(x=x, v=v)

    return step


def single_env_steps(sim):
    """Step a set-up JAX ``UipcSim``'s FEM objects and union model through
    ``per_env_step`` (where they solve at one substep)."""
    if sim._union_model is not None and sim._union_model.cfg.ccd_substeps <= 1:
        sim._union_step_fn = per_env_step(sim._union_model)
    for obj in sim.objects:
        if type(obj.model).__name__ == "SoftBodyModel" and obj.model.cfg.ccd_substeps <= 1:
            obj._step = per_env_step(obj.model)
    return sim


def build_gel(M, num_envs=2, cg_iters=8):
    """``tests/test_uipc_api.py``'s scene: a 20 x 25 x 4.5 mm gel of (4, 5, 2)
    cells under an attachment at its top face (z = 0), 4 Newton x
    ``cg_iters`` CG iterations a step (the JAX test's 24 where a test needs
    its converged motion)."""
    sim = new_sim(M, M.UipcSimCfg(num_envs=num_envs, newton=M.UipcSimCfg.Newton(max_iter=4),
                                  linear_system=M.UipcSimCfg.LinearSystem(max_iter=cg_iters)))
    obj = M.UipcObject(
        M.UipcObjectCfg(
            mesh_cfg=M.objects.TetMeshCfg(size=(0.02, 0.025, 0.0045), resolution=(4, 5, 2), center=(0, 0, -0.00225)),
            constitution=M.StableNeoHookeanCfg(youngs_modulus=0.145, poisson_rate=0.45),
        ),
        sim,
    )
    att = M.UipcIsaacAttachments(M.UipcIsaacAttachmentsCfg(attachment_points_radius=5e-4), obj)
    att.compute_attachment_data(np.zeros(3), np.array([1.0, 0, 0, 0]))
    return sim, obj, att


def drive(M, obj, att, num_envs, shift=(0.0, 0.0, 0.0)):
    """Attach the gel's top face to a mount at ``shift`` from its rest pose."""
    pos = tensor(M, np.tile(np.asarray(shift, np.float32), (num_envs, 1)))
    quat = tensor(M, np.tile(np.array([1.0, 0, 0, 0], np.float32), (num_envs, 1)))
    obj._aim_provider = lambda: att.aim_positions(pos, quat)
