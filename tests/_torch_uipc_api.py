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
