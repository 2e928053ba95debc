"""Cloth in the port's coupled world against the JAX package:
``tests/test_unified_shell.py``'s trampoline, one step at 2 Newton x 6 CG
x 4 line-search iterations with the convergence stop off (the cloth on a
gel, the union world, is in ``test_torch_shell_sim.py``).

  * ``examples/cloth_trampoline_torch.py``'s scene (``build``) against the
    JAX example's, its cube written 0.5 mm over the cloth's centre: cloth
    and cube meet through the coupled world's cross barriers. The JAX
    coupled step runs as one jit of its ``_step_single``
    (``tests/_torch_coupled.py``'s ``per_env_step``). Within 1e-4 (m, and
    dimensionless for the cube's affine entries; ROADMAP Queue 3).
"""

import runpy

import numpy as np
import torch

import jax.numpy as jnp

import _torch_shell as S
import tacex_tpu.uipc as J
import tacex_tpu_torch.uipc as T
from _torch_bins import setup_torch
from _torch_coupled import per_env_step
from _torch_shell import numpy

setup_torch()

DROP = -0.0085  # m: the cube's bottom from 39 mm to 0.5 mm over the cloth (at 30 mm)


def test_trampoline_coupled_step_matches_jax():
    build = runpy.run_path("examples/cloth_trampoline_torch.py")["build"]
    sj, cj, bj = S.trampoline_jax(S.sim_cfg(J, contact=J.UipcSimCfg.Contact(coupling_k=4)))
    st, ct, bt = build("cpu", S.sim_cfg(T, contact=T.UipcSimCfg.Contact(coupling_k=4)))
    sj._coupled_step_fn = per_env_step(sj._coupled)
    q = np.zeros(12, np.float32)
    q[2] = DROP
    q[3:] = np.eye(3, dtype=np.float32).ravel()
    sj.write_abd_pose(bj, jnp.asarray(q))
    st.write_abd_pose(bt, torch.from_numpy(q))
    sj.step()
    st.step()
    np.testing.assert_allclose(numpy(ct.nodal_pos_w), numpy(cj.nodal_pos_w), rtol=0, atol=S.COUPLED_ATOL)
    qj = numpy(sj.abd_body_pose(bj))
    np.testing.assert_allclose(numpy(st.abd_body_pose(bt)), qj, rtol=0, atol=S.COUPLED_ATOL)
    # the cross barrier held the cube over the cloth's centre
    cz = numpy(cj.nodal_pos_w)[0, :, 2]
    assert 0.045 + qj[0, 2] - 0.006 > cz[24] and cz[24] < 0.03
