"""The port's ``TacEx-Factory-PegInsert-Uipc-v0`` (the gel-pad gripper
holding a free affine peg over a 4-box socket, one coupled solve) and
``-Uipc-Depth-v0`` (the pads' coarse inner-face compression images as the
vision obs) against the JAX package: one step of each id from a
carried-over pressed state at 2 envs with ``_torch_coupled``'s tolerances,
and the socket (the committed policy is ``test_torch_coupled_policies.py``'s).
The two ids share one jitted JAX coupled solve.
"""

import dataclasses

import numpy as np
import torch

from _torch_bins import setup_torch
from _torch_coupled import N, check_obs, check_step, one_step, port_state
from tacex_tpu_torch.envs.factory.env_uipc import FactoryUipcState

setup_torch()

ENV_ID = "TacEx-Factory-PegInsert-Uipc-v0"
DEPTH_ID = "TacEx-Factory-PegInsert-Uipc-Depth-v0"


def _stepped():
    return one_step(ENV_ID)


def test_scene_matches_jax():
    env_j, env_t, _, _, st_j = _stepped()
    for name in ("spheres", "boxes", "capsules", "planes"):
        np.testing.assert_array_equal(getattr(env_t.scene, name).numpy(), np.asarray(getattr(env_j.scene, name)),
                                      err_msg=name)
    assert env_t.scene.threads is None and env_t._z0 == env_j._z0
    np.testing.assert_allclose(env_t.peg.mass.numpy(), np.asarray(env_j.peg.mass), rtol=1e-6)
    st_t = port_state(env_t, st_j)
    assert isinstance(st_t, FactoryUipcState) and st_t.mount.shape == (N, 3)


def test_one_step_matches_jax():
    stepped = _stepped()
    check_step(stepped, "peg")
    check_obs(stepped)
    _, _, out_j, out_t, _ = stepped
    assert out_t[1]["proprio_obs"].shape == (N, 16)
    np.testing.assert_allclose(out_t[0].mount.numpy(), np.asarray(out_j[0].mount), atol=1e-7)
    np.testing.assert_allclose(out_t[5]["peg_tip"].numpy(), np.asarray(out_j[5]["peg_tip"]), atol=1e-5, rtol=0)


def test_lost_peg_terminates_and_resets():
    """A peg 6 cm from the mount is lost: the episode ends and the masked
    reset puts the gripper and the peg back over the pocket."""
    _, env_t, out_j, _, _ = _stepped()
    st = port_state(env_t, out_j[0])
    q = st.peg.q.clone()
    q[1, 0, 0] += 0.06
    st = dataclasses.replace(st, peg=dataclasses.replace(st.peg, q=q))
    st2, obs, rew, term, trunc, info = env_t.step(st, torch.zeros((N, 4)))
    assert term.tolist() == [False, True]
    assert int(st2.episode_length[1]) == 0 and float(st2.mount[1].abs().max()) <= env_t.cfg.reset_xy_noise
    np.testing.assert_allclose(st2.peg.q[1, 0, 2].item(), env_t._z0, atol=1e-6)
    assert float(rew[1]) < -5.0


def test_depth_id_one_step_matches_jax():
    stepped = one_step(DEPTH_ID)
    check_step(stepped, "peg")
    check_obs(stepped)
    _, _, out_j, out_t, _ = stepped
    vis = np.asarray(out_j[1]["vision_obs"])
    assert vis.shape == (N, 5, 5, 2) and tuple(out_t[1]["vision_obs"].shape) == vis.shape
    assert vis.max() > 0.3, "the peg does not press the gel"
