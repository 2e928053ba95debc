"""The two IK-reset ball-rolling tasks of the port against the JAX package.

One step each as in ``test_torch_envs.py``, and the reset itself: the joint
angles of the port's 10-step DLS solve against the JAX reset's, from the
ball position that reset drew (atol 1e-4: ten solves deep).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_bins import setup_torch
from _torch_envs import N, assert_one_step_matches_jax, pair

setup_torch()

IK_IDS = ["TacEx-Ball-Rolling-Privileged-Reset-with-IK-v0", "TacEx-Ball-Rolling-Privileged-Without-Reaching-v0"]


@pytest.mark.parametrize("env_id", IK_IDS)
def test_ik_reset_matches_the_jax_solve(env_id):
    _, env_t, st_j = pair(env_id)
    ball = torch.from_numpy(np.array(st_j.ball_pos))
    q = env_t._ik_reset_joints(env_t._q0.expand(N, 7), ball + env_t._ik_reset_offset)
    np.testing.assert_allclose(q.numpy(), np.asarray(st_j.arm.q), atol=1e-4)
    # the solve reaches its target: above the ball, or on it
    hover = env_t.cfg.reset_ik_height if env_t.cfg.reset_mode == "ik_above" else 0.0002
    offset = np.tile([0.0, 0.0, env_t.cfg.ball_radius + hover], (N, 1))
    tool, _ = env_t._tool_pose(q)
    np.testing.assert_allclose((tool - ball).numpy(), offset, atol=2e-4)
    # and the port's own reset applies it
    st_t, obs_t = env_t.reset_all(env_t.init_state())
    tool, _ = env_t._tool_pose(st_t.arm.q)
    np.testing.assert_allclose((tool - st_t.ball_pos).numpy(), offset, atol=2e-4)
    assert torch.equal(st_t.arm.q, st_t.arm.q_target) and obs_t["proprio_obs"].shape == (N, 14)


@pytest.mark.parametrize("env_id", IK_IDS)
def test_one_step_matches_jax(env_id):
    assert_one_step_matches_jax(env_id)


def test_ik_reset_is_applied_under_the_mask():
    _, env_t, _ = pair(IK_IDS[1])
    st, _ = env_t.reset_all(env_t.init_state())
    moved = torch.zeros_like(st.arm.q)
    st = dataclasses.replace(st, arm=dataclasses.replace(st.arm, q=moved))
    mask = torch.tensor([True, False, True, False])
    st2 = env_t._reset_where(st, mask)
    assert bool((st2.arm.q[~mask] == 0).all()) and bool((st2.arm.q[mask].abs().sum(-1) > 0).all())
