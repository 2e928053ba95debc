"""Behaviour of the port's UIPC ball-rolling env on the CPU, mirrored from
the JAX package's ``tests/test_uipc_env.py``: the gel deforms under a press
and its markers move, and the gel's stiffness changes the ball's path (the
two-way coupling's observable). These run the port alone."""

import numpy as np
import torch

from _torch_bins import setup_torch
from tacex_tpu_torch import envs
from tacex_tpu_torch.envs.ball_rolling.env_uipc import BallRollingUipcEnv, BallRollingUipcEnvCfg

setup_torch()

DOWN = torch.tensor([[0.0, 0.0, -0.08, 0.0, 0.0, 0.0]]).repeat(2, 1)


def test_gel_deforms_under_press():
    env = envs.make("TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0", num_envs=2, device="cpu")
    state, _ = env.reset_all(env.init_state())
    rest = state.gel.x[0].clone()
    for _ in range(8):
        state, obs, rew, term, trunc, info = env.step(state, DOWN)
    assert state.gel.x.shape == (2, 297, 3) and bool(torch.isfinite(state.gel.x).all())
    assert bool(torch.isfinite(rew).all()) and info["marker_flow"].shape == (2, 2, 128, 2)
    # the gel moved down with the tool and deformed (non-rigid motion)
    disp = (state.gel.x[0] - rest).numpy()
    assert disp[:, 2].mean() < -1e-4
    assert disp[:, 2].std() > 1e-5
    assert float(info["indentation_depth"][0]) > 0.3
    flow = info["marker_flow"][0].numpy()
    assert np.abs(flow[1] - flow[0]).max() > 0.05, "no marker moved in image space"
    # while pressed, the barrier's reaction on the ball is downward and nonzero
    f = env.gel.sphere_contact_force(state.gel, env._scene(state.base.ball_pos, env._no_planes))[:, 0].numpy()
    assert np.abs(f).max() > 1e-4 and f[:, 2].max() < 1e-6, f


def _ball_path(youngs, steps=6):
    cfg = BallRollingUipcEnvCfg(num_envs=2, obs_mode="rgb", with_markers=False, gel_youngs_modulus_pa=youngs,
                                action_noise=0.0)
    env = BallRollingUipcEnv(cfg, device="cpu", with_marker_flow=False)
    state, _ = env.reset_all(env.init_state())
    path = []
    for _ in range(steps):
        state, *_ = env.step(state, DOWN)
        path.append(state.base.ball_pos[0].numpy().copy())
    return np.stack(path)


def test_ball_path_depends_on_gel_stiffness():
    soft, stiff = _ball_path(4e4), _ball_path(1.2e6)
    assert np.isfinite(soft).all() and np.isfinite(stiff).all()
    assert np.abs(soft - stiff).max() > 1e-4, "gel stiffness had no effect on the ball"
