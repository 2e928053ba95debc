"""The committed PPO policies of the coupled tasks act in the port as in JAX.

``logs/grasp_lift_tactile_ppo_r05`` (iteration 249, the tactile Grasp-Lift
id's CNN + MLP) and ``logs/factory_uipc_ppo_r05`` (iteration 119, the
Factory-UIPC id's MLP), orbax checkpoints read by the JAX side only,
converted by ``rl.networks.actor_critic_from_flax``, give JAX's
deterministic actions to 1e-5 on the JAX env's reset observations at 2
envs and on copies moved across the task's range by seeded noise.
"""

from pathlib import Path

import numpy as np
import pytest

import jax

from _torch_bins import setup_torch
from _torch_coupled import N, check_policy
from tacex_tpu import envs as jenvs

setup_torch()

LOGS = Path(__file__).resolve().parents[1] / "logs"
CASES = [
    ("TacEx-Grasp-Lift-Uipc-Tactile-v0", LOGS / "grasp_lift_tactile_ppo_r05" / "ckpt" / "249" / "default", 2, 0.1),
    ("TacEx-Factory-PegInsert-Uipc-v0", LOGS / "factory_uipc_ppo_r05" / "ckpt" / "119" / "default", 4, 0.3),
]


@pytest.mark.parametrize("env_id,ckpt,action_dim,spread", CASES, ids=["grasp_lift_tactile", "factory_uipc"])
def test_committed_policy_acts_as_in_jax(env_id, ckpt, action_dim, spread):
    env = jenvs.make(env_id, num_envs=N)
    _, obs = jax.jit(env.reset_all)(env.init_state(jax.random.PRNGKey(0)))
    obs = {k: np.asarray(v) for k, v in obs.items()}
    rng = np.random.default_rng(11)
    moved = {k: (v + rng.normal(0, spread, v.shape) * max(np.abs(v).max(), 1.0)).astype(np.float32)
             for k, v in obs.items()}
    check_policy(ckpt, {k: np.concatenate([obs[k], moved[k]]) for k in obs}, action_dim)
