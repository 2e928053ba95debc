"""Per-task tuned agent configurations.

Port of ``tacex_tpu/rl/agents.py``: every gym id maps to the
hyperparameters of its reference agent YAML, so a launcher picks the tuned
config from ``--task``. All ids of the JAX package are listed, so that an
env finds its config when it is ported. The tuning splits by observation:
  * state-vector tasks: rollouts 24, epochs 8, mini-batches 4, KL target
    0.01, entropy 0.001;
  * vision tasks: rollouts 64, epochs 4, mini-batches 32, KL target 0.008,
    entropy 0;
  * Factory: horizon 128, gamma 0.995.
SAC configs (``SAC_AGENT_CFGS``) exist for the privileged ball-rolling task,
pole balancing and the tactile Taxim-Fots task.
"""

from __future__ import annotations

from .ppo import PPOConfig
from .sac import SACConfig

_STATE_PPO = dict(
    rollouts=24, learning_epochs=8, mini_batches=4,
    kl_threshold=0.01, entropy_loss_scale=0.001,
)
_VISION_PPO = dict(
    rollouts=64, learning_epochs=4, mini_batches=32,
    kl_threshold=0.008, entropy_loss_scale=0.0,
)
_FACTORY_PPO = dict(
    rollouts=128, learning_epochs=4, mini_batches=32,
    discount_factor=0.995, kl_threshold=0.008, entropy_loss_scale=0.0,
)

# task id -> PPO kwargs
PPO_AGENT_CFGS: dict[str, dict] = {
    "TacEx-Ball-Rolling-Privileged-v0": _STATE_PPO,
    "TacEx-Ball-Rolling-Privileged-Reset-with-IK-v0": _STATE_PPO,
    "TacEx-Ball-Rolling-Privileged-Without-Reaching-v0": _STATE_PPO,
    "TacEx-Ball-Rolling-Tactile-Depth-v1": _VISION_PPO,
    "TacEx-Ball-Rolling-Tactile-RGB-v0": _VISION_PPO,
    "TacEx-Ball-Rolling-Taxim-Fots-v0": _VISION_PPO,
    "TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0": _VISION_PPO,
    "TacEx-Ball-Rolling-Uipc-Textured-v0": _VISION_PPO,
    "TacEx-Pole-Balancing-Base-v0": _VISION_PPO,
    "TacEx-Factory-PegInsert-Direct-v0": _FACTORY_PPO,
    "TacEx-Factory-GearMesh-Direct-v0": _FACTORY_PPO,
    "TacEx-Factory-NutThread-Direct-v0": _FACTORY_PPO,
    # large returns (~1.2k): the running value-target scaler keeps the
    # critic loss O(1) under global-norm clipping
    "TacEx-Grasp-Lift-Uipc-v0": dict(_STATE_PPO, value_preprocessor=True),
    "TacEx-Grasp-Lift-Uipc-Depth-v0": dict(_VISION_PPO, value_preprocessor=True),
    "TacEx-Grasp-Lift-Uipc-Tactile-v0": dict(_VISION_PPO, value_preprocessor=True),
    "TacEx-Factory-PegInsert-Uipc-v0": dict(_FACTORY_PPO, value_preprocessor=True),
    "TacEx-Factory-PegInsert-Uipc-Depth-v0": dict(_FACTORY_PPO, value_preprocessor=True),
}


# task id -> SAC kwargs (reference skrl_sac_cfg.yaml: batch 256, lr 1e-4 for
# the state task; the vision task flattens its 24x32x3 image into the buffer,
# ~9 KB an observation, so the buffer holds 20,000 transitions)
SAC_AGENT_CFGS: dict[str, dict] = {
    "TacEx-Ball-Rolling-Privileged-v0": dict(batch_size=256, actor_lr=1e-4, critic_lr=1e-4),
    "TacEx-Pole-Balancing-Base-v0": dict(batch_size=256),
    "TacEx-Ball-Rolling-Taxim-Fots-v0": dict(
        batch_size=256, buffer_size=20_000, actor_lr=3e-4, critic_lr=5e-4, rollout_steps=4, grad_steps=2,
    ),
}


def agent_cfg_for(task_id: str, algorithm: str = "ppo", **overrides) -> PPOConfig | SACConfig:
    """Tuned config of ``algorithm`` ("ppo" or "sac") for a task.
    ``overrides`` that are not None (a user's ``--rollouts``) win over the
    tuned values; unknown tasks take the library defaults."""
    if algorithm not in ("ppo", "sac"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    table, cls = (SAC_AGENT_CFGS, SACConfig) if algorithm == "sac" else (PPO_AGENT_CFGS, PPOConfig)
    base = dict(table.get(task_id, {}))
    base.update({k: v for k, v in overrides.items() if v is not None})
    return cls(**base)
