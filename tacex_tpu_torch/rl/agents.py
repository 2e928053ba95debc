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
"""

from __future__ import annotations

from .ppo import PPOConfig

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


def agent_cfg_for(task_id: str, algorithm: str = "ppo", **overrides) -> PPOConfig:
    """Tuned config for a task. ``overrides`` that are not None (a user's
    ``--rollouts``) win over the tuned values; unknown tasks take the
    library defaults."""
    if algorithm == "sac":
        raise NotImplementedError("SAC is not ported yet: only algorithm='ppo' is available")
    if algorithm != "ppo":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    base = dict(PPO_AGENT_CFGS.get(task_id, {}))
    base.update({k: v for k, v in overrides.items() if v is not None})
    return PPOConfig(**base)
