"""Direct-RL-style environment base and registry (PyTorch).

Port of ``tacex_tpu/envs/base.py``. An env holds static config, its device
and its random generator; ``reset_all`` and ``step`` take the state (a frozen
dataclass of tensors) and return a new one. Every ``step`` advances physics
``decimation`` times, then computes dones -> rewards -> masked resets ->
observations, all as tensor ops on the env's device.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.config import configclass


@configclass
class DirectRLEnvCfg:
    num_envs: int = 1024
    episode_length_s: float = 16.6666
    decimation: int = 1
    sim_dt: float = 1.0 / 60.0
    physics_substeps: int = 4
    action_space: int = 6
    seed: int = 0

    @property
    def max_episode_length(self) -> int:
        return int(self.episode_length_s / (self.sim_dt * self.decimation))


class DirectRLEnv:
    """Protocol every task env implements: ``init_state() -> state``,
    ``reset_all(state) -> (state, obs)`` and
    ``step(state, action) -> (state, obs, reward, terminated, truncated, info)``.
    """

    cfg: DirectRLEnvCfg

    def __init__(self, cfg: DirectRLEnvCfg, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    @property
    def num_envs(self) -> int:
        return self.cfg.num_envs

    def init_state(self):
        raise NotImplementedError

    def reset_all(self, state):
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError


_REGISTRY: dict[str, tuple[type, Any]] = {}


def register(env_id: str, env_class: type, default_cfg_factory: Callable[[], DirectRLEnvCfg]) -> None:
    """gym.register equivalent."""
    _REGISTRY[env_id] = (env_class, default_cfg_factory)


def make(env_id: str, cfg: DirectRLEnvCfg | None = None, device="cpu", **overrides) -> DirectRLEnv:
    if env_id not in _REGISTRY:
        raise KeyError(f"Unknown env id '{env_id}'. Registered: {sorted(_REGISTRY)}")
    env_class, cfg_factory = _REGISTRY[env_id]
    cfg = cfg if cfg is not None else cfg_factory()
    if overrides:
        cfg = cfg.replace(**overrides)
    return env_class(cfg, device=device)

