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
from ..core.device import DEFAULT_DEVICE, resolve
from ..parallel import mesh


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

    ``env_mean`` is the mean over envs of an (N,) tensor that feeds the
    state (the curriculum's mean episode reward): over every rank's envs
    when ``env_group`` is the ``EnvGroup`` of the rank whose slice the env
    holds (``parallel.mesh.bind_env`` sets it), over the env's own otherwise.
    """

    cfg: DirectRLEnvCfg
    env_group = None

    def __init__(self, cfg: DirectRLEnvCfg, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve(device)
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

    def env_mean(self, x: torch.Tensor) -> torch.Tensor:
        return mesh.mean_over_envs(x, self.env_group)

    def rollout(self, state, actions: torch.Tensor):
        """``step`` over the (T, N, A) ``actions``: the counterpart of the
        JAX package's ``rollout_fn``. Returns (the last state, (obs, reward,
        terminated, truncated)), each leaf stacked to (T, N, ...) in buffers
        allocated at the first step; no value is read back to the host."""
        out = None
        for t in range(actions.shape[0]):
            state, obs, reward, term, trunc, _ = self.step(state, actions[t])
            step = (obs, reward, term, trunc)
            if out is None:
                alloc = lambda x: torch.empty((actions.shape[0],) + tuple(x.shape), dtype=x.dtype, device=x.device)
                out = ({k: alloc(v) for k, v in obs.items()}, alloc(reward), alloc(term), alloc(trunc))
            for k, v in obs.items():
                out[0][k][t] = v
            for buf, v in zip(out[1:], step[1:]):
                buf[t] = v
        return state, out


_REGISTRY: dict[str, tuple[type, Any]] = {}


def register(env_id: str, env_class: type, default_cfg_factory: Callable[[], DirectRLEnvCfg]) -> None:
    """gym.register equivalent."""
    _REGISTRY[env_id] = (env_class, default_cfg_factory)


def _entry(env_id: str) -> tuple[type, Any]:
    if env_id not in _REGISTRY:
        raise KeyError(f"Unknown env id '{env_id}'. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[env_id]


def default_cfg(env_id: str) -> DirectRLEnvCfg:
    """The registered default config of ``env_id``."""
    return _entry(env_id)[1]()


def make(env_id: str, cfg: DirectRLEnvCfg | None = None, device=DEFAULT_DEVICE, **overrides) -> DirectRLEnv:
    env_class = _entry(env_id)[0]
    cfg = cfg if cfg is not None else default_cfg(env_id)
    if overrides:
        cfg = cfg.replace(**overrides)
    return env_class(cfg, device=device)


def registered_envs() -> list[str]:
    """The registered env ids, sorted."""
    return sorted(_REGISTRY)
