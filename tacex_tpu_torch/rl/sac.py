"""Soft Actor-Critic on the card (PyTorch): the port's off-policy trainer.

Port of ``tacex_tpu/rl/sac.py``: twin Q critics with a Polyak-averaged
target, a tanh-squashed Gaussian policy, an automatic entropy temperature
and a uniform replay ring buffer on the env's device. One ``train_step`` is
``rollout_steps`` env steps with sampled actions into the buffer, then, once
the step count has reached ``warmup_steps``, ``grad_steps`` updates of the
critics, the actor and the temperature, each with its own Adam (optax's
form: no gradient clipping).

Nothing in ``train_step`` reads a value back to the host. The step count
and the buffer's write pointer and fill level are Python ints, known on the
host from the number of env steps taken, so the warm-up switch is a Python
branch and the buffer's indices are drawn in ``[0, size)`` without asking
the card. Dict observations are flattened (sorted keys) into the buffer.

With an ``EnvGroup`` (``parallel/group.py``) each rank steps its slice of
the envs and the buffer stays global, as the JAX package's replicated one:
each step's transitions are all-gathered in global env order into a buffer
that every rank holds whole, whose ``ptr`` and ``size`` count global rows.
The batches and the update's noise come from the shared generator, so
every rank computes the same update with no gradient all-reduce; only the
exploration noise is the rank's own.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.config import configclass
from ..parallel import mesh
from ..parallel.group import trainer_seeds

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


@configclass
class SACConfig:
    buffer_size: int = 100_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    init_alpha: float = 0.2
    target_entropy_scale: float = 1.0
    hidden: tuple = (256, 256)
    rollout_steps: int = 4  # env steps per train call
    grad_steps: int = 1
    warmup_steps: int = 1000


def _mlp(in_dim: int, hidden: tuple, device) -> list[nn.Linear]:
    dims = (in_dim,) + tuple(hidden)
    return [nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:])]


@torch.no_grad()
def _lecun_init(module: nn.Module, generator: torch.Generator) -> None:
    """flax's Dense defaults: lecun-normal kernels (a normal truncated at two
    standard deviations, rescaled to variance 1 / fan_in) and zero biases."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.mul_(std)


class GaussianPolicy(nn.Module):
    """ReLU MLP -> (mean, log_std clipped to [-10, 2])."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: tuple = (256, 256), device=None):
        super().__init__()
        self.hidden = nn.ModuleList(_mlp(obs_dim, hidden, device))
        self.mean = nn.Linear(hidden[-1], action_dim, device=device)
        self.log_std = nn.Linear(hidden[-1], action_dim, device=device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)


class TwinQ(nn.Module):
    """Two independent ReLU MLP critics over [obs, action] -> (q1, q2)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: tuple = (256, 256), device=None):
        super().__init__()
        in_dim = obs_dim + action_dim
        self.q1 = nn.ModuleList(_mlp(in_dim, hidden, device) + [nn.Linear(hidden[-1], 1, device=device)])
        self.q2 = nn.ModuleList(_mlp(in_dim, hidden, device) + [nn.Linear(hidden[-1], 1, device=device)])

    @staticmethod
    def _tower(layers, x):
        for layer in layers[:-1]:
            x = torch.relu(layer(x))
        return layers[-1](x)[..., 0]

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, act], dim=-1)
        return self._tower(self.q1, x), self._tower(self.q2, x)


def _squash(mean: torch.Tensor, log_std: torch.Tensor, eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tanh(mean + std eps) and its log-probability, for standard-normal
    ``eps`` drawn by the caller."""
    pre = mean + torch.exp(log_std) * eps
    act = torch.tanh(pre)
    logp = (-0.5 * (eps**2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.log(torch.maximum(1 - act**2, act.new_full((), 1e-6))).sum(-1)
    return act, logp


class ReplayBuffer:
    """Fixed-capacity ring buffer of transitions on one device. ``ptr`` and
    ``size`` are host ints (they follow from the number of adds)."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device=None):
        z = lambda *s: torch.zeros((capacity,) + s, device=device)
        self.obs, self.act, self.rew, self.next_obs, self.done = z(obs_dim), z(act_dim), z(), z(obs_dim), z()
        self.capacity = capacity
        self.ptr = 0
        self.size = 0

    def add_batch(self, obs, act, rew, next_obs, done) -> None:
        n = obs.shape[0]
        idx = (torch.arange(n, device=obs.device) + self.ptr) % self.capacity
        for buf, x in ((self.obs, obs), (self.act, act), (self.rew, rew), (self.next_obs, next_obs), (self.done, done)):
            buf.index_copy_(0, idx, x)
        self.ptr = (self.ptr + n) % self.capacity
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch_size: int, generator: torch.Generator | None = None, idx: torch.Tensor | None = None):
        """(obs, act, rew, next_obs, done) at ``idx``, or at ``batch_size``
        indices drawn uniformly from the filled part."""
        if idx is None:
            idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator, device=self.obs.device)
        return tuple(buf.index_select(0, idx) for buf in (self.obs, self.act, self.rew, self.next_obs, self.done))


def _flatten_obs(obs: dict) -> torch.Tensor:
    return torch.cat([obs[k].reshape(obs[k].shape[0], -1) for k in sorted(obs)], dim=-1)


class _Adam:
    """optax.adam over a list of tensors, updated in place."""

    def __init__(self, params: list[torch.Tensor], lr: float):
        self.params, self.lr = params, lr
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = list(grads)
        self.count += 1
        torch._foreach_mul_(self.m, ADAM_B1)
        torch._foreach_add_(self.m, torch._foreach_mul(grads, 1.0 - ADAM_B1))
        torch._foreach_mul_(self.v, ADAM_B2)
        torch._foreach_add_(self.v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - ADAM_B2))
        m_hat = torch._foreach_div(self.m, 1.0 - ADAM_B1**self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.v, 1.0 - ADAM_B2**self.count))
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_add_(self.params, torch._foreach_div(m_hat, denom), alpha=-self.lr)


class SAC:
    """SAC trainer bound to a ``DirectRLEnv``; it runs on the env's device.
    With ``group`` the env holds the rank's ``group.local_envs`` envs."""

    def __init__(self, env, cfg: SACConfig | None = None, group=None):
        self.env = env
        self.cfg = cfg or SACConfig()
        self.device = env.device
        self.group = group
        self.num_envs = mesh.bind_env(env, group)  # over every rank
        self.act_dim = env.cfg.action_space
        self.target_entropy = -self.act_dim * self.cfg.target_entropy_scale

    # ------------------------------------------------------------------ setup
    def init(self, seed: int) -> None:
        """Reset the env and draw the networks: the env's and the trainer's
        generators are seeded from ``seed`` (and the rank, with a group:
        ``parallel.group.trainer_seeds``). ``generator`` draws the networks, the
        batches and the update's noise, ``explore`` the rollout's actions:
        one generator unless the group spans ranks."""
        c, dev = self.cfg, self.device
        s_env, s_explore, s_loop = trainer_seeds(seed, self.group)
        self.env.generator.manual_seed(s_env)
        self.generator = torch.Generator(device=dev).manual_seed(s_loop)
        self.explore = self.generator if s_explore is None else torch.Generator(device=dev).manual_seed(s_explore)
        self.env_state, obs = self.env.reset_all(self.env.init_state())
        self.obs_flat = _flatten_obs(obs)
        obs_dim = self.obs_flat.shape[-1]
        self.actor = GaussianPolicy(obs_dim, self.act_dim, tuple(c.hidden), device=dev)
        self.critic = TwinQ(obs_dim, self.act_dim, tuple(c.hidden), device=dev)
        _lecun_init(self.actor, self.generator)
        _lecun_init(self.critic, self.generator)
        self.target_critic = TwinQ(obs_dim, self.act_dim, tuple(c.hidden), device=dev).requires_grad_(False)
        self.target_critic.load_state_dict(self.critic.state_dict())
        self.log_alpha = torch.full((), math.log(c.init_alpha), device=dev, requires_grad=True)
        self._reset_optimizers()
        self.buffer = ReplayBuffer(c.buffer_size, obs_dim, self.act_dim, device=dev)
        self.steps = 0  # total env steps

    def _reset_optimizers(self) -> None:
        c = self.cfg
        self.actor_params = list(self.actor.parameters())
        self.critic_params = list(self.critic.parameters())
        self.target_params = list(self.target_critic.parameters())
        self.actor_opt = _Adam(self.actor_params, c.actor_lr)
        self.critic_opt = _Adam(self.critic_params, c.critic_lr)
        self.alpha_opt = _Adam([self.log_alpha], c.alpha_lr)

    def load_flax(self, actor_params, critic_params=None) -> None:
        """Take the JAX trainer's flax parameters (numpy leaves); the target
        critic restarts from the critic and the optimizers from zero."""
        actor_sd, critic_sd = sac_params_from_flax(actor_params, critic_params)
        self.actor.load_state_dict(actor_sd)
        if critic_sd is not None:
            self.critic.load_state_dict(critic_sd)
            self.target_critic.load_state_dict(critic_sd)
        self._reset_optimizers()

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _explore_normal(self, shape) -> torch.Tensor:
        """The exploration noise: from the rank's own generator, or through
        ``_normal`` where the two generators are one."""
        if self.explore is self.generator:
            return self._normal(shape)
        return torch.randn(shape, generator=self.explore, device=self.device)

    # ----------------------------------------------------------------- update
    def update(self, batch, eps_next: torch.Tensor, eps_actor: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One gradient step of the critics, then the actor (against the
        updated critics), then the temperature, then the Polyak target.
        ``batch`` = (obs, act, rew, next_obs, done); ``eps_next`` and
        ``eps_actor`` are the standard-normal draws of the next-state and
        the actor-loss actions. Returns (critic loss, actor loss)."""
        c = self.cfg
        obs, act, rew, nobs, done = batch
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            nact, nlogp = _squash(*self.actor(nobs), eps_next)
            tq1, tq2 = self.target_critic(nobs, nact)
            target_q = rew + c.gamma * (1 - done) * (torch.minimum(tq1, tq2) - alpha * nlogp)

        q1, q2 = self.critic(obs, act)
        critic_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        self.critic_opt.step(torch.autograd.grad(critic_loss, self.critic_params))

        a, lp = _squash(*self.actor(obs), eps_actor)
        q1, q2 = self.critic(obs, a)
        actor_loss = (alpha * lp - torch.minimum(q1, q2)).mean()
        self.actor_opt.step(torch.autograd.grad(actor_loss, self.actor_params))

        alpha_loss = (-torch.exp(self.log_alpha) * (lp.detach() + self.target_entropy)).mean()
        self.alpha_opt.step(torch.autograd.grad(alpha_loss, [self.log_alpha]))

        with torch.no_grad():
            torch._foreach_mul_(self.target_params, 1 - c.tau)
            torch._foreach_add_(self.target_params, torch._foreach_mul(self.critic_params, c.tau))
        return critic_loss.detach(), actor_loss.detach()

    # ------------------------------------------------------------- train step
    def train_step(self) -> dict[str, torch.Tensor]:
        """``rollout_steps`` env steps into the buffer, then ``grad_steps``
        updates once the env-step count reaches ``warmup_steps``. Returns the
        metrics as 0-dim device tensors."""
        c = self.cfg
        rews = []
        with torch.no_grad():
            for _ in range(c.rollout_steps):
                mean, log_std = self.actor(self.obs_flat)
                act, _ = _squash(mean, log_std, self._explore_normal(mean.shape))
                self.env_state, next_obs, rew, term, _, _ = self.env.step(self.env_state, act)
                next_flat = _flatten_obs(next_obs)
                batch = (self.obs_flat, act, rew, next_flat, term.to(torch.float32))
                # one all-gather of the step's transitions, in global env order (the identity with no group)
                joined = mesh.all_gather_envs(torch.cat([x.reshape(x.shape[0], -1) for x in batch], 1), self.group)
                batch = [y.reshape((-1,) + tuple(x.shape[1:]))
                         for y, x in zip(joined.split([x[0].numel() for x in batch], 1), batch)]
                self.buffer.add_batch(*batch)
                self.obs_flat = next_flat
                rews.append(batch[2].mean())

        added = c.rollout_steps * self.num_envs
        zero = torch.zeros((), device=self.device)
        closs, aloss = [zero], [zero]
        if self.steps + added >= c.warmup_steps:
            closs, aloss = [], []
            for _ in range(c.grad_steps):
                batch = self.buffer.sample(c.batch_size, self.generator)
                shape = (c.batch_size, self.act_dim)
                cl, al = self.update(batch, self._normal(shape), self._normal(shape))
                closs.append(cl)
                aloss.append(al)
        self.steps += added
        metrics = {
            "reward_per_step": torch.stack(rews).mean() if rews else zero,
            "critic_loss": torch.stack(closs).mean(),
            "actor_loss": torch.stack(aloss).mean(),
            "alpha": torch.exp(self.log_alpha.detach()),
        }
        # the same on every rank by construction; the mean keeps them so
        return dict(zip(metrics, mesh.mean_over_ranks(torch.stack(list(metrics.values())), self.group).unbind()))

    @torch.no_grad()
    def act(self, obs: dict, deterministic: bool = True) -> torch.Tensor:
        mean, log_std = self.actor(_flatten_obs(obs))
        if deterministic:
            return torch.tanh(mean)
        return _squash(mean, log_std, self._explore_normal(mean.shape))[0]


# ----------------------------------------------------------- flax parameters


def _flax_names(n_hidden: int) -> tuple[list, list]:
    """How the state_dict's names map onto flax's, which names the Dense
    layers in call order: (actor, critic) lists of (prefix, flax name)."""
    actor = [(f"hidden.{i}", f"Dense_{i}") for i in range(n_hidden)]
    actor += [("mean", f"Dense_{n_hidden}"), ("log_std", f"Dense_{n_hidden + 1}")]
    critic = [(f"q{q + 1}.{i}", f"Dense_{q * (n_hidden + 1) + i}") for q in range(2) for i in range(n_hidden + 1)]
    return actor, critic


def sac_params_from_flax(actor_params, critic_params=None) -> tuple[dict, dict | None]:
    """(``GaussianPolicy`` state_dict, ``TwinQ`` state_dict or None) from
    the JAX trainer's flax trees (numpy leaves, with or without the
    ``"params"`` level). Dense kernels (in, out) are transposed."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    def convert(params, names):
        p = params.get("params", params)
        sd = {}
        for prefix, name in names:
            sd[f"{prefix}.weight"] = t(p[name]["kernel"]).T.contiguous()
            sd[f"{prefix}.bias"] = t(p[name]["bias"])
        return sd

    p = actor_params.get("params", actor_params)
    n_hidden = sum(1 for k in p if k.startswith("Dense_")) - 2
    actor, critic = _flax_names(n_hidden)
    return convert(actor_params, actor), None if critic_params is None else convert(critic_params, critic)


def sac_params_to_flax(actor_state_dict, critic_state_dict=None) -> tuple[dict, dict | None]:
    """The inverse of ``sac_params_from_flax``: ``{"params": ...}`` trees
    with numpy leaves."""
    a = lambda x: x.detach().cpu().numpy().copy()
    n_hidden = sum(1 for k in actor_state_dict if k.startswith("hidden.") and k.endswith(".weight"))
    actor, critic = _flax_names(n_hidden)

    def convert(sd, names):
        return {"params": {name: {"kernel": a(sd[f"{prefix}.weight"].T), "bias": a(sd[f"{prefix}.bias"])}
                           for prefix, name in names}}

    return convert(actor_state_dict, actor), None if critic_state_dict is None else convert(critic_state_dict, critic)
