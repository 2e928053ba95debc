"""PPO on the card (PyTorch): the RL layer of the port.

Port of ``tacex_tpu/rl/ppo.py``. One ``train_step`` is a rollout of the
vectorized env under ``torch.no_grad()`` into preallocated ``(T, N, ...)``
buffers, GAE, then ``learning_epochs`` x ``mini_batches`` clipped-surrogate
updates: global-norm clip, Adam direction, a learning rate that a
KL-adaptive rule moves once per epoch. Hyperparameters default to the
reference's skrl PPO config for the tactile-RGB task.

Nothing in ``train_step`` reads a value back to the host: the learning
rate, the mean KL, the value scaler and the metrics are device tensors and
the KL rule is ``torch.where``, so an iteration queues on the card without
waiting for it. ``gae``, ``loss`` and ``update`` take tensors and return
tensors, so a caller can feed them a trajectory and permutations of its own.
The JAX trainer is functional (a ``TrainState`` goes in and out); this one
holds its state and ``train_step`` advances it.

With an ``EnvGroup`` (``parallel/group.py``) the trainer holds one rank's
slice of the envs, and every quantity that spans envs is made global
through ``parallel/mesh.py``: the curriculum's mean, the advantage
normalisation, the value scaler, the minibatches (global permutations,
drawn on the host from the shared generator, of which each rank computes
its own rows, every loss term summed over them and divided by the global
minibatch size), one all-reduce of the flattened gradient per minibatch
before the clip, the KL and the metrics.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import configclass
from ..parallel import mesh
from ..parallel.group import trainer_seeds
from .networks import ActorCritic, gaussian_entropy, gaussian_log_prob

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
VAR_FLOOR = 1e-4


@configclass
class PPOConfig:
    rollouts: int = 64
    learning_epochs: int = 4
    mini_batches: int = 32
    discount_factor: float = 0.99
    lam: float = 0.95
    learning_rate: float = 1e-4
    kl_threshold: float = 0.008  # KL-adaptive learning-rate target
    lr_min: float = 1e-6
    lr_max: float = 1e-2
    grad_norm_clip: float = 1.0
    ratio_clip: float = 0.2
    value_clip: float = 0.2
    clip_predicted_values: bool = True
    entropy_loss_scale: float = 0.0
    value_loss_scale: float = 1.0
    value_preprocessor: bool = False
    """Standardize value targets with a running scaler. Off by default (raw
    returns are stable on the ball-rolling tasks, rewards O(0.1-1)); on for
    tasks with large returns, where the raw critic's loss would take the whole
    clipped gradient."""
    hidden: tuple = (256, 128, 64)


@dataclasses.dataclass(frozen=True)
class RunningScaler:
    """Running mean and variance of the value targets (0-dim tensors)."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device=None) -> "RunningScaler":
        f = lambda v: torch.full((), v, dtype=torch.float32, device=device)
        return RunningScaler(f(0.0), f(1.0), f(1e-4))

    def update(self, x: torch.Tensor, group=None) -> "RunningScaler":
        """Fold in the moments of ``x`` (over every rank's envs with a group)."""
        bm, bv = mesh.moments(x, group)
        bc = x.numel() * mesh.world_size(group)
        delta = bm - self.mean
        tot = self.count + bc
        new_mean = self.mean + delta * bc / tot
        new_var = (self.var * self.count + bv * bc + delta**2 * self.count * bc / tot) / tot
        return RunningScaler(new_mean, new_var, tot)

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        # the floor keeps a collapsed running variance (reward-sparse done
        # storms early in training) from exploding the scaled targets
        return (x - self.mean) * torch.rsqrt(torch.clamp(self.var, min=VAR_FLOOR))

    def unscale(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(torch.clamp(self.var, min=VAR_FLOOR)) + self.mean


class PPO:
    """PPO trainer bound to a ``DirectRLEnv``; it runs on the env's device.
    With ``group`` the env holds the rank's ``group.local_envs`` envs, and
    its curriculum takes the mean over every rank's envs."""

    def __init__(self, env, cfg: PPOConfig | None = None, group=None):
        self.env = env
        self.cfg = cfg or PPOConfig()
        self.device = env.device
        self.net: ActorCritic | None = None
        self.group = group
        self.num_envs = mesh.bind_env(env, group)  # over every rank

    # ------------------------------------------------------------------ setup
    def init(self, seed: int) -> None:
        """Reset the env and draw the network: the env's and the trainer's
        generators are seeded from ``seed`` (and the rank, with a group:
        ``parallel.group.trainer_seeds``). ``generator`` draws the network and the
        permutations, ``explore`` the rollout's actions: one generator
        unless the group spans ranks."""
        dev = self.device
        s_env, s_explore, s_loop = trainer_seeds(seed, self.group)
        self.env.generator.manual_seed(s_env)
        self.generator = torch.Generator(device=dev).manual_seed(s_loop)
        self.explore = self.generator if s_explore is None else torch.Generator(device=dev).manual_seed(s_explore)
        # the permutations of a group, drawn on the host alike on every rank
        self.host_generator = None if self.group is None else torch.Generator().manual_seed(s_loop)
        self.env_state, self.obs = self.env.reset_all(self.env.init_state())
        vision = self.obs.get("vision_obs")
        self.net = ActorCritic(
            self.obs["proprio_obs"].shape[-1],
            None if vision is None else tuple(vision.shape[1:]),
            self.env.cfg.action_space,
            hidden=tuple(self.cfg.hidden),
            device=dev,
        ).init_(self.generator)
        self.params = list(self.net.parameters())
        self.adam_m = [torch.zeros_like(p) for p in self.params]
        self.adam_v = [torch.zeros_like(p) for p in self.params]
        self.adam_count = 0
        self.lr = torch.full((), self.cfg.learning_rate, dtype=torch.float32, device=dev)
        self.value_scaler = RunningScaler.init(dev)
        self.steps = 0  # total env steps
        self._buffers = None

    # ---------------------------------------------------------------- rollout
    def _alloc(self, like: dict) -> dict:
        t = self.cfg.rollouts
        return {k: torch.empty((t,) + tuple(v.shape), dtype=v.dtype, device=self.device) for k, v in like.items()}

    @torch.no_grad()
    def rollout(self):
        """``cfg.rollouts`` env steps with sampled actions. Returns the
        trajectory (obs, action, logp, value, reward, done, env log), every
        leaf ``(T, N, ...)`` in buffers that the next rollout overwrites, and
        the value of the observation after the last step."""
        for t in range(self.cfg.rollouts):
            obs = self.obs
            mean, log_std, value = self.net(obs)
            action = mean + torch.exp(log_std) * torch.randn(mean.shape, generator=self.explore, device=self.device)
            logp = gaussian_log_prob(mean, log_std, action)
            self.env_state, self.obs, reward, term, trunc, info = self.env.step(self.env_state, action)
            done = (term | trunc).to(torch.float32)
            step = {"action": action, "logp": logp, "value": value, "reward": reward, "done": done}
            if self._buffers is None:
                self._buffers = (self._alloc(obs), self._alloc(step), self._alloc(info["log"]))
            for buf, src in zip(self._buffers, (obs, step, info["log"])):
                for k, v in src.items():
                    buf[k][t] = v
        _, _, last_value = self.net(self.obs)
        b_obs, b, b_log = self._buffers
        return (b_obs, b["action"], b["logp"], b["value"], b["reward"], b["done"], b_log), last_value

    # -------------------------------------------------------------------- gae
    def gae(self, values, rewards, dones, last_value):
        """(T, N) values, rewards, dones and (N,) ``last_value`` ->
        (normalised advantages, returns), both (T, N)."""
        c = self.cfg
        if c.value_preprocessor:
            values, last_value = self.value_scaler.unscale(values), self.value_scaler.unscale(last_value)
        advs = torch.empty_like(values)
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in range(values.shape[0] - 1, -1, -1):
            nonterm = 1.0 - dones[t]
            delta = rewards[t] + c.discount_factor * v_next * nonterm - values[t]
            adv_next = delta + c.discount_factor * c.lam * nonterm * adv_next
            advs[t] = adv_next
            v_next = values[t]
        returns = advs + values
        mean, var = mesh.moments(advs, self.group)  # over T x every rank's envs
        advs = (advs - mean) / (torch.sqrt(var) + 1e-8)
        return advs, returns

    # ------------------------------------------------------------------- loss
    def loss(self, batch, denom: int | None = None):
        """``batch``: (obs, action, old_logp, old_value, adv, ret_scaled).
        Returns (loss, (policy loss, value loss, entropy, approximate KL)),
        each term a sum over the batch's rows divided by ``denom`` (default:
        the batch's row count, the mean; with a group, the rows of the whole
        minibatch over every rank, of which this batch is the rank's share)."""
        c = self.cfg
        obs, action, old_logp, old_value, adv, ret_scaled = batch
        denom = adv.shape[0] if denom is None else denom
        avg = lambda x: x.sum() / denom  # noqa: E731
        mean, log_std, value = self.net(obs)
        logp = gaussian_log_prob(mean, log_std, action)
        ratio = torch.exp(logp - old_logp)
        surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - c.ratio_clip, 1 + c.ratio_clip) * adv)
        policy_loss = -avg(surr)

        if c.clip_predicted_values:
            # the larger of the clipped and unclipped errors: plain clipping
            # kills the value gradient once |target - old| > clip
            v_clipped = old_value + torch.clamp(value - old_value, -c.value_clip, c.value_clip)
            value_loss = c.value_loss_scale * avg(torch.maximum((ret_scaled - value) ** 2, (ret_scaled - v_clipped) ** 2))
        else:
            value_loss = c.value_loss_scale * avg((ret_scaled - value) ** 2)

        entropy = avg(gaussian_entropy(log_std))
        kl = avg((logp - old_logp) ** 2) * 0.5
        return policy_loss + value_loss - c.entropy_loss_scale * entropy, (policy_loss, value_loss, entropy, kl)

    # ----------------------------------------------------------------- update
    def _apply_gradients(self, grads) -> None:
        """Clip by the global norm (gradients under the limit are left alone,
        the others scaled by ``limit / norm``), take Adam's bias-corrected
        direction and step the parameters by the current learning rate."""
        c = self.cfg
        grads = list(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < c.grad_norm_clip, 1.0, c.grad_norm_clip / norm)
        grads = [g * scale for g in grads]
        self.adam_count += 1
        torch._foreach_lerp_(self.adam_m, grads, 1.0 - ADAM_B1)
        torch._foreach_mul_(self.adam_v, ADAM_B2)
        torch._foreach_addcmul_(self.adam_v, grads, grads, value=1.0 - ADAM_B2)
        bias1, bias2 = 1.0 - ADAM_B1**self.adam_count, 1.0 - ADAM_B2**self.adam_count
        denom = torch._foreach_sqrt(torch._foreach_div(self.adam_v, bias2))
        torch._foreach_add_(denom, ADAM_EPS)
        direction = torch._foreach_div(torch._foreach_div(self.adam_m, bias1), denom)
        with torch.no_grad():
            for p, d in zip(self.params, direction):
                p.sub_(self.lr * d)

    def minibatch_grads(self, flat, idx: torch.Tensor, mb_size: int):
        """(gradient, loss, KL) of one minibatch of ``mb_size`` rows over
        every rank, of which this rank holds the rows ``idx`` of ``flat``:
        each term summed over the rank's rows and divided by ``mb_size``,
        then summed over the ranks by one all-reduce of their concatenation
        (with no group, the concatenation alone: ``mesh.all_reduce_flat``)."""
        obs, *rest = flat
        batch = ({k: v.index_select(0, idx) for k, v in obs.items()}, *(x.index_select(0, idx) for x in rest))
        loss, (_, _, _, kl) = self.loss(batch, denom=mb_size)
        grads = torch.autograd.grad(loss, self.params, materialize_grads=True)  # zeros for a rank with no row
        *grads, loss, kl = mesh.all_reduce_flat([*grads, loss, kl], self.group)
        return grads, loss, kl

    def update(self, flat, perms) -> torch.Tensor:
        """One pass per row of ``perms`` (epochs, total) over ``flat`` =
        (obs, action, logp, value, adv, ret_scaled), each leaf (total, ...).
        An epoch takes ``min(mini_batches, total)`` minibatches of
        ``total // n_mb`` indices from its permutation (the tail is dropped),
        then moves the learning rate by the KL-adaptive rule. Returns the mean
        loss over the epochs.

        With a group, ``flat`` is the rank's (T n_local, ...) slice and
        ``perms`` (host) index the global (T N) trajectory: each rank takes
        its own rows of each minibatch (``mesh.local_minibatch_rows``; maybe
        none). Each minibatch goes through ``minibatch_grads``."""
        c = self.cfg
        total = flat[1].shape[0] * mesh.world_size(self.group)
        n_mb = min(c.mini_batches, total)
        mb_size = total // n_mb
        if self.group is None:
            rows = [[perm[i * mb_size : (i + 1) * mb_size] for i in range(n_mb)] for perm in perms]
        else:
            rows = mesh.local_minibatch_rows(perms, n_mb, mb_size, self.group, self.device)
        epoch_losses = []
        for epoch_rows in rows:
            kl_sum, loss_sum = 0.0, 0.0
            for idx in epoch_rows:
                grads, loss, kl = self.minibatch_grads(flat, idx, mb_size)
                self._apply_gradients(grads)
                kl_sum, loss_sum = kl_sum + kl.detach(), loss_sum + loss.detach()
            mean_kl = kl_sum / n_mb
            lr = self.lr
            lr = torch.where(mean_kl > c.kl_threshold * 2.0, torch.clamp(lr / 1.5, min=c.lr_min), lr)
            self.lr = torch.where(mean_kl < c.kl_threshold * 0.5, torch.clamp(lr * 1.5, max=c.lr_max), lr)
            epoch_losses.append(loss_sum / n_mb)
        return torch.stack(epoch_losses).mean()

    # ------------------------------------------------------------- train step
    def permutations(self, total: int) -> torch.Tensor:
        """The epochs' permutations of the ``total`` rows of the (global)
        trajectory: on the device, or on the host with a group."""
        c = self.cfg
        if self.group is None:
            # the order of uniform draws is a uniformly random permutation
            return torch.rand((c.learning_epochs, total), generator=self.generator, device=self.device).argsort(dim=1)
        return torch.stack([torch.randperm(total, generator=self.host_generator) for _ in range(c.learning_epochs)])

    def train_step(self) -> dict[str, torch.Tensor]:
        """One PPO iteration; returns its metrics as 0-dim device tensors
        (means over every rank's envs, with a group)."""
        c = self.cfg
        (obs, action, logp, value, reward, done, env_log), last_value = self.rollout()
        adv, returns = self.gae(value, reward, done, last_value)
        if c.value_preprocessor:
            self.value_scaler = self.value_scaler.update(returns, self.group)
            returns = self.value_scaler.scale(returns)

        local = c.rollouts * self.env.cfg.num_envs
        flatten = lambda x: x.reshape((local,) + tuple(x.shape[2:]))
        flat = ({k: flatten(v) for k, v in obs.items()}, *(flatten(x) for x in (action, logp, value, adv, returns)))
        loss = self.update(flat, self.permutations(c.rollouts * self.num_envs))
        self.steps += c.rollouts * self.num_envs
        # per-env episode metrics averaged over the rollout window
        means = {"reward_per_step": reward.mean(), "episode_done_frac": done.mean(), "value_pred_mean": value.mean(),
                 **{k: v.mean() for k, v in env_log.items()}}
        means = dict(zip(means, mesh.mean_over_ranks(torch.stack(list(means.values())), self.group).unbind()))
        return {"loss": loss, "reward_per_step": means.pop("reward_per_step"),
                "episode_done_frac": means.pop("episode_done_frac"), "lr": self.lr, **means}

    @torch.no_grad()
    def act(self, obs, deterministic: bool = True) -> torch.Tensor:
        mean, log_std, _ = self.net(obs)
        if deterministic:
            return mean
        return mean + torch.exp(log_std) * torch.randn(mean.shape, generator=self.explore, device=self.device)
