"""The port's SAC against the JAX package's.

JAX's and PyTorch's random bits differ, so the draws are injected: the
standard-normal noise of ``_squash`` and the replay buffer's sample indices
come from numpy on both sides (on the JAX side by replacing ``_squash`` and
``ReplayBuffer.sample`` in its module while its ``train_step`` traces). One
train step (one env step into the buffer, then one update of the critics,
the actor and the temperature) runs on a small deterministic env written
twice, once per framework, from the same flax weights.

Tolerances: 1e-5 on actions, log-probabilities, losses and parameters, and
on the Adam moments (which give the gradients: after one step the first
moment is 0.1 g), relative to each tensor's largest value where that
exceeds 1; 1e-5 on the restored checkpoint's actions.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.rl import sac as jsac
from tacex_tpu_torch.rl import sac as tsac

setup_torch()

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "logs" / "sac_privileged_r05" / "ckpt" / "3999" / "default"
N, D, A, B = 8, 6, 3, 16  # envs, obs dim, action dim, batch
T = lambda a: torch.from_numpy(np.array(a, np.float32))
J = lambda a: jnp.asarray(np.asarray(a, np.float32))


def _close(a, b, atol=1e-5, err_msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=atol * max(1.0, float(np.abs(b).max(initial=0.0))), err_msg=err_msg)


def _close_trees(a, b, atol=1e-5):
    flat_a, flat_b = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for (path, x), y in zip(flat_a, flat_b):
        _close(x, y, atol, jax.tree_util.keystr(path))


def test_squash_matches_jax():
    rng = np.random.default_rng(0)
    mean = rng.normal(0, 1, (B, A)).astype(np.float32)
    log_std = rng.uniform(-3, 1, (B, A)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (B, A)))
    act_j, logp_j = jsac._squash(J(mean), J(log_std), key)
    act_t, logp_t = tsac._squash(T(mean), T(log_std), T(eps))
    _close(act_t, act_j)
    _close(logp_t, logp_j)
    g_j = jax.grad(lambda m, s: jsac._squash(m, s, key)[1].sum(), argnums=(0, 1))(J(mean), J(log_std))
    m, s = T(mean).requires_grad_(), T(log_std).requires_grad_()
    g_t = torch.autograd.grad(tsac._squash(m, s, T(eps))[1].sum(), (m, s))
    for a, b in zip(g_t, g_j):
        _close(a, b)


def test_replay_buffer_matches_jax():
    """Two adds that wrap the ring, then a sample at injected indices."""
    rng = np.random.default_rng(1)
    cap = 12
    buf_j, buf_t = jsac.ReplayBuffer.init(cap, D, A), tsac.ReplayBuffer(cap, D, A)
    for n in (8, 7):
        batch = [rng.normal(size=s).astype(np.float32) for s in ((n, D), (n, A), (n,), (n, D), (n,))]
        buf_j = buf_j.add_batch(*(J(x) for x in batch))
        buf_t.add_batch(*(T(x) for x in batch))
    assert (buf_t.ptr, buf_t.size) == (int(buf_j.ptr), int(buf_j.size)) == (3, 12)
    for name in ("obs", "act", "rew", "next_obs", "done"):
        _close(getattr(buf_t, name), getattr(buf_j, name), atol=0.0, err_msg=name)
    idx = rng.integers(0, cap, B)
    for a, b in zip(buf_t.sample(B, idx=torch.from_numpy(idx)), (getattr(buf_j, k)[idx] for k in
                                                                ("obs", "act", "rew", "next_obs", "done"))):
        _close(a, b, atol=0.0)
    drawn = buf_t.sample(1000, torch.Generator().manual_seed(0))[2]
    assert len(set(drawn.tolist())) == cap  # uniform over the filled part


W = np.random.default_rng(2).normal(0, 1, (A, D)).astype(np.float32)
S0 = np.random.default_rng(3).uniform(-0.5, 0.5, (N, D)).astype(np.float32)


class _EnvJ:
    """A small deterministic env: s' = tanh(s + 0.3 a W), r = -|s'|^2,
    terminated where s'_0 > 0.4."""

    cfg = types.SimpleNamespace(action_space=A, num_envs=N)

    def init_state(self, key):
        return J(S0)

    def reset_all(self, s):
        return s, {"proprio_obs": s}

    def step(self, s, a):
        ns = jnp.tanh(s + 0.3 * a @ J(W))
        return ns, {"proprio_obs": ns}, -(ns**2).sum(-1), ns[:, 0] > 0.4, jnp.zeros((N,), bool), {}


class _EnvT:
    cfg = _EnvJ.cfg
    device = torch.device("cpu")

    def __init__(self):
        self.generator = torch.Generator()

    def init_state(self):
        return T(S0)

    def reset_all(self, s):
        return s, {"proprio_obs": s}

    def step(self, s, a):
        ns = torch.tanh(s + 0.3 * a @ T(W))
        return ns, {"proprio_obs": ns}, -(ns**2).sum(-1), ns[:, 0] > 0.4, torch.zeros((N,), dtype=torch.bool), {}


def _trainers(warmup=0):
    cfg_kw = dict(buffer_size=64, batch_size=B, hidden=(32, 32), rollout_steps=1, grad_steps=1, warmup_steps=warmup)
    sac_j = jsac.SAC(_EnvJ(), jsac.SACConfig(**cfg_kw))
    ts = sac_j.init(jax.random.PRNGKey(0))
    sac_t = tsac.SAC(_EnvT(), tsac.SACConfig(**cfg_kw))
    sac_t.init(0)
    sac_t.load_flax(*jax.tree_util.tree_map(np.asarray, (ts.actor_params, ts.critic_params)))
    return sac_j, ts, sac_t


def _squash_eps(mean, log_std, eps):
    """JAX's ``_squash`` with the noise given instead of drawn: the same
    expression as ``tacex_tpu.rl.sac._squash`` after its normal draw."""
    std = jnp.exp(log_std)
    act = jnp.tanh(mean + std * eps)
    logp = (-0.5 * (eps**2 + 2 * log_std + jnp.log(2 * jnp.pi))).sum(-1)
    return act, logp - jnp.log(jnp.clip(1 - act**2, 1e-6)).sum(-1)


def test_one_train_step_matches_jax(monkeypatch):
    """Buffer add, losses, gradients (Adam's first moments), updated
    networks, Polyak target and temperature after one train step."""
    sac_j, ts, sac_t = _trainers()
    rng = np.random.default_rng(4)
    # prefill both buffers with the same 24 transitions, so a sample mixes old and new
    pre = [rng.normal(0, 0.5, s).astype(np.float32) for s in ((24, D), (24, A), (24,), (24, D))]
    pre.append((rng.random(24) < 0.2).astype(np.float32))
    ts = ts.__class__(**{**ts.__dict__, "buffer": ts.buffer.add_batch(*(J(x) for x in pre))})
    sac_t.buffer.add_batch(*(T(x) for x in pre))
    eps = {"act": rng.normal(size=(N, A)), "next": rng.normal(size=(B, A)), "actor": rng.normal(size=(B, A))}
    eps = {k: v.astype(np.float32) for k, v in eps.items()}
    idx = rng.integers(0, 24 + N, B)

    order = iter(["act", "next", "actor"])
    monkeypatch.setattr(jsac, "_squash", lambda m, s, key: _squash_eps(m, s, J(eps[next(order)])))
    monkeypatch.setattr(jsac.ReplayBuffer, "sample", lambda self, key, bs: tuple(
        getattr(self, k)[idx] for k in ("obs", "act", "rew", "next_obs", "done")))
    ts_j, m_j = jax.jit(sac_j.train_step)(ts)

    order_t = iter(["act", "next", "actor"])
    monkeypatch.setattr(sac_t, "_normal", lambda shape: T(eps[next(order_t)]))
    sample = sac_t.buffer.sample
    monkeypatch.setattr(sac_t.buffer, "sample", lambda bs, gen: sample(bs, idx=torch.from_numpy(idx)))
    m_t = sac_t.train_step()

    for k in ("obs", "act", "rew", "next_obs", "done"):
        _close(getattr(sac_t.buffer, k), getattr(ts_j.buffer, k), err_msg=k)
    for k in ("reward_per_step", "critic_loss", "actor_loss", "alpha"):
        _close(m_t[k], m_j[k], err_msg=k)
    assert float(m_t["critic_loss"]) > 0 and sac_t.steps == int(ts_j.steps) == N
    actor_j, critic_j = tsac.sac_params_to_flax(sac_t.actor.state_dict(), sac_t.critic.state_dict())
    _close_trees(actor_j, ts_j.actor_params)
    _close_trees(critic_j, ts_j.critic_params)
    _close_trees(tsac.sac_params_to_flax(sac_t.actor.state_dict(), sac_t.target_critic.state_dict())[1],
                 ts_j.target_critic_params)
    _close(sac_t.log_alpha, ts_j.log_alpha)
    # the gradients, through Adam's first moments
    to_sd = lambda module, moments: dict(zip(module.state_dict(), moments))
    grads_a = tsac.sac_params_to_flax(to_sd(sac_t.actor, sac_t.actor_opt.m), to_sd(sac_t.critic, sac_t.critic_opt.m))
    _close_trees(grads_a[0], ts_j.actor_opt[0].mu)
    _close_trees(grads_a[1], ts_j.critic_opt[0].mu)
    _close(sac_t.alpha_opt.m[0], ts_j.alpha_opt[0].mu)


def test_no_update_before_warmup():
    _, _, sac_t = _trainers(warmup=10 * N)
    before = [p.detach().clone() for p in sac_t.actor_params + sac_t.critic_params]
    m = sac_t.train_step()
    assert all(torch.equal(a, b) for a, b in zip(before, sac_t.actor_params + sac_t.critic_params))
    assert float(m["critic_loss"]) == 0.0 and float(m["actor_loss"]) == 0.0 and sac_t.steps == N
    assert sac_t.buffer.size == N and sac_t.actor_opt.count == 0


def test_flax_round_trip():
    _, ts, sac_t = _trainers()
    params = jax.tree_util.tree_map(np.asarray, (ts.actor_params, ts.critic_params))
    back = tsac.sac_params_to_flax(*tsac.sac_params_from_flax(*params))
    _close_trees(back[0], params[0], atol=0.0)
    _close_trees(back[1], params[1], atol=0.0)
    obs = S0
    mean_j, log_std_j = jsac.GaussianPolicy(A, (32, 32)).apply(ts.actor_params, J(obs))
    mean_t, log_std_t = sac_t.actor(T(obs))
    _close(mean_t, mean_j)
    _close(log_std_t, log_std_j)
    act = np.random.default_rng(5).uniform(-1, 1, (N, A)).astype(np.float32)
    for a, b in zip(sac_t.critic(T(obs), T(act)), jsac.TwinQ((32, 32)).apply(ts.critic_params, J(obs), J(act))):
        _close(a, b)


@pytest.mark.skipif(not CKPT.is_dir(), reason="the committed checkpoint logs/sac_privileged_r05 is not in this checkout")
def test_restored_checkpoint_acts_as_in_jax():
    """The committed SAC policy (``logs/sac_privileged_r05``, iteration 3999,
    orbax: read by the JAX side only), converted, gives JAX's deterministic
    actions on the privileged env's observations, through ``SAC.act``."""
    import orbax.checkpoint as ocp

    from tacex_tpu import envs as jenvs
    from tacex_tpu_torch import envs as tenvs

    restored = ocp.StandardCheckpointer().restore(CKPT)["params"]
    env_j = jenvs.make("TacEx-Ball-Rolling-Privileged-v0", num_envs=N)
    _, obs = jax.jit(env_j.reset_all)(env_j.init_state(jax.random.PRNGKey(0)))
    proprio = np.asarray(obs["proprio_obs"])
    # the reset observations, and copies moved across the task's range
    proprio = np.concatenate([proprio, proprio + np.random.default_rng(6).normal(0, 0.05, proprio.shape)]).astype(np.float32)
    sac_j = jsac.SAC(env_j, jsac.SACConfig())
    act_j = np.asarray(sac_j.act(restored, {"proprio_obs": J(proprio)}))

    sac_t = tsac.SAC(tenvs.make("TacEx-Ball-Rolling-Privileged-v0", num_envs=N, device="cpu"), tsac.SACConfig())
    sac_t.init(0)
    sac_t.load_flax(jax.tree_util.tree_map(np.asarray, restored))
    act_t = sac_t.act({"proprio_obs": T(proprio)}).numpy()
    assert act_t.shape == (2 * N, 5)
    np.testing.assert_allclose(act_t, act_j, atol=1e-5)
    assert np.abs(act_j).max() > 0.1
