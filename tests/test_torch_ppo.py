"""The port's PPO against the JAX package's, on the CPU.

JAX's random streams cannot be reproduced in torch, so parity is held on
the functions whose randomness is an input: GAE, the loss with its gradient,
and one epoch of minibatch updates on a numpy trajectory with numpy
permutations. Whole training runs are held by their own assertions
(finite, parameters move; ``test_torch_ppo_learns.py``: the privileged
task's reward rises). Tolerances:
atol 1e-5 (rtol 1e-4 on the gradients): the same f32 arithmetic, summed in
another order.
"""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import setup_torch
from tacex_tpu.rl import agents as jagents
from tacex_tpu.rl import ppo as jppo
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.rl import agents as tagents
from tacex_tpu_torch.rl import ppo as tppo
from tacex_tpu_torch.rl.networks import ActorCritic, actor_critic_from_flax, actor_critic_to_flax

setup_torch()

ATOL = 1e-5
ACTION_DIM = 5
VISION = (24, 32, 3)


def _fake_env(n: int):
    """What the two trainers read of an env before ``init``."""
    cfg = types.SimpleNamespace(action_space=ACTION_DIM, num_envs=n)
    return types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))


def _trainers(n: int, vision: bool = False, **cfg):
    """A JAX and a torch trainer over the same flax parameters."""
    cfg = dict(hidden=(32, 32), **cfg)
    ppo_j = jppo.PPO(_fake_env(n), jppo.PPOConfig(**cfg))
    ppo_t = tppo.PPO(_fake_env(n), tppo.PPOConfig(**cfg))
    obs = {"proprio_obs": jnp.zeros((1, 14))}
    if vision:
        obs["vision_obs"] = jnp.zeros((1,) + VISION)
    params = ppo_j.net.init(jax.random.PRNGKey(0), obs)
    ppo_t.net = ActorCritic(14, VISION if vision else None, ACTION_DIM, hidden=(32, 32), device="cpu")
    ppo_t.net.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    ppo_t.params = list(ppo_t.net.parameters())
    ppo_t.adam_m = [torch.zeros_like(p) for p in ppo_t.params]
    ppo_t.adam_v = [torch.zeros_like(p) for p in ppo_t.params]
    ppo_t.adam_count = 0
    ppo_t.lr = torch.tensor(ppo_t.cfg.learning_rate)
    return ppo_j, ppo_t, params


def _batch(ppo_j, params, total: int, vision: bool, seed: int = 0):
    """(obs, action, old_logp, old_value, adv, ret_scaled) as numpy: a
    trajectory near the network's own outputs, so that the loss is O(1) and
    ratios and values fall on both sides of their clips."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    obs = {"proprio_obs": f(total, 14)}
    if vision:
        obs["vision_obs"] = rng.uniform(0, 1, (total,) + VISION).astype(np.float32)
    noise = f(total, ACTION_DIM)

    @jax.jit
    def outputs(params, obs):
        mean, log_std, value = ppo_j.net.apply(params, obs)
        return mean + noise, jppo.gaussian_log_prob(mean, log_std, mean + noise), value

    action, logp, value = map(np.asarray, outputs(params, _to_jax(obs)))
    return obs, action, logp + 0.2 * f(total), value + 0.3 * f(total), f(total), value + 0.5 * f(total)


def _to_torch(x):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), x)


def _to_jax(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _assert_trees_close(tree_t, tree_j, atol=ATOL, rtol=0.0):
    leaves_t, _ = jax.tree_util.tree_flatten_with_path(tree_t)
    leaves_j, _ = jax.tree_util.tree_flatten_with_path(tree_j)
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    for (path, a), (_, b) in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol, err_msg=str(path))


@pytest.mark.parametrize("value_preprocessor", [False, True])
def test_gae_matches_jax(value_preprocessor):
    rng = np.random.default_rng(1)
    t, n = 8, 16
    values, rewards = rng.normal(size=(t, n)).astype(np.float32), rng.normal(size=(t, n)).astype(np.float32)
    dones = (rng.random((t, n)) < 0.2).astype(np.float32)
    last = rng.normal(size=(n,)).astype(np.float32)
    ppo_j, ppo_t, _ = _trainers(n, value_preprocessor=value_preprocessor)
    scaler = (np.float32(0.7), np.float32(2.5), np.float32(300.0))
    ts = types.SimpleNamespace(value_scaler=jppo.RunningScaler(*map(jnp.asarray, scaler)))
    adv_j, ret_j = jax.jit(lambda *a: ppo_j._gae(ts, *a))(*map(jnp.asarray, (values, rewards, dones, last)))
    ppo_t.value_scaler = tppo.RunningScaler(*(torch.tensor(v) for v in scaler))
    adv_t, ret_t = ppo_t.gae(*map(torch.from_numpy, (values, rewards, dones, last)))
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), atol=ATOL)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), atol=ATOL)


@pytest.mark.parametrize("clip_predicted_values", [True, False])
@pytest.mark.parametrize("vision", [True, False], ids=["vision", "proprio"])
def test_loss_and_gradient_match_jax(vision, clip_predicted_values):
    ppo_j, ppo_t, params = _trainers(
        32, vision, clip_predicted_values=clip_predicted_values, entropy_loss_scale=0.01
    )
    batch = _batch(ppo_j, params, 32, vision)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(ppo_j._loss, has_aux=True))(params, *_to_jax(batch))
    loss_t, aux_t = ppo_t.loss(_to_torch(batch))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), atol=ATOL)
    for a, b in zip(aux_t, aux_j):
        np.testing.assert_allclose(float(a.detach()), float(b), atol=ATOL)
    grads_t = torch.autograd.grad(loss_t, ppo_t.params)
    named = {name: g for (name, _), g in zip(ppo_t.net.named_parameters(), grads_t)}
    _assert_trees_close(actor_critic_to_flax(named), grads_j, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("grad_norm_clip", [1e-2, 1e3], ids=["norm_above_clip", "norm_below_clip"])
def test_one_epoch_of_update_matches_jax(grad_norm_clip):
    total, n_mb = 64, 4
    ppo_j, ppo_t, params = _trainers(total, mini_batches=n_mb, grad_norm_clip=grad_norm_clip, entropy_loss_scale=0.001)
    flat = _batch(ppo_j, params, total, vision=False, seed=2)
    perm = np.random.default_rng(3).permutation(total)

    # the JAX trainer's epoch (ppo.py: mb_body and the KL rule), written out
    c = ppo_j.cfg

    @jax.jit
    def minibatch(params, opt_state, lr, mb):
        (_, (_, _, _, kl)), grads = jax.value_and_grad(ppo_j._loss, has_aux=True)(params, *mb)
        updates, opt_state = ppo_j.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        return params, opt_state, kl, optax.global_norm(grads)

    opt_state, lr, kl_sum, norms = ppo_j.tx.init(params), jnp.asarray(c.learning_rate), 0.0, []
    for i in range(n_mb):
        idx = perm[i * (total // n_mb) : (i + 1) * (total // n_mb)]
        mb = _to_jax(jax.tree_util.tree_map(lambda x: x[idx], flat))
        params, opt_state, kl, norm = minibatch(params, opt_state, lr, mb)
        norms.append(float(norm))
        kl_sum = kl_sum + kl
    mean_kl = kl_sum / n_mb
    lr = jnp.where(mean_kl > c.kl_threshold * 2.0, jnp.maximum(lr / 1.5, c.lr_min), lr)
    lr = jnp.where(mean_kl < c.kl_threshold * 0.5, jnp.minimum(lr * 1.5, c.lr_max), lr)
    assert all(n > grad_norm_clip for n in norms) or all(n < grad_norm_clip for n in norms), norms

    ppo_t.update(_to_torch(flat), torch.from_numpy(perm)[None])
    _assert_trees_close(actor_critic_to_flax(ppo_t.net.state_dict()), params, atol=ATOL)
    np.testing.assert_allclose(float(ppo_t.lr), float(lr), rtol=1e-6)
    assert float(ppo_t.lr) != c.learning_rate


def test_running_scaler_matches_jax():
    data = np.random.default_rng(0).normal(3.0, 7.0, size=(4, 256)).astype(np.float32)
    sc_j, sc_t = jppo.RunningScaler.init(), tppo.RunningScaler.init()
    for chunk in data:
        sc_j, sc_t = sc_j.update(jnp.asarray(chunk)), sc_t.update(torch.from_numpy(chunk))
    for name in ("mean", "var", "count"):
        np.testing.assert_allclose(float(getattr(sc_t, name)), float(getattr(sc_j, name)), rtol=1e-5)
    x = data[0, :8]
    np.testing.assert_allclose(sc_t.scale(torch.from_numpy(x)).numpy(), np.asarray(sc_j.scale(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(sc_t.unscale(torch.from_numpy(x)).numpy(), np.asarray(sc_j.unscale(jnp.asarray(x))), atol=1e-4)
    # a collapsed variance is floored
    flat = tppo.RunningScaler(torch.tensor(0.0), torch.tensor(1e-9), torch.tensor(10.0))
    np.testing.assert_allclose(float(flat.scale(torch.tensor(1.0))), 100.0, rtol=1e-5)


@pytest.mark.parametrize("task", sorted(jagents.PPO_AGENT_CFGS) + ["TacEx-Unknown-v0"])
def test_agent_cfg_matches_jax(task):
    assert tagents.agent_cfg_for(task, "ppo").to_dict() == jagents.agent_cfg_for(task, "ppo").to_dict()
    over = dict(rollouts=7, learning_rate=None)
    assert tagents.agent_cfg_for(task, **over).to_dict() == jagents.agent_cfg_for(task, **over).to_dict()


def test_agent_cfg_sac_is_not_ported():
    """SAC is ported now: every SAC config, and the default, is the JAX one;
    an unknown algorithm still raises."""
    for task in sorted(jagents.SAC_AGENT_CFGS) + ["TacEx-Unknown-v0"]:
        assert tagents.agent_cfg_for(task, "sac").to_dict() == jagents.agent_cfg_for(task, "sac").to_dict()
    with pytest.raises(ValueError, match="algorithm"):
        tagents.agent_cfg_for("TacEx-Ball-Rolling-Privileged-v0", "ddpg")


@pytest.mark.parametrize("vision", [True, False], ids=["vision", "proprio"])
def test_to_flax_inverts_from_flax(vision):
    _, ppo_t, params = _trainers(4, vision)
    params = jax.tree_util.tree_map(np.asarray, params)
    back = actor_critic_to_flax(actor_critic_from_flax(params))
    _assert_trees_close(back, params, atol=0.0)
    assert set(actor_critic_from_flax(back)) == set(ppo_t.net.state_dict())


def _privileged(n, **cfg):
    env = tenvs.make("TacEx-Ball-Rolling-Privileged-v0", num_envs=n, device="cpu")
    return env, tppo.PPO(env, tppo.PPOConfig(**cfg))


def test_train_step_runs_counts_and_moves_parameters():
    env, ppo = _privileged(8, rollouts=8, mini_batches=4, learning_epochs=2, hidden=(32, 32))
    ppo.init(0)
    before = [p.detach().clone() for p in ppo.params]
    for _ in range(2):
        metrics = ppo.train_step()
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    assert ppo.steps == 2 * 8 * 8
    assert all(float((a - b).abs().max()) > 0.0 for a, b in zip(ppo.params, before))
    assert ppo.cfg.lr_min <= float(metrics["lr"]) <= ppo.cfg.lr_max
    a1, a2 = ppo.act(ppo.obs), ppo.act(ppo.obs)
    assert a1.shape == (8, env.cfg.action_space) and torch.equal(a1, a2)
    assert not torch.equal(ppo.act(ppo.obs, deterministic=False), a1)


def test_same_seed_same_run():
    runs = []
    for _ in range(2):
        _, ppo = _privileged(4, rollouts=4, mini_batches=2, learning_epochs=1, hidden=(16,))
        ppo.init(5)
        runs.append((float(ppo.train_step()["loss"]), [p.detach().clone() for p in ppo.params]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_flagship_vision_env_trains():
    env = tenvs.make("TacEx-Ball-Rolling-Taxim-Fots-v0", num_envs=4, device="cpu")
    ppo = tppo.PPO(env, tppo.PPOConfig(rollouts=4, mini_batches=2, learning_epochs=1, hidden=(32,)))
    ppo.init(1)
    metrics = ppo.train_step()
    assert bool(torch.isfinite(metrics["loss"])) and ppo.net.pi_encoder is not None
    assert ppo.steps == 16
