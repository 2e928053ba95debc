"""The four options the port took last, against the JAX package on the CPU:
``ActorCritic(shared_trunk=True)``, ``render(orig_hm_fmt=True)``,
``shade``/``render(lut_dtype=bfloat16)`` (dense and compact) and
``DirectRLEnv.rollout``.

Tolerances: the network's outputs 1e-5 and its gradients 1e-5 with rtol
1e-4 (``tests/test_torch_ppo.py``'s: the same f32 arithmetic summed in
another order); images under the bin rule of ``tests/_torch_bins.py``; the
5-step pole rollout as ``tests/test_torch_pole.py`` holds one step (state,
observations and reward 1e-5), with the contact-driven velocities it
compounds over 5 steps left to the state it moves.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import assert_bin_rule, lut_spread, setup_torch
from tacex_tpu import envs as jenvs
from tacex_tpu.rl.networks import ActorCritic as FlaxActorCritic
from tacex_tpu.sensors.gelsight.taxim import calib as jcalib
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.convert import state_from_numpy
from tacex_tpu_torch.envs.pole_balancing.env import PoleBalancingState
from tacex_tpu_torch.rl.networks import ActorCritic, actor_critic_from_flax, actor_critic_to_flax
from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
from tacex_tpu_torch.sensors.gelsight.taxim import optical as toptical
from test_torch_ppo import _assert_trees_close
from test_torch_shading import _frame, _press_maps

setup_torch()

ATOL = 1e-5
HW = (48, 64)
VISION = (24, 32, 3)
POLE_ID, POLE_ENVS, POLE_STEPS = "TacEx-Pole-Balancing-Base-v0", 4, 5


# ------------------------------------------------------------- shared trunk


@pytest.mark.parametrize("vision", [True, False], ids=["vision", "proprio"])
def test_shared_trunk_matches_jax(vision):
    """One encoder and one tower feed both heads: flax names them
    ``VisionEncoder_0``, ``Dense_0..h-1``, then the mean and value heads;
    the outputs and the gradients of every parameter match, and the
    converters invert each other."""
    rng = np.random.default_rng(0)
    obs = {"proprio_obs": rng.normal(size=(6, 14)).astype(np.float32)}
    if vision:
        obs["vision_obs"] = rng.uniform(0, 1, (6,) + VISION).astype(np.float32)
    net_j = FlaxActorCritic(action_dim=5, hidden=(32, 16), shared_trunk=True)
    params = net_j.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in obs.items()})
    names = sorted(params["params"])
    assert names == sorted(["Dense_0", "Dense_1", "Dense_2", "Dense_3", "log_std"] + ["VisionEncoder_0"] * vision)

    def scalar(p, o):
        mean, log_std, value = net_j.apply(p, o)
        return (mean * jnp.arange(1.0, 6.0)).sum() + (value**2).sum() + log_std.sum(), (mean, value)

    (_, (mean_j, value_j)), grads_j = jax.jit(jax.value_and_grad(scalar, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in obs.items()})

    net_t = ActorCritic(14, VISION if vision else None, 5, hidden=(32, 16), shared_trunk=True, device="cpu")
    sd = actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params), shared_trunk=True)
    net_t.load_state_dict(sd)
    assert net_t.v_tower is None and net_t.v_encoder is None
    mean_t, log_std_t, value_t = net_t({k: torch.from_numpy(v) for k, v in obs.items()})
    np.testing.assert_allclose(mean_t.detach().numpy(), np.asarray(mean_j), atol=ATOL)
    np.testing.assert_allclose(value_t.detach().numpy(), np.asarray(value_j), atol=ATOL)
    loss = (mean_t * torch.arange(1.0, 6.0)).sum() + (value_t**2).sum() + log_std_t.sum()
    grads_t = torch.autograd.grad(loss, list(net_t.parameters()))
    named = {name: g for (name, _), g in zip(net_t.named_parameters(), grads_t)}
    _assert_trees_close(actor_critic_to_flax(named), grads_j, atol=ATOL, rtol=1e-4)
    _assert_trees_close(actor_critic_to_flax(net_t.state_dict()), params)


# ------------------------------------------------------------------ optical


def _rule(cal_j, cal_t, hm):
    """The bin rule's inputs for renders of ``hm``: JAX's gradients, both
    sides' bins and the LUT's spread."""
    frame_j = [np.array(x) for x in jax.jit(lambda x: _frame(joptical, cal_j, x))(jnp.asarray(hm))]
    frame_t = _frame(toptical, cal_t, torch.from_numpy(hm))
    nb = cal_t.sensor_params.num_bins
    gm_j, gd_j = frame_j[3], frame_j[4]
    bins = dict(
        bins_t=[b.numpy() for b in toptical.lut_bins(cal_t, frame_t[3], frame_t[4])],
        bins_j=[b.numpy() for b in toptical.lut_bins(cal_t, torch.from_numpy(gm_j), torch.from_numpy(gd_j))],
    )
    spread = lut_spread(cal_t.poly_lut.numpy(), cal_t.features.numpy(), nb)
    return (gm_j, gd_j, nb, spread), bins


@pytest.fixture(scope="module")
def optics():
    cal_j, cal_t = jcalib.load_calib().at_resolution(HW), tcalib.load_calib().at_resolution(HW)
    hm = _press_maps(2)
    return cal_j, cal_t, hm, *_rule(cal_j, cal_t, hm)


def test_orig_hm_fmt_render_matches_jax(optics):
    """A height map in the original Taxim format (``gel_map_shift - hm``)
    renders as JAX renders it, and as the processed map it stands for. The
    two calibrations' ``gel_map_shift`` (the blurred gel map's maximum) lie
    one f32 step apart (the blur sums in another order), which moves every
    height by 4.8e-7 mm: the port's calibration takes JAX's shift here, so
    that both sides render one map."""
    cal_j, cal_t, hm = optics[:3]
    cal_t = dataclasses.replace(cal_t, gel_map_shift=cal_j.gel_map_shift)
    orig = (np.float32(cal_t.gel_map_shift) - hm).astype(np.float32)
    back = np.float32(cal_t.gel_map_shift) - orig  # the processed map, f32-rounded on the way
    rule, bins = _rule(cal_j, cal_t, back)
    rgb_j = np.asarray(jax.jit(lambda x: joptical.render(cal_j, x, orig_hm_fmt=True))(jnp.asarray(orig)))
    rgb_t = toptical.render(cal_t, torch.from_numpy(orig), orig_hm_fmt=True).numpy()
    assert assert_bin_rule(rgb_t, rgb_j, *rule, **bins) > 0.3
    np.testing.assert_array_equal(rgb_t, toptical.render(cal_t, torch.from_numpy(back)).numpy())


@pytest.mark.parametrize("compact", [None, 256], ids=["dense", "compact"])
def test_bf16_lut_render_matches_jax(optics, compact):
    """``lut_dtype=bfloat16`` rounds the full table (the compact path's
    125-row subtable stays f32, as in JAX): the image matches JAX's under
    the bin rule, and moves off the f32 image."""
    cal_j, cal_t, hm, rule, bins = optics
    kw = dict(compact_capacity=compact)
    rgb_j = np.asarray(jax.jit(lambda x: joptical.render(cal_j, x, lut_dtype=jnp.bfloat16, **kw))(jnp.asarray(hm)))
    rgb_t = toptical.render(cal_t, torch.from_numpy(hm), lut_dtype=torch.bfloat16, **kw).numpy()
    assert assert_bin_rule(rgb_t, rgb_j, *rule, **bins) > 0.3
    f32 = toptical.render(cal_t, torch.from_numpy(hm), **kw).numpy()
    assert 1e-4 < np.abs(rgb_t - f32).max() < 0.02
    with pytest.raises(ValueError, match="lut_dtype"):
        toptical.render(cal_t, torch.from_numpy(hm), lut_dtype=torch.float16)


def test_bf16_plain_shade_reads_the_rounded_table():
    """The kernel's plain version on a bf16 table is the f32 version on the
    table rounded to bf16 and widened back (the CUDA entry's contract)."""
    from tacex_tpu_torch.ops.lut_shade import lut_shade, lut_shade_plain

    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 300, (3, 40)).astype(np.int32))
    feats = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(300, 18)).astype(np.float32))
    out = lut_shade(idx, feats, table.to(torch.bfloat16))
    assert torch.equal(out, lut_shade_plain(idx, feats, table.to(torch.bfloat16).to(torch.float32)))
    assert out.dtype == torch.float32 and not torch.equal(out, lut_shade(idx, feats, table))


# ------------------------------------------------------------------ rollout


def _tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def test_rollout_matches_jax_rollout_fn():
    """``DirectRLEnv.rollout`` against JAX's ``rollout_fn`` on pole
    balancing: 4 envs x 5 steps from JAX's post-reset state under the same
    numpy actions, every output stacked (T, N, ...)."""
    kw = dict(num_envs=POLE_ENVS, action_noise=0.0, obs_noise_std=0.0)
    env_j, env_t = jenvs.make(POLE_ID, **kw), tenvs.make(POLE_ID, device="cpu", **kw)
    actions = np.random.default_rng(0).uniform(-0.3, 0.3, (POLE_STEPS, POLE_ENVS, 6)).astype(np.float32)

    def reset_rollout(state, a):
        state, _ = env_j.reset_all(state)
        return state, env_j.rollout_fn(POLE_STEPS)(state, a)

    st0_j, (st_j, (obs_j, rew_j, term_j, trunc_j)) = jax.jit(reset_rollout)(
        env_j.init_state(jax.random.PRNGKey(0)), jnp.asarray(actions))
    st0_t = state_from_numpy(PoleBalancingState, _tree(st0_j), device="cpu")
    st_t, (obs_t, rew_t, term_t, trunc_t) = env_t.rollout(st0_t, torch.from_numpy(actions))
    assert rew_t.shape == (POLE_STEPS, POLE_ENVS) and obs_t["vision_obs"].shape == (POLE_STEPS, POLE_ENVS, 32, 32, 1)
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=ATOL)
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)
    np.testing.assert_allclose(obs_t["vision_obs"].numpy(), np.asarray(obs_j["vision_obs"]), atol=ATOL)
    tree = _tree(st_j)
    for f in ("pole_pos", "pole_quat", "actions"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(), tree[f], atol=ATOL, err_msg=f)
    np.testing.assert_allclose(st_t.arm.q.numpy(), tree["arm"]["q"], atol=ATOL)
    # the rollout is the loop of steps it stands for
    st_loop = st0_t
    for a in actions:
        st_loop, *_ = env_t.step(st_loop, torch.from_numpy(a))
    assert torch.equal(st_loop.pole_pos, st_t.pole_pos)
