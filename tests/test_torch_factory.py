"""One whole step of ``TacEx-Factory-PegInsert-Direct-v0`` in the port
against the JAX env, and the Factory ids' registration.

The JAX env resets and steps under one jit at 2 envs; the port starts from
its post-reset state (carried over by ``envs.convert.state_from_numpy``)
and takes the same numpy action: 8 rounds of operational-space control and
8 contact substeps of the held peg, the peg's mesh rendered from both
fingers, the 32x32 sensor on the 4 images, rewards and observations. No env
finishes, so no reset draws random numbers.

Tolerances: joint angles and positions 1e-5 (rad, m), joint rates and the
peg's velocities 1e-4 relative to their largest value: the world sits 0.6 m
out (one f32 step is 6e-8 m) and 16 implicit 9x9 solves a step carry that
noise into the rates. Proprio obs, rewards and the keypoint log 1e-5.
The tactile images under the bin rule of ``_torch_bins``, with the margin
of ``test_torch_env.py`` (0.05 bins): both sides render their own depth
from poses that differ by f32 noise. The peg's axis lies along the image's
rows, so its gradients point along an image axis, where the direction bins
have an edge: the rule exempts those pixels from 1e-4 and holds them to the
LUT's magnitude-bin-0 spread.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import assert_bin_rule, lut_spread, setup_torch
from tacex_tpu import envs as jenvs
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.convert import state_from_numpy
from tacex_tpu_torch.envs.factory.env import FactoryState

setup_torch()

ENV_ID = "TacEx-Factory-PegInsert-Direct-v0"
FACTORY_IDS = [ENV_ID, "TacEx-Factory-GearMesh-Direct-v0", "TacEx-Factory-NutThread-Direct-v0"]
N = 2
ATOL = 1e-5
RATE_RTOL = 1e-4


def _tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


@pytest.fixture(scope="module")
def stepped():
    env_j = jenvs.make(ENV_ID, num_envs=N)
    env_t = tenvs.make(ENV_ID, num_envs=N, device="cpu")
    action = np.random.default_rng(0).uniform(-0.5, 0.5, (N, 6)).astype(np.float32)
    action[:, 2] = -0.8  # toward the hole

    def reset_step(state, a):
        state, _ = env_j.reset_all(state)
        return state, env_j.step(state, a)

    st0_j, out_j = jax.jit(reset_step)(env_j.init_state(jax.random.PRNGKey(0)), jnp.asarray(action))
    st0_t = state_from_numpy(FactoryState, _tree(st0_j), device="cpu")
    out_t = env_t.step(st0_t, torch.from_numpy(action))
    return env_j, env_t, out_j, out_t


def _jax_gradients(env, state):
    """The JAX env's tactile gradients for the finger images of ``state``."""
    sensor = env.sensor
    hm = sensor.height_map_from_depth(env._finger_depths(state.arm, state.held))
    shifted = joptical.shift_height_map(hm, sensor.compute_indentation_depth(hm))
    deformed, _ = joptical.compute_gel_deformation(sensor.calib, shifted)
    return joptical.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm)


def _compare(name, a, b, rates=False):
    b = np.asarray(b)
    atol = RATE_RTOL * max(1.0, float(np.abs(b).max())) if rates else ATOL
    np.testing.assert_allclose(a.numpy(), b, atol=atol, err_msg=name)


def test_one_step_matches_jax(stepped):
    env_j, env_t, (st_j, obs_j, rew_j, term_j, trunc_j, info_j), (st_t, obs_t, rew_t, term_t, trunc_t, info_t) = stepped
    assert not np.any(np.asarray(term_j) | np.asarray(trunc_j)), "an env finished: its reset draws differ"
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    tree = _tree(st_j)
    for group, fields in (("arm", ("q", "q_target")), ("held", ("pos", "quat"))):
        for f in fields:
            _compare(f"{group}.{f}", getattr(getattr(st_t, group), f), tree[group][f])
    _compare("arm.qd", st_t.arm.qd, tree["arm"]["qd"], rates=True)
    for f in ("linvel", "angvel"):
        _compare(f"held.{f}", getattr(st_t.held, f), tree["held"][f], rates=True)
    for f in ("grip_offset", "fixed_pos", "fixed_quat", "ctrl_target", "ema_target", "actions", "prev_actions"):
        _compare(f, getattr(st_t, f), tree[f])
    np.testing.assert_array_equal(st_t.episode_length.numpy(), tree["episode_length"])
    np.testing.assert_array_equal(st_t.ep_succeeded.numpy(), tree["ep_succeeded"])
    assert np.abs(tree["arm"]["q"] - np.asarray(env_j.init_state(jax.random.PRNGKey(0)).arm.q)).max() > 1e-3

    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=ATOL)
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)
    for k, v in info_j["log"].items():
        np.testing.assert_allclose(info_t["log"][k].numpy(), np.asarray(v), atol=ATOL, err_msg=k)

    vis_t, vis_j = obs_t["vision_obs"].numpy(), np.asarray(obs_j["vision_obs"])
    assert vis_t.shape == vis_j.shape == (N, 32, 32, 6)
    # (N, 32, 32, 6) -> the sensor's (2N, 32, 32, 3): [left N | right N]
    fingers = lambda v: np.concatenate([v[..., :3], v[..., 3:]], axis=0)
    gm_j, gd_j = jax.jit(lambda s: _jax_gradients(env_j, s))(st_j)
    calib = env_t.sensor.calib
    nb = calib.sensor_params.num_bins
    spread = lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb)
    assert_bin_rule(fingers(vis_t), fingers(vis_j), gm_j, gd_j, nb, spread, edge_bins=0.05)
    pressed = (np.tan(np.asarray(gm_j)) > 1e-3).reshape(2, N, -1).mean(-1).max(0)
    assert (pressed > 0.02).all(), "an env's fingers show no contact: the tactile path was not exercised"


def test_factory_ids_are_registered_with_the_jax_configs():
    from tacex_tpu.envs.base import _REGISTRY as registry_j
    from tacex_tpu_torch.envs.base import _REGISTRY as registry_t

    for env_id in FACTORY_IDS:
        cfg_t, cfg_j = registry_t[env_id][1](), registry_j[env_id][1]()
        assert cfg_t.to_dict() == cfg_j.to_dict(), env_id
    assert "TacEx-Factory-PegInsert-Uipc-v0" in registry_t  # the coupled world is ported
    env = tenvs.make("TacEx-Factory-NutThread-Direct-v0", num_envs=2, device="cpu")
    assert env.sensor.num_envs == 4 and env._tris.shape[1:] == (3, 3)
