"""The port's flagship slice against the JAX package: env steps and policy.

Both ``TacEx-Ball-Rolling-Taxim-Fots-v0`` envs run at 4 envs with no action
noise, no observation noise and no domain randomization; the port starts
from the JAX env's post-reset state and both take the same numpy actions.
No env may finish in these steps, so no reset draws random numbers that the
two frameworks would draw differently. State, reward, dones and proprio obs
agree to 1e-5 and the vision obs (tactile RGB x marker dots) under the bin
rule of ``_torch_bins``, except where f32 itself cannot reach 1e-5 (``TOL``):
the world is at ~0.35 m, where one f32 step is 3e-8 m, so a contact depth of
~1e-4 m and a gel indentation carry a few of those steps, which the ball's
angular impulse (1/(m r^2) ~ 1e7) and the servo gain (40) then scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bins import assert_bin_rule, lut_spread, setup_torch
from tacex_tpu import envs as jenvs
from tacex_tpu.render.depth_camera import SdfScene, render_depth_batch
from tacex_tpu.rl.networks import ActorCritic as FlaxActorCritic
from tacex_tpu.sensors.gelsight.taxim import optical as joptical
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.ball_rolling.convert import state_from_numpy
from tacex_tpu_torch.rl.networks import ActorCritic, actor_critic_from_flax

setup_torch()

ENV_ID = "TacEx-Ball-Rolling-Taxim-Fots-v0"
N = 4
STEPS = 3
ATOL = 1e-5
TOL = {
    "arm.qd": 4e-5,  # servo gain 40 x a few f32 steps (2.4e-7) of q at ~3 rad
    "ball_ang": 2e-3,  # relative to max |ball_ang|: impulse from a ~1e-4 m depth
    "indentation_depth": 1e-3,  # mm: ~30 f32 steps of the 0.35 m camera pose
    "Metric/indentation_depth": 1e-3,
}


def _tree_to_numpy(x):
    """A (nested) state dataclass -> nested dict of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: _tree_to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _overrides():
    events = jenvs.ball_rolling.BallRollingEnvCfg().events_cfg
    return dict(num_envs=N, action_noise=0.0, obs_noise_std=0.0, events_cfg={**events, "enabled": False})


def _compare_state(st_t, tree_j, path=""):
    for name, v in tree_j.items():
        if name == "key":
            continue
        if isinstance(v, dict):
            _compare_state(getattr(st_t, name), v, f"{path}{name}.")
            continue
        atol = TOL.get(path + name, ATOL)
        if name == "ball_ang":
            atol *= max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(getattr(st_t, name).numpy(), v, atol=atol, err_msg=path + name)


def _jax_gradients(env, state):
    """The JAX env's tactile gradients for the frame of ``state`` (the
    post-physics state of a step that reset no env)."""
    c = env.cfg
    tool_pos, tool_quat = env._tool_pose(state.arm.q)
    cam_pos, cam_quat = env._camera_pose(tool_pos, tool_quat)
    scene = SdfScene(
        spheres=jnp.concatenate([state.ball_pos, jnp.full((N, 1), c.ball_radius)], -1)[:, None, :],
        boxes=jnp.zeros((N, 1, 10)),
        capsules=jnp.zeros((N, 1, 8)),
        planes=jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0, c.plate_top_z]), (N, 1, 4)),
    )
    from tacex_tpu.envs.ball_rolling.env import CAM_EXTENT

    depth = render_depth_batch(cam_pos, cam_quat, scene, tuple(c.camera_resolution), CAM_EXTENT, far=c.sensor_clipping[1])
    sensor = env.sensor
    hm = sensor.height_map_from_depth(depth)
    shifted = joptical.shift_height_map(hm, sensor.compute_indentation_depth(hm))
    deformed, _ = joptical.compute_gel_deformation(sensor.calib, shifted)
    return joptical.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm)


@pytest.fixture(scope="module")
def rollout():
    env_j = jenvs.make(ENV_ID, **_overrides())
    env_t = tenvs.make(ENV_ID, device="cpu", **_overrides())
    st_j = env_j.init_state(jax.random.PRNGKey(0))
    st_j, obs_j = jax.jit(env_j.reset_all)(st_j)
    st_t = state_from_numpy(_tree_to_numpy(st_j), device="cpu")
    # small random motions under a steady press: every env stays in contact
    # and none finishes within the steps
    actions = np.random.default_rng(0).uniform(-0.02, 0.02, (STEPS, N, 6)).astype(np.float32)
    actions[..., 2] -= 0.05
    step_j, grads_j = jax.jit(env_j.step), jax.jit(lambda s: _jax_gradients(env_j, s))
    steps = []
    for a in actions:
        st_j, obs_j, rew_j, term_j, trunc_j, info_j = step_j(st_j, jnp.asarray(a))
        st_t, obs_t, rew_t, term_t, trunc_t, info_t = env_t.step(st_t, torch.from_numpy(a))
        steps.append(
            dict(
                jax=(_tree_to_numpy(st_j), obs_j, rew_j, term_j, trunc_j, info_j, grads_j(st_j)),
                torch=(st_t, obs_t, rew_t, term_t, trunc_t, info_t),
            )
        )
    return env_j, env_t, steps


@pytest.mark.parametrize("i", range(STEPS))
def test_step_matches_jax(rollout, i):
    env_j, env_t, steps = rollout
    tree_j, obs_j, rew_j, term_j, trunc_j, info_j, (gm_j, gd_j) = steps[i]["jax"]
    st_t, obs_t, rew_t, term_t, trunc_t, info_t = steps[i]["torch"]
    assert not np.any(np.asarray(term_j) | np.asarray(trunc_j)), "an env finished: its reset draws differ"
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    _compare_state(st_t, tree_j)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=ATOL)
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]), atol=ATOL)
    indent_j = np.asarray(info_j["indentation_depth"])
    np.testing.assert_allclose(info_t["indentation_depth"].numpy(), indent_j, atol=TOL["indentation_depth"])
    assert (indent_j > 0).all(), "an env lost contact: the tactile path was not exercised"
    for k, v in info_j["log"].items():
        np.testing.assert_allclose(info_t["log"][k].numpy(), np.asarray(v), atol=TOL.get(k, ATOL), err_msg=k)

    calib = env_t.sensor.calib
    nb = calib.sensor_params.num_bins
    spread = lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb)
    # the two height maps differ by the f32 noise of the camera pose (~2e-7 m
    # of depth), which moves gradients by ~0.014 bins: pixels within 0.05
    # bins of an edge may switch bins
    held = assert_bin_rule(obs_t["vision_obs"], obs_j["vision_obs"], gm_j, gd_j, nb, spread, edge_bins=0.05)
    assert held > 0.2


def test_actor_critic_from_flax_params(rollout):
    _, _, steps = rollout
    _, obs_j, *_ = steps[-1]["jax"]
    st_t, obs_t, *_ = steps[-1]["torch"]
    obs = {k: np.asarray(v) for k, v in obs_j.items()}
    net_j = FlaxActorCritic(action_dim=6)
    params = net_j.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in obs.items()})
    mean_j, log_std_j, value_j = net_j.apply(params, {k: jnp.asarray(v) for k, v in obs.items()})

    net_t = ActorCritic(14, (24, 32, 3), 6, device="cpu")
    net_t.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        mean_t, log_std_t, value_t = net_t({k: torch.from_numpy(v.copy()) for k, v in obs.items()})
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=ATOL)
    np.testing.assert_allclose(log_std_t.numpy(), np.asarray(log_std_j), atol=ATOL)
    np.testing.assert_allclose(value_t.numpy(), np.asarray(value_j), atol=ATOL)
