"""Shared helpers of the coupled FEM+ABD parity tests (``test_torch_coupled_*``,
``test_torch_grasp_lift*``, ``test_torch_factory_uipc*``).

The envs run at 2 envs with no staggered start, fewer Newton and CG
iterations than registered (``NEWTON_ITERS``, ``CG_ITERS``, set through the
env cfg) and the convergence stop off (``velocity_tol = 0``, set on both
sides after ``make``: the stop is a float-noise decision, ROADMAP Queue 3).
The pressed state: the JAX env's reset, the free body placed at a fixed
offset, each pad moved rigidly 0.6 mm toward it (0.4 mm from its faces,
inside the barrier's 1 mm reach) with the squeeze set to match, then one
JAX step under ``ACTIONS``. The port starts from that state, carried over
by ``envs.convert.state_from_numpy``, and both take one more step.

The JAX reference step: the JAX env's own ``step``, run eagerly with its
decimation loop (``jax.lax.fori_loop``) as a Python loop, and its
``CoupledModel.step`` one jitted function shared by every env of a family
(Grasp-Lift, Factory-UIPC) in the process (``jax_step``), as one jit of
its single-env ``_step_single`` called env by env (``per_env_step``).
Tracing and compiling the coupled solve costs ~20 s on the CPU; a jit of
the whole env step would pay it again for each id.

Tolerances:
  * gel positions ``GEL_ATOL`` = 1.5e-5 m, the drift of two f32 CG solves
    (``test_torch_soft_ipc.py``), against ~1e-4 m of motion a step; gel
    velocities that over the step's dt;
  * the body's q ``Q_ATOL`` = 1.5e-5 (its translation in m, its affine
    entries dimensionless), velocities that over dt;
  * the compression images and grip (mm) 1e3 x GEL_ATOL; rewards and
    logged metrics through their slopes in those (``reward_atol``).
"""

from __future__ import annotations

import dataclasses
import functools
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tacex_tpu import envs as jenvs
from tacex_tpu.physics.soft import abd as jabd
from tacex_tpu.physics.soft import ipc as jipc
from tacex_tpu_torch import envs as tenvs
from tacex_tpu_torch.envs.convert import state_from_numpy

N = 2
GRASP_ID = "TacEx-Grasp-Lift-Uipc-v0"
NEWTON_ITERS = 2
CG_ITERS = 8
GEL_ATOL = 1.5e-5
Q_ATOL = 1.5e-5
COMP_ATOL = 1e3 * GEL_ATOL
PRESS = 6e-4
BODY_XY = np.array([[2e-4, -1e-4], [-1.5e-4, 3e-4]], np.float32)
ACTIONS = {
    2: np.array([[1.0, 0.0], [0.5, 0.6]], np.float32),
    4: np.array([[0.2, -0.1, -0.5, 1.0], [-0.3, 0.2, 0.4, 0.5]], np.float32),
}


def tree(x):
    """A JAX state as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def overrides(**kw):
    return dict(num_envs=N, newton_iters=NEWTON_ITERS, cg_iters=CG_ITERS, stagger_initial_episodes=False, **kw)


def _pressed(env, state):
    """The pressed start (see the module docstring) of a JAX env's reset state."""
    grasp = hasattr(state, "cube")
    body = state.cube if grasp else state.peg
    q = np.asarray(body.q).copy()
    q[:, 0, :2] = BODY_XY + (0.0 if grasp else np.asarray(state.mount)[:, :2])
    sgn = np.sign(np.asarray(env._rest_points)[:, 0])
    x = np.asarray(state.gel.x).copy()
    x[..., 0] -= sgn * PRESS
    body = dataclasses.replace(body, q=jnp.asarray(q))
    state = dataclasses.replace(state, gel=dataclasses.replace(state.gel, x=jnp.asarray(x)),
                                squeeze=jnp.full((N,), PRESS))
    return dataclasses.replace(state, **({"cube": body} if grasp else {"peg": body}))


_REAL_FORI_LOOP = jax.lax.fori_loop
_WORLDS: dict = {}


def _python_fori_loop(lower, upper, body, init):
    val = init
    for i in range(lower, upper):
        val = body(i, val)
    return val


def _with_real_loops(fn):
    """``fn`` traced with ``jax.lax.fori_loop`` itself, also when called
    inside ``jax_step``'s Python loop."""

    def traced(*args, **kwargs):
        saved, jax.lax.fori_loop = jax.lax.fori_loop, _REAL_FORI_LOOP
        try:
            return fn(*args, **kwargs)
        finally:
            jax.lax.fori_loop = saved

    return traced


def per_env_step(world):
    """``world.step`` (``CoupledModel.step``) as one jit of its
    ``_step_single`` called env by env: ``step`` is that function's
    ``vmap`` over the envs with these defaults, and the batching pass adds
    ~5 s to the trace (the two agree bit for bit on these scenes)."""
    single = jax.jit(_with_real_loops(world._step_single))

    def step(fem_state, abd_state, scene, aim_pos=None, aim_q=None, aim_strength=None):
        n, B = fem_state.x.shape[0], world.abd.num_bodies
        if aim_pos is None:
            aim_pos = jnp.zeros((n, max(int(world.fem.attachment_verts.shape[0]), 1), 3))
        if aim_q is None:
            aim_q = abd_state.q
        if aim_strength is None:
            aim_strength = jnp.zeros((n, B, 12))
        elif aim_strength.ndim == 2:
            aim_strength = jnp.broadcast_to(aim_strength[..., None], (n, B, 12))
        outs = [single(fem_state.x[e], fem_state.v[e], abd_state.q[e], abd_state.qd[e],
                       jax.tree_util.tree_map(lambda a: a[e], scene), aim_pos[e], aim_q[e], aim_strength[e])
                for e in range(n)]
        x, v, q, qd = (jnp.stack(parts) for parts in zip(*outs))
        return jipc.SoftBodyState(x=x, v=v), jabd.AbdState(q=q, qd=qd)

    return step


def _share_world(env_j):
    """Give the JAX env its family's coupled world, whose ``step`` is jitted
    once for the process (``per_env_step``), and its ``missed_barriers``
    (which the step's log vmaps over the envs) jitted too: the family's envs
    at ``overrides`` build equal worlds (the ids differ only in their
    observations)."""
    key = (type(env_j), env_j.cfg.num_envs, env_j.cfg.newton_iters, env_j.cfg.cg_iters, env_j.cfg.coupling_k)
    if key not in _WORLDS:
        world = env_j.world
        world.step = per_env_step(world)
        world.missed_barriers = jax.jit(world.missed_barriers)
        _WORLDS[key] = world
    env_j.world = _WORLDS[key]


# the JAX env's own helpers that its step calls eagerly, run as one jitted
# function each: run eagerly, each of their operations compiles on its own
# (~7 s of a Grasp-Lift step's first call, with missed_barriers)
_JITTED = ("_observations", "_reset_where", "_aim_positions", "_pad_compression")


def jax_step(env_j, state, action):
    """The JAX env's step (see the module docstring); its observations (the
    GelSight stack in tactile mode) and the other ``_JITTED`` helpers run as
    one jitted function each."""
    for name in _JITTED:
        if not hasattr(getattr(env_j, name), "lower"):
            setattr(env_j, name, jax.jit(getattr(env_j, name)))
    with mock.patch.object(jax.lax, "fori_loop", _python_fori_loop):
        return env_j.step(state, action)


def make_pair(env_id, **kw):
    """The JAX env and the port's (on the CPU) at ``overrides``, both solvers
    at velocity_tol = 0."""
    env_j = jenvs.make(env_id, **overrides(**kw))
    env_t = tenvs.make(env_id, device="cpu", **overrides(**kw))
    _share_world(env_j)
    env_j.world.fem.cfg.velocity_tol = 0.0
    env_t.world.fem.cfg.velocity_tol = 0.0
    return env_j, env_t


@functools.lru_cache(maxsize=None)
def scene(press=PRESS):
    """A Grasp-Lift scene pressed by hand: (JAX env, port env, inputs x, v
    (N, V, 3), q, qd (N, 1, 12), the mount targets and an iterate z_k a
    seeded small step from the start). Each pad is moved ``press`` toward
    the cube, the gel and the cube's pose jittered by seeded noise."""
    env_j, env_t = make_pair(GRASP_ID)
    rng = np.random.default_rng(7)
    rest = np.asarray(env_j._rest_points)
    sgn = np.sign(rest[:, 0])
    x = np.broadcast_to(rest, (N,) + rest.shape).copy()
    x[..., 0] -= sgn * press
    x += rng.normal(0, 2e-5, x.shape)
    v = rng.normal(0, 2e-3, x.shape)
    q = np.zeros((N, 1, 12))
    q[:, 0, 3:] = np.eye(3).reshape(9) + rng.normal(0, 2e-3, (N, 9))
    q[:, 0, :3] = rng.uniform(-2e-4, 2e-4, (N, 3))
    qd = rng.normal(0, 1e-2, q.shape)
    squeeze = np.full((N,), press, np.float32)
    aim = np.asarray(env_j._aim_positions(jnp.asarray(squeeze), jnp.zeros(N)))
    z0 = np.concatenate([x.reshape(N, -1), q.reshape(N, -1)], 1)
    z_k = z0 + rng.normal(0, 5e-5, z0.shape)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return env_j, env_t, tuple(map(f32, (x, v, q, qd, aim, z_k)))


@functools.lru_cache(maxsize=None)
def pair(env_id, **kw):
    """(JAX env, port env, the pressed JAX state after one step), both
    solvers at velocity_tol = 0."""
    env_j, env_t = make_pair(env_id, **kw)
    st, _ = jax.jit(env_j.reset_all)(env_j.init_state(jax.random.PRNGKey(0)))
    st = jax_step(env_j, _concrete(_pressed(env_j, st)), jnp.asarray(ACTIONS[env_j.cfg.action_space]))[0]
    return env_j, env_t, _concrete(st)


def _concrete(state):
    """The state with every leaf a plain device array of its numpy dtype, so
    that the jitted solve sees the same input types on every call (a weak
    type left by a reset would trace and compile it again)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), state)


def port_state(env_t, st_j):
    return state_from_numpy(type(env_t.init_state()), tree(st_j), device="cpu")


@functools.lru_cache(maxsize=None)
def one_step(env_id, **kw):
    """One step of both envs from the pressed JAX state: (env_j, env_t,
    JAX outputs, port outputs, the JAX state before the step)."""
    env_j, env_t, st_j = pair(env_id, **kw)
    a = ACTIONS[env_j.cfg.action_space]
    out_j = jax_step(env_j, st_j, jnp.asarray(a))
    out_t = env_t.step(port_state(env_t, st_j), torch.from_numpy(a))
    return env_j, env_t, out_j, out_t, st_j


def reward_atol(env) -> float:
    """The reward's and the metrics' tolerance: their largest slope in the
    grip (mm) times COMP_ATOL, and in the body's height (m) times Q_ATOL."""
    c = env.cfg
    if hasattr(c, "w_grip"):
        return c.w_grip / c.grip_target_mm * COMP_ATOL + c.w_lift / c.lift_target * Q_ATOL + 1e-6
    # the slope of squash(x, a, 2) = 1 / (2 cosh(ax) + 2) is below a / 4
    return sum(s * a / 4.0 for s, a in zip(c.kp_scale, c.kp_coef)) * Q_ATOL + 1e-6


def check_step(stepped, body: str) -> None:
    """State, reward, dones and logged metrics of one compared step."""
    env_j, env_t, out_j, out_t, _ = stepped
    st_j, obs_j, rew_j, term_j, trunc_j, info_j = out_j
    st_t, obs_t, rew_t, term_t, trunc_t, info_t = out_t
    assert not np.any(np.asarray(term_j) | np.asarray(trunc_j)), "an env finished: its reset draws differ"
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    dt = env_j.cfg.sim_dt
    np.testing.assert_allclose(st_t.gel.x.numpy(), np.asarray(st_j.gel.x), atol=GEL_ATOL, rtol=0)
    np.testing.assert_allclose(st_t.gel.v.numpy(), np.asarray(st_j.gel.v), atol=GEL_ATOL / dt, rtol=0)
    bj, bt = getattr(st_j, body), getattr(st_t, body)
    np.testing.assert_allclose(bt.q.numpy(), np.asarray(bj.q), atol=Q_ATOL, rtol=0)
    np.testing.assert_allclose(bt.qd.numpy(), np.asarray(bj.qd), atol=Q_ATOL / dt, rtol=0)
    for name in ("squeeze", "episode_length", "ep_succeeded", "actions", "prev_actions"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)), atol=1e-7,
                                   err_msg=name)
    atol = reward_atol(env_j)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=atol, rtol=0)
    np.testing.assert_allclose(info_t["grip"].numpy(), np.asarray(info_j["grip"]), atol=COMP_ATOL, rtol=0)
    assert set(info_t["log"]) == set(info_j["log"])
    for k, v in info_j["log"].items():
        tol = COMP_ATOL if k == "Metric/grip_mm" else 1e3 * Q_ATOL if k.endswith("_z_mm") else atol
        np.testing.assert_allclose(info_t["log"][k].numpy(), np.asarray(v), atol=tol, err_msg=k)
    assert (np.asarray(info_j["grip"]) > 0.05).all(), "the pads do not press the body"


def check_obs(stepped) -> None:
    """Proprio obs and the compression images (depth mode)."""
    env_j, _, out_j, out_t, _ = stepped
    obs_j, obs_t = out_j[1], out_t[1]
    assert set(obs_t) == set(obs_j)
    for k in obs_j:
        assert tuple(obs_t[k].shape) == np.asarray(obs_j[k]).shape, k
    # proprio entries in mm (grip), cm (lift, mount, the tip offset) or m/s
    np.testing.assert_allclose(obs_t["proprio_obs"].numpy(), np.asarray(obs_j["proprio_obs"]),
                               atol=COMP_ATOL, rtol=0)
    if env_j.cfg.obs_mode == "depth":
        np.testing.assert_allclose(obs_t["vision_obs"].numpy(), np.asarray(obs_j["vision_obs"]), atol=COMP_ATOL,
                                   rtol=0)


def restore_policy(ckpt):
    """The committed PPO checkpoint's params (orbax; read by the JAX side only)."""
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore(ckpt)["params"]


def check_policy(ckpt, obs_j, action_dim) -> None:
    """The committed policy gives JAX's deterministic actions on the same
    observations in the port, to 1e-5."""
    from tacex_tpu.rl.networks import ActorCritic as JActorCritic
    from tacex_tpu_torch.rl.networks import ActorCritic, actor_critic_from_flax

    params = restore_policy(ckpt)
    obs = {k: np.asarray(v) for k, v in obs_j.items()}
    apply = jax.jit(JActorCritic(action_dim=action_dim).apply)
    mean_j = np.asarray(apply(params, {k: jnp.asarray(v) for k, v in obs.items()})[0])
    vision = obs["vision_obs"].shape[1:] if "vision_obs" in obs else None
    net = ActorCritic(obs["proprio_obs"].shape[-1], vision, action_dim, device="cpu")
    net.load_state_dict(actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        mean_t = net({k: torch.from_numpy(v) for k, v in obs.items()})[0].numpy()
    np.testing.assert_allclose(mean_t, mean_j, atol=1e-5, rtol=0)
    assert np.abs(mean_j).max() > 0.05, "the policy's actions are all near zero"
