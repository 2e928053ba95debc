"""Env-axis data parallelism (``tacex_tpu_torch/parallel``) on 2 gloo ranks
of the CPU, against one process and against the JAX package.

The ranks are spawned once for the module (``tests/_torch_parallel.py``);
while they run, this process computes the references: the JAX epoch of
``PPO.update`` and JAX's GAE on the concatenated trajectory, and the
single-process env steps from the states the ranks slice. The rollout's
draws differ by rank, so the update, the reductions and the physics are
held, not a whole iteration.

Tolerances: the update and GAE as ``tests/test_torch_ppo.py`` (atol 1e-5:
the same f32 arithmetic summed in another order); the ranks' parameters
exactly (every rank applies the same all-reduced gradient); the rigid and
Factory steps 1e-5 (a step of 2 envs against two steps of 1: the same
arithmetic, batched otherwise); Grasp-Lift rtol 1e-3, atol 2e-5, as
``tests/test_multichip.py`` holds its sharded coupled solve.
"""

import dataclasses
import os
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_parallel as P
from _torch_bins import setup_torch
from tacex_tpu.rl import ppo as jppo
from tacex_tpu_torch.parallel import dryrun, mesh
from tacex_tpu_torch.parallel.group import EnvGroup, init_env_parallel
from tacex_tpu_torch.rl import SAC, SACConfig
from tacex_tpu_torch.rl.networks import actor_critic_from_flax, actor_critic_to_flax
from test_torch_ppo import ACTION_DIM, _assert_trees_close, _batch, _to_jax, _trainers

setup_torch()

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
T, N = 4, 8  # the update's trajectory: 32 rows, 4 minibatches of 8
UPDATE_CFG = dict(hidden=(32, 32), mini_batches=4, entropy_loss_scale=0.01, value_preprocessor=True)


def _perm() -> np.ndarray:
    """A permutation of the T N rows whose first minibatch holds only rows of
    the first rank's envs (n < N / 2): the second rank owns none of it."""
    rng = np.random.default_rng(3)
    rows = np.arange(T * N)
    first = rng.permutation(rows[rows % N < N // 2])[:8]
    return np.concatenate([first, rng.permutation(np.setdiff1d(rows, first))])


def _update_inputs():
    ppo_j, _, params = _trainers(T * N, **{k: v for k, v in UPDATE_CFG.items() if k != "hidden"})
    flat = _batch(ppo_j, params, T * N, vision=False, seed=2)
    rng = np.random.default_rng(4)
    gae = (rng.normal(size=(T, N)).astype(np.float32), rng.normal(size=(T, N)).astype(np.float32),
           (rng.random((T, N)) < 0.2).astype(np.float32), rng.normal(size=(N,)).astype(np.float32))
    common = {"num_envs": N, "action_dim": ACTION_DIM, "cfg": UPDATE_CFG,
              "net": actor_critic_from_flax(jax.tree_util.tree_map(np.asarray, params))}
    shaped = lambda x: x.reshape((T, N) + x.shape[1:])
    traj = ({k: shaped(v) for k, v in flat[0].items()}, [shaped(x) for x in flat[1:]])
    scaler = (torch.tensor(0.7), torch.tensor(2.5), torch.tensor(300.0))
    return ppo_j, params, flat, gae, {
        "update": {**common, "traj": traj, "perms": _perm()[None]},
        "gae": {**common, "gae": gae, "scaler": scaler},
    }


def _jax_epoch(ppo_j, params, flat, perm):
    """The JAX trainer's epoch (ppo.py: mb_body and the KL rule), written out
    as ``tests/test_torch_ppo.py`` writes it."""
    import optax

    c = ppo_j.cfg
    n_mb = c.mini_batches
    mb_size = len(perm) // n_mb

    @jax.jit
    def minibatch(params, opt_state, lr, mb):
        (_, (_, _, _, kl)), grads = jax.value_and_grad(ppo_j._loss, has_aux=True)(params, *mb)
        updates, opt_state = ppo_j.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, jax.tree_util.tree_map(lambda u: -lr * u, updates)), opt_state, kl

    opt_state, lr, kl_sum = ppo_j.tx.init(params), jnp.asarray(c.learning_rate), 0.0
    for i in range(n_mb):
        idx = perm[i * mb_size : (i + 1) * mb_size]
        params, opt_state, kl = minibatch(params, opt_state, lr, _to_jax(jax.tree_util.tree_map(lambda x: x[idx], flat)))
        kl_sum = kl_sum + kl
    mean_kl = kl_sum / n_mb
    lr = jnp.where(mean_kl > c.kl_threshold * 2.0, jnp.maximum(lr / 1.5, c.lr_min), lr)
    return params, jnp.where(mean_kl < c.kl_threshold * 0.5, jnp.minimum(lr * 1.5, c.lr_max), lr)


def _single_steps(scenes):
    """The env cases stepped by one process from the whole states."""
    out = {}
    e = P.env(P.CURRICULUM_ID, P.CURRICULUM_ENVS, **P.QUIET)
    out["curriculum"] = P.steps(e, scenes["curriculum"]["state"], scenes["curriculum"]["action"])
    e = P.env(P.GRASP_ID, P.GRASP_ENVS, **P.GRASP_CFG)
    out["grasp"] = P.steps(e, scenes["grasp"]["state"], scenes["grasp"]["action"], P.GRASP_STEPS)
    e = P.env(P.PEG_ID, P.PEG_ENVS)
    out["peg"] = P.steps(e, scenes["peg"]["state"], scenes["peg"]["action"])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 2 ranks, compute the references meanwhile, and return
    (the ranks' results, the references)."""
    tmp = tmp_path_factory.mktemp("parallel")
    ppo_j, params, flat, gae, inputs = _update_inputs()
    scenes = P.scenes()
    torch.save({**inputs, **scenes}, tmp / "inputs.pt")
    ctx = dryrun.start_ranks(P.run_rank, P.WORLD, (str(tmp / "pg"), str(tmp / "inputs.pt"), str(tmp)))
    try:
        refs = {"epoch": _jax_epoch(ppo_j, params, flat, inputs["update"]["perms"][0]), "steps": _single_steps(scenes)}
        sc = jppo.RunningScaler(*(jnp.asarray(float(v)) for v in inputs["gae"]["scaler"]))
        ts = type("TS", (), {"value_scaler": sc})()
        adv, ret = jax.jit(lambda *a: ppo_j._gae(ts, *a))(*map(jnp.asarray, gae))
        new = jppo.RunningScaler(*(jnp.asarray(float(v)) for v in inputs["gae"]["scaler"])).update(ret)
        refs["gae"] = (np.asarray(adv), np.asarray(ret), tuple(float(v) for v in (new.mean, new.var, new.count)))
    finally:
        dryrun.join_ranks(ctx, P.JOIN_TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(P.WORLD)]
    return ranks, refs, scenes


def _case(run, name):
    ranks = run[0]
    for r, res in enumerate(ranks):
        if "error" in res[name]:
            pytest.fail(f"rank {r}, case {name}:\n{res[name]['error']}")
    return [res[name] for res in ranks]


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        return {}
    return {k: v for name, sub in items for k, v in _leaves(sub, f"{prefix}.{name}").items()}


def _assert_states_close(a, b, atol, rtol=0.0):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_allclose(la[k].double().numpy(), lb[k].double().numpy(), atol=atol, rtol=rtol, err_msg=k)


def test_dryrun_train_step_on_two_ranks(run):
    """``dryrun.train_step_on``, the body of ``python -m
    tacex_tpu_torch.parallel.dryrun``: finite loss, the global env steps,
    and one loss on both ranks."""
    a, b = _case(run, "dryrun")
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    assert a["steps"] == b["steps"] == 2 * (2 * P.WORLD)


def test_update_matches_the_jax_epoch_on_the_whole_trajectory(run):
    """Each rank's ``PPO.update`` on its slice, with the global permutation
    (its first minibatch holds none of the second rank's rows), equals the
    JAX epoch on the concatenated trajectory, with the entropy term and the
    value preprocessor on; the ranks' parameters are identical."""
    perm = _perm()
    assert (perm[:8] % N < N // 2).all()
    a, b = _case(run, "update")
    for k in a["net"]:
        assert torch.equal(a["net"][k], b["net"][k]), k
    params_j, lr_j = run[1]["epoch"]
    _assert_trees_close(actor_critic_to_flax(a["net"]), params_j, atol=ATOL)
    np.testing.assert_allclose(float(a["lr"]), float(lr_j), rtol=1e-6)
    assert float(a["lr"]) == float(b["lr"]) and float(a["loss"]) == float(b["loss"])


def test_advantage_normalisation_and_value_scaler_are_global(run):
    """GAE's normalisation takes the mean and biased std over T x every
    rank's envs, and the value scaler the global moments and count: the
    ranks' slices joined equal JAX's GAE and scaler on the whole batch."""
    a, b = _case(run, "gae")
    adv_j, ret_j, scaler_j = run[1]["gae"]
    np.testing.assert_allclose(torch.cat([a["adv"], b["adv"]], 1).numpy(), adv_j, atol=ATOL)
    np.testing.assert_allclose(torch.cat([a["ret"], b["ret"]], 1).numpy(), ret_j, atol=ATOL)
    for x, y, ref in zip(a["scaler"], b["scaler"], scaler_j):
        assert float(x) == float(y)
        np.testing.assert_allclose(float(x), ref, rtol=1e-5)


def test_curriculum_reads_the_mean_over_every_rank(run):
    """The flagship's curriculum from slices of one 4-env state: the global
    mean episode reward crosses every threshold, the second rank's own mean
    none; every rank takes the single process's levels, and its step."""
    a, b = _case(run, "curriculum")
    state, _, reward = run[1]["steps"]["curriculum"]
    assert state.curriculum.tolist() == [1, 1, 1]
    assert float(np.mean(P.CURRICULUM_TOTALS[2:])) < 550.0  # the second rank's local mean would not move
    for res in (a, b):
        assert res["local_curriculum"].tolist() == [1, 1, 1]
    _assert_states_close(a["state"], state, atol=ATOL)
    np.testing.assert_allclose(a["reward"].numpy(), reward.numpy(), atol=ATOL)


def test_grasp_lift_steps_from_slices_match_one_process(run):
    """Two tactile Grasp-Lift steps on each rank's env from its slice of one
    process's state equal that process's two steps; the sensor's 2N
    pad-major rows reach rank r as rows r and N + r."""
    ranks = _case(run, "grasp")
    n = P.GRASP_ENVS
    marked = run[2]["grasp"]["state"].sensor
    for r, res in enumerate(ranks):
        assert torch.equal(res["local_sensor"].traj_start, marked.traj_start[[r, n + r]])
        assert torch.equal(res["local_sensor"].traj_count, marked.traj_count[[r, n + r]])
    state, obs, reward = run[1]["steps"]["grasp"]
    _assert_states_close(ranks[0]["state"], state, atol=2e-5, rtol=1e-3)
    _assert_states_close(ranks[0]["obs"], obs, atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(ranks[0]["reward"].numpy(), reward.numpy(), atol=2e-5, rtol=1e-3)


def test_peg_insert_step_from_slices_matches_one_process(run):
    """One PegInsert step of 1 env a rank (its env's 2N finger cameras and
    scene primitives built for that one env) equals one step of 2 envs."""
    a, _ = _case(run, "peg")
    state, obs, reward = run[1]["steps"]["peg"]
    _assert_states_close(a["state"], state, atol=ATOL)
    _assert_states_close(a["obs"], obs, atol=ATOL)
    np.testing.assert_allclose(a["reward"].numpy(), reward.numpy(), atol=ATOL)


def test_sac_buffer_is_global_and_the_ranks_agree(run):
    """One SAC train step at 2 envs a rank: every rank's buffer holds every
    rank's transitions (its own as its env gave them) in global env order,
    its pointer and size count global rows, and the update leaves identical
    networks on both ranks. One process stepped from the joined start state
    with the buffer's first actions gives the same rewards and dones, and
    the same next observations where no env reset (a reset draws from the
    rank's own generator, so later steps start from other states)."""
    ranks = _case(run, "sac")
    a, b = ranks
    n, steps = P.SAC_ENVS, P.SAC_CFG["rollout_steps"]
    assert a["size"] == a["ptr"] == b["size"] == n * steps and a["steps"] == n * steps
    for x, y in zip(a["buffer"], b["buffer"]):
        assert torch.equal(x, y)
    for name in ("actor", "critic"):
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    assert torch.equal(a["log_alpha"], b["log_alpha"])
    obs, act, rew, next_obs, done = a["buffer"]
    local = n // P.WORLD
    for r, res in enumerate(ranks):
        for t, (act_r, rew_r, done_r, next_r) in enumerate(res["own"]):
            rows = slice(t * n + r * local, t * n + (r + 1) * local)
            for got, want in ((act, act_r), (rew, rew_r), (done, done_r), (next_obs, next_r)):
                assert torch.equal(got[rows], want)
    assert torch.equal(obs[n:], next_obs[:n])
    _, o, r, term, _, _ = P.env(P.SAC_ID, n, **P.QUIET).step(a["start"], act[:n])
    np.testing.assert_allclose(r.numpy(), rew[:n].numpy(), atol=ATOL)
    assert torch.equal(term.float(), done[:n])
    np.testing.assert_allclose(o["proprio_obs"][~term].numpy(), next_obs[:n][~term].numpy(), atol=ATOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_env_state_cuts_each_leaf_by_its_layout(rank):
    """The slice rule alone (no collective): env leaves take rows [start,
    stop), the Grasp-Lift sensor's pad-major leaves rows r and N + r of
    each half, the curriculum stays whole (each as its state class's
    ``ENV_LAYOUT`` says), a class with no ``ENV_LAYOUT`` is cut along the
    env axis, and a leaf of the wrong length raises."""
    g = EnvGroup(rank, 2, 4, 2, 2 * rank, 2 * rank + 2, torch.device("cpu"), "gloo")
    e = P.env(P.CURRICULUM_ID, 4, **P.QUIET)
    state = e.init_state()
    state = dataclasses.replace(state, ball_pos=torch.arange(12.0).reshape(4, 3),
                                sensor=dataclasses.replace(state.sensor, traj_count=torch.arange(4, dtype=torch.int32)))
    local = mesh.shard_env_state(state, g)
    assert torch.equal(local.ball_pos, state.ball_pos[2 * rank : 2 * rank + 2])
    assert torch.equal(local.sensor.traj_count, state.sensor.traj_count[2 * rank : 2 * rank + 2])
    assert local.curriculum is state.curriculum
    grasp = P.pad_marked(P.env(P.GRASP_ID, 4, **P.GRASP_CFG).init_state())
    assert mesh.shard_env_state(grasp, g).sensor.traj_count.tolist() == [2 * rank, 2 * rank + 1, 4 + 2 * rank, 5 + 2 * rank]

    @dataclasses.dataclass(frozen=True)
    class Plain:
        x: torch.Tensor

    @dataclasses.dataclass(frozen=True)
    class Declared:
        ENV_LAYOUT = {"y": mesh.REPLICATED}
        x: torch.Tensor
        y: torch.Tensor

    assert torch.equal(mesh.shard_env_state(Plain(torch.arange(4)), g).x, torch.arange(2 * rank, 2 * rank + 2))
    declared = mesh.shard_env_state(Declared(torch.arange(4), torch.arange(3)), g)
    assert torch.equal(declared.x, torch.arange(2 * rank, 2 * rank + 2)) and torch.equal(declared.y, torch.arange(3))
    with pytest.raises(ValueError, match="lead with 4"):
        mesh.shard_env_state(Plain(torch.zeros(3)), g)
    with pytest.raises(ValueError, match="lead with 4"):
        mesh.shard_env_state(dataclasses.replace(state, ball_pos=torch.zeros((3, 3))), g)


def test_shard_without_torchrun_raises(monkeypatch):
    """``train_torch.py --shard`` outside torchrun raises and says how to
    launch; a world size that does not divide ``num_envs`` raises before
    joining any group."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    main = runpy.run_path(str(REPO / "scripts" / "train_torch.py"))["main"]
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
        main(["--shard", "--device", "cpu", "--num_envs", "4", "--iterations", "1"])
    with pytest.raises(ValueError, match="not divisible"):
        init_env_parallel(3, "cpu", init_method="file:///nonexistent/pg", rank=0, world_size=2)
    assert not torch.distributed.is_initialized()


def test_sharded_trainer_refuses_an_env_of_another_size():
    g = EnvGroup(0, 2, 8, 4, 0, 4, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="rank's slice is 4"):
        SAC(P.env(P.SAC_ID, 8, **P.QUIET), SACConfig(**P.SAC_CFG), group=g)
