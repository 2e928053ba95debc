"""The 2-rank workers of ``tests/test_torch_parallel.py`` and the scenes they
share with it.

Each worker is one gloo rank of a spawned group on the CPU, with one
thread. It runs every case in turn on one process group (a spawn costs a
few seconds, so there is one) and saves what the test compares; a case
that raises saves its traceback instead. Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import dataclasses
import datetime
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from tacex_tpu_torch import envs
from tacex_tpu_torch.parallel import dryrun, mesh
from tacex_tpu_torch.parallel.group import close_env_parallel, init_env_parallel
from tacex_tpu_torch.rl import PPO, PPOConfig, SAC, SACConfig
from tacex_tpu_torch.rl.networks import ActorCritic
from tacex_tpu_torch.rl.ppo import RunningScaler

WORLD = 2
TIMEOUT_S = 60.0  # each collective's: a hung one fails the test instead of eating the suite's clock
JOIN_TIMEOUT_S = 150.0

QUIET = dict(action_noise=0.0, obs_noise_std=0.0)  # the ball-rolling envs' step draws nothing that counts
CURRICULUM_ID, CURRICULUM_ENVS = "TacEx-Ball-Rolling-Taxim-Fots-v0", 4
# the first rank's envs far above every curriculum threshold (550, 5500), the
# second's at 0: the global mean (6000) crosses them all, the second rank's own does not
CURRICULUM_TOTALS = (12000.0, 12000.0, 0.0, 0.0)
GRASP_ID, GRASP_ENVS, GRASP_STEPS = "TacEx-Grasp-Lift-Uipc-Tactile-v0", 2, 2
GRASP_CFG = dict(newton_iters=2, cg_iters=8)  # tests/test_multichip.py's
PEG_ID, PEG_ENVS = "TacEx-Factory-PegInsert-Direct-v0", 2
SAC_ID, SAC_ENVS = "TacEx-Ball-Rolling-Privileged-v0", 4
SAC_CFG = dict(hidden=(16,), batch_size=8, buffer_size=64, rollout_steps=2, warmup_steps=0)


def env(env_id: str, n: int, **cfg):
    return envs.make(env_id, num_envs=n, device="cpu", **cfg)


def pad_marked(state):
    """A Grasp-Lift state whose sensor leaves (2N pad-major rows) hold their
    own row numbers, so a wrong cut shows."""
    rows = lambda x: torch.arange(x.shape[0], dtype=x.dtype)[:, None].expand_as(x).clone() if x.ndim > 1 else \
        torch.arange(x.shape[0], dtype=x.dtype)
    sensor = state.sensor
    return dataclasses.replace(state, sensor=dataclasses.replace(
        sensor, traj_start=rows(sensor.traj_start), traj_count=rows(sensor.traj_count)))


def scenes() -> dict:
    """The global start states of the env cases, as one process builds them."""
    cur = env(CURRICULUM_ID, CURRICULUM_ENVS, **QUIET)
    cur_state = cur.reset_all(cur.init_state())[0]
    cur_state = dataclasses.replace(cur_state, total_episode_rew=torch.tensor(CURRICULUM_TOTALS))
    grasp = env(GRASP_ID, GRASP_ENVS, **GRASP_CFG)
    peg = env(PEG_ID, PEG_ENVS)
    rng = np.random.default_rng(11)
    return {
        "curriculum": {"state": cur_state, "action": torch.tensor([[0.0, 0.0, -0.1, 0.0, 0.0, 0.0]]).expand(
            CURRICULUM_ENVS, cur.cfg.action_space).contiguous()},
        "grasp": {"state": pad_marked(grasp.reset_all(grasp.init_state())[0]),
                  "action": torch.tensor([[1.0, 0.2]]).expand(GRASP_ENVS, 2).contiguous()},
        "peg": {"state": peg.reset_all(peg.init_state())[0],
                "action": torch.from_numpy(rng.uniform(-0.5, 0.5, (PEG_ENVS, peg.cfg.action_space)).astype(np.float32))},
    }


def steps(e, state, action, n: int = 1):
    """``n`` steps of ``e``: (state, obs, reward) after the last."""
    for _ in range(n):
        state, obs, reward, *_ = e.step(state, action)
    return state, obs, reward


def fake_ppo(group, inp) -> PPO:
    """A PPO over ``inp``'s network (a state_dict) with the optimizer at
    rest, on a stand-in env of the rank's envs (``update`` and ``gae`` read
    no env)."""
    local = inp["num_envs"] if group is None else group.local_envs
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(action_space=inp["action_dim"], num_envs=local),
                                 device=torch.device("cpu"))
    ppo = PPO(fake, PPOConfig(**inp["cfg"]), group=group)
    ppo.net = ActorCritic(14, None, inp["action_dim"], hidden=inp["cfg"]["hidden"], device="cpu")
    ppo.net.load_state_dict(inp["net"])
    ppo.params = list(ppo.net.parameters())
    ppo.adam_m = [torch.zeros_like(p) for p in ppo.params]
    ppo.adam_v = [torch.zeros_like(p) for p in ppo.params]
    ppo.adam_count = 0
    ppo.lr = torch.tensor(ppo.cfg.learning_rate)
    return ppo


def local_rows(x: np.ndarray, group) -> torch.Tensor:
    """The rank's rows of a (T, N, ...) array, flattened to (T n_local, ...)."""
    part = x[:, group.start : group.stop]
    return torch.from_numpy(np.ascontiguousarray(part.reshape((-1,) + part.shape[2:])))


# -------------------------------------------------------------------- cases


def case_dryrun(group, inp):
    loss, n_steps = dryrun.train_step_on(group)
    return {"loss": loss, "steps": n_steps}


def case_update(group, inp):
    g = group.for_envs(inp["num_envs"])
    ppo = fake_ppo(g, inp)
    obs, rest = inp["traj"]
    loss = ppo.update(({k: local_rows(v, g) for k, v in obs.items()}, *(local_rows(x, g) for x in rest)),
                      torch.from_numpy(inp["perms"]))
    return {"net": {k: v.clone() for k, v in ppo.net.state_dict().items()}, "lr": ppo.lr, "loss": loss}


def case_gae(group, inp):
    g = group.for_envs(inp["num_envs"])
    ppo = fake_ppo(g, inp)
    ppo.value_scaler = RunningScaler(*inp["scaler"])
    values, rewards, dones, last = (torch.from_numpy(x) for x in inp["gae"])
    adv, ret = ppo.gae(values[:, g.start : g.stop], rewards[:, g.start : g.stop], dones[:, g.start : g.stop],
                       last[g.start : g.stop])
    scaler = ppo.value_scaler.update(ret, g)
    return {"adv": adv, "ret": ret, "scaler": (scaler.mean, scaler.var, scaler.count)}


def case_curriculum(group, inp):
    g = group.for_envs(CURRICULUM_ENVS)
    e = env(CURRICULUM_ID, g.local_envs, **QUIET)
    mesh.bind_env(e, g)  # the curriculum's mean over every rank's envs
    state, obs, reward = steps(e, mesh.shard_env_state(inp["state"], g), inp["action"][g.start : g.stop])
    return {"state": mesh.gather_env_state(state, g), "reward": mesh.all_gather_envs(reward, g),
            "local_curriculum": state.curriculum}


def case_grasp(group, inp):
    g = group.for_envs(GRASP_ENVS)
    e = env(GRASP_ID, g.local_envs, **GRASP_CFG)
    start = mesh.shard_env_state(inp["state"], g)
    state, obs, reward = steps(e, start, inp["action"][g.start : g.stop], GRASP_STEPS)
    return {"local_sensor": start.sensor, "state": mesh.gather_env_state(state, g),
            "obs": mesh.gather_env_state(obs, g), "reward": mesh.all_gather_envs(reward, g)}


def case_peg(group, inp):
    g = group.for_envs(PEG_ENVS)
    e = env(PEG_ID, g.local_envs)
    state, obs, reward = steps(e, mesh.shard_env_state(inp["state"], g), inp["action"][g.start : g.stop])
    return {"state": mesh.gather_env_state(state, g), "obs": mesh.gather_env_state(obs, g),
            "reward": mesh.all_gather_envs(reward, g)}


def case_sac(group, inp):
    g = group.for_envs(SAC_ENVS)
    e = env(SAC_ID, g.local_envs, **QUIET)
    sac = SAC(e, SACConfig(**SAC_CFG), group=g)
    sac.init(0)
    start = mesh.gather_env_state(sac.env_state, g)
    own, step = [], e.step

    def recorded(state, action):  # the rank's own transitions, as its env gives them
        out = step(state, action)
        own.append((action, out[2], out[3].float(), out[1]["proprio_obs"]))
        return out

    e.step = recorded
    metrics = sac.train_step()
    b = sac.buffer
    return {"start": start, "own": own, "size": b.size, "ptr": b.ptr, "steps": sac.steps, "metrics": metrics,
            "buffer": [x[: b.size].clone() for x in (b.obs, b.act, b.rew, b.next_obs, b.done)],
            "actor": sac.actor.state_dict(), "critic": sac.critic.state_dict(), "log_alpha": sac.log_alpha.detach()}


CASES = {"dryrun": case_dryrun, "update": case_update, "gae": case_gae, "curriculum": case_curriculum,
         "grasp": case_grasp, "peg": case_peg, "sac": case_sac}


def run_rank(rank: int, init_file: str, inputs_path: str, out_dir: str) -> None:
    """One rank: join the group, run every case, save ``rank<r>.pt``."""
    torch.set_num_threads(1)
    group = init_env_parallel(WORLD, "cpu", init_method=f"file://{init_file}", rank=rank, world_size=WORLD,
                              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    inputs = torch.load(inputs_path, weights_only=False)
    results = {}
    try:
        for name, case in CASES.items():
            try:
                results[name] = case(group, inputs.get(name))
            except Exception:  # saved for the test of that case to raise
                results[name] = {"error": traceback.format_exc()}
    finally:
        close_env_parallel()
    torch.save(results, Path(out_dir) / f"rank{rank}.pt")
