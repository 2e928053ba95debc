"""Ablation profile of the coupled FEM+ABD solve on the PyTorch/CUDA port
(the Grasp-Lift scene).

The port's counterpart of ``profile_coupled.py``: it steps
``TacEx-Grasp-Lift-Uipc-v0`` under each of its solver knobs in turn
(Newton, CG and coupling-candidate counts, the decimation) with the seeded
squeeze-and-lift actions of ``benchmark_grasp_lift_torch.py``, and prints
one JSON line a configuration with its ``ms_per_step`` (the host clock
around ``--steps`` steps after a warm one, ended by a synchronise).

Usage: python scripts/benchmarking/profile_coupled_torch.py [--envs 16] [--steps 15] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

ENV_ID = "TacEx-Grasp-Lift-Uipc-v0"
CONFIGS = [
    dict(),  # the registered solver: newton 6, cg 24, decimation 2
    dict(newton_iters=1),
    dict(newton_iters=3),
    dict(cg_iters=1),
    dict(cg_iters=8),
    dict(coupling_k=1),
    dict(coupling_k=8),
    dict(decimation=1),
]


def time_env(env_id: str, n_envs: int, steps: int, device="cuda", **cfg_over) -> dict:
    import torch

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.utils.profiling import synchronize

    env = envs.make(env_id, num_envs=n_envs, device=device, **cfg_over)
    state, _ = env.reset_all(env.init_state())
    rng = np.random.default_rng(0)
    loc = np.zeros(env.cfg.action_space)
    loc[:2] = [0.6, 0.4]
    draws = np.clip(rng.normal(loc, 0.2, (steps + 1, n_envs, env.cfg.action_space)), -1, 1)
    actions = torch.as_tensor(draws.astype(np.float32), device=env.device)
    state = env.step(state, actions[0])[0]
    synchronize(env.device)
    t0 = time.perf_counter()
    for i in range(steps):
        state = env.step(state, actions[i + 1])[0]
    synchronize(env.device)
    dt = time.perf_counter() - t0
    return {"ms_per_step": round(1e3 * dt / steps, 2), **cfg_over}


def main(argv: list[str] | None = None) -> list[dict]:
    """Run every configuration; returns their lines."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rows = []
    for over in CONFIGS:
        rows.append({"envs": args.envs, **time_env(ENV_ID, args.envs, args.steps, args.device, **over)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
