"""Grasp-Lift env benchmark of the PyTorch/CUDA port: env-steps/s of the
coupled FEM+ABD contact world.

The port's counterpart of ``benchmark_grasp_lift.py``: two FEM gel pads
grasp and lift a free affine body by friction, one coupled Newton solve a
substep, batched over N envs. The actions are seeded draws around a gentle
squeeze and lift (numpy, ``default_rng(0)``, as the JAX script draws them).
``compile_s`` is the first step's host seconds (the port compiles nothing:
on the card it is the first call's set-up); ``ms_per_step`` the host clock
around ``--steps`` more steps ended by one synchronise; ``device`` the
card's name and power limit (``nvidia-smi``), or ``cpu`` with ``--device cpu``.

Prints one JSON line. Usage:
    python scripts/benchmarking/benchmark_grasp_lift_torch.py [--envs 32] [--steps 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere


def run(env_id: str, n_envs: int, steps: int, overrides: dict | None = None, device="cuda") -> dict:
    """One configuration's line."""
    import torch

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.utils.profiling import device_label, synchronize

    env = envs.make(env_id, num_envs=n_envs, device=device, **(overrides or {}))
    state, _ = env.reset_all(env.init_state())
    rng = np.random.default_rng(0)
    # a gentle squeeze and lift so that the solve carries grasp contact
    loc = np.zeros(env.cfg.action_space)
    loc[:2] = [0.6, 0.4]
    draws = np.clip(rng.normal(loc, 0.2, (steps + 1, n_envs, env.cfg.action_space)), -1.0, 1.0)
    actions = torch.as_tensor(draws.astype(np.float32), device=env.device)

    t_first = time.perf_counter()
    state = env.step(state, actions[0])[0]
    synchronize(env.device)
    first_s = time.perf_counter() - t_first

    t0 = time.perf_counter()
    for i in range(steps):
        state = env.step(state, actions[i + 1])[0]
    synchronize(env.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(state.cube.q).all()):
        raise AssertionError("non-finite cube pose")
    return {
        "metric": f"grasp_lift_env_step[{env_id}]",
        "num_envs": n_envs,
        **({"overrides": overrides} if overrides else {}),
        "env_steps_per_s": round(n_envs * steps / dt, 1),
        "ms_per_step": round(1e3 * dt / steps, 2),
        "compile_s": round(first_s, 1),
        "device": device_label(env.device),
    }


def main(argv: list[str] | None = None) -> dict:
    """Run one configuration; returns its line."""
    from tacex_tpu_torch.core.config import parse_overrides

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--env-id", default="TacEx-Grasp-Lift-Uipc-v0")
    ap.add_argument("--env_cfg", action="append", default=[], metavar="KEY=VALUE",
                    help="env cfg override, e.g. --env_cfg pad_resolution=(3,6,6) (repeatable; values parsed as "
                         "Python literals)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    row = run(args.env_id, args.envs, args.steps, parse_overrides(args.env_cfg), args.device)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
