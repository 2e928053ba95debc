"""Mixed-resolution FEM gel benchmark of the PyTorch/CUDA port: the
sensor-fidelity surface at the coarse solve's cost.

The port's counterpart of ``benchmark_embedded_gel.py``. It steps the UIPC
ball-rolling task (``TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0``) with zero
actions in three gel configurations and prints one JSON line each:

  * low            — coarse solve, coarse surface (the env default)
  * low + embed    — coarse solve, extremely_high embedded surface
  * extremely_high — dense solve (what the embedding replaces; skipped
                     with ``--skip_dense``)

``ms_per_step`` is the host clock around ``--steps`` steps ended by one
synchronise, after one warm-up step; ``device`` is the card's name and power
limit (``nvidia-smi``), or ``cpu`` with ``--device cpu``.

Usage: python scripts/benchmarking/benchmark_embedded_gel_torch.py [--envs 64] [--steps 30] [--skip_dense]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

ENV_ID = "TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0"


def run(num_envs: int, steps: int, gel_resolution: str, embed: str | None, device="cuda") -> dict:
    """One configuration's line."""
    import torch

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.utils.profiling import device_label, synchronize

    env = envs.make(ENV_ID, num_envs=num_envs, gel_resolution=gel_resolution, gel_embed_surface=embed,
                    device=device)
    state, _ = env.reset_all(env.init_state())
    a = torch.zeros((num_envs, env.cfg.action_space), device=env.device)
    state, obs, rew, *_ = env.step(state, a)  # warm-up
    synchronize(env.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, obs, rew, *_ = env.step(state, a)
    synchronize(env.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(rew).all()):
        raise AssertionError("non-finite reward")
    return {
        "metric": "uipc_env_steps_per_s",
        "gel_resolution": gel_resolution,
        "gel_embed_surface": embed,
        "num_envs": num_envs,
        "env_steps_per_s": round(num_envs * steps / dt, 1),
        "ms_per_step": round(1e3 * dt / steps, 2),
        "device": device_label(env.device),
    }


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the configurations; returns their lines."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--skip_dense", action="store_true", help="skip the slow extremely_high solve")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    configs = [("low", None), ("low", "extremely_high")] + ([] if args.skip_dense else [("extremely_high", None)])
    lines = []
    for res, embed in configs:
        lines.append(run(args.envs, args.steps, res, embed, args.device))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
