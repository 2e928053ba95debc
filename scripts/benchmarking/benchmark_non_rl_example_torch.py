"""Benchmark a non-RL environment rollout of the PyTorch/CUDA port and emit
KPI metrics.

The port's counterpart of ``benchmark_non_rl_example.py``, with its keys:

  * startup_s       — the script's start (process start, or its load by
                      ``runpy``) -> env constructed and reset
  * first_step_s    — the first step (the JAX script's ``compile_s``:
                      nothing compiles here, but the first step pays the
                      kernels' load and the allocator's warm-up)
  * per_frame_ms    — steady-state wall time a step: the host clock around
                      ``--num_frames`` steps ended by one synchronise
  * frames_per_sec  — num_envs * num_frames / wall
  * device          — the card's name and power limit (``nvidia-smi``),
                      or ``cpu``

It steps ``--task`` with zero actions on ``--device`` (the card by default;
``--device cpu`` runs on the CPU) and prints one JSON document; ``--out``
also writes it to a file.

Usage: python scripts/benchmarking/benchmark_non_rl_example_torch.py [--num_envs 64] [--num_frames 100]
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere


def main(argv: list[str] | None = None) -> dict:
    """Run the benchmark; returns the KPI dict."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="TacEx-Ball-Rolling-Taxim-Fots-v0")
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.utils.profiling import device_label, synchronize

    env = envs.make(args.task, num_envs=args.num_envs, device=args.device)
    state, _ = env.reset_all(env.init_state())
    synchronize(env.device)
    startup_s = time.perf_counter() - _T0

    actions = torch.zeros((args.num_envs, env.cfg.action_space), device=env.device)
    t0 = time.perf_counter()
    state, obs, rew, term, trunc, info = env.step(state, actions)
    synchronize(env.device)
    first_step_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(args.num_frames):
        state, obs, rew, term, trunc, info = env.step(state, actions)
    synchronize(env.device)
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(rew).all()):
        raise AssertionError("non-finite reward")

    kpi = {
        "task": args.task,
        "num_envs": args.num_envs,
        "num_frames": args.num_frames,
        "startup_s": round(startup_s, 3),
        "first_step_s": round(first_step_s, 3),
        "per_frame_ms": round(wall / args.num_frames * 1e3, 3),
        "frames_per_sec": round(args.num_envs * args.num_frames / wall, 1),
        "device": device_label(env.device),
    }
    print(json.dumps(kpi, indent=2))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(kpi, indent=2))
    return kpi


if __name__ == "__main__":
    main()
