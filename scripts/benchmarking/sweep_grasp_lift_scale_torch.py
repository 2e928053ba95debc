"""Scale sweep of the coupled Grasp-Lift world on the PyTorch/CUDA port:
env count x pad resolution.

The port's counterpart of ``sweep_grasp_lift_scale.py``: each configuration
runs in-process in turn through ``benchmark_grasp_lift_torch.run`` and
prints one JSON line of that script's schema; a configuration that fails
(out of memory) is recorded with its error and the sweep goes on.

Usage:
    python scripts/benchmarking/sweep_grasp_lift_scale_torch.py [--out rows.jsonl] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

from scripts.benchmarking.benchmark_grasp_lift_torch import run  # noqa: E402

# (envs, pad_resolution, steps): the coarse pads up the env axis, then the
# mid pads (4x8x8, 405 vertices a pad against 75) at training batches
CONFIGS = [
    (128, (2, 4, 4), 20),
    (256, (2, 4, 4), 20),
    (512, (2, 4, 4), 12),
    (1024, (2, 4, 4), 8),
    (64, (4, 8, 8), 12),
    (128, (4, 8, 8), 8),
    (256, (4, 8, 8), 6),
]


def main(argv: list[str] | None = None) -> list[dict]:
    """Run every configuration; returns their lines."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rows = []
    for n_envs, pad, steps in CONFIGS:
        try:
            row = run("TacEx-Grasp-Lift-Uipc-v0", n_envs, steps, {"pad_resolution": pad}, args.device)
        except Exception as e:  # out of memory and the like: recorded, and the sweep goes on
            row = {
                "metric": "grasp_lift_env_step[TacEx-Grasp-Lift-Uipc-v0]",
                "num_envs": n_envs, "overrides": {"pad_resolution": pad},
                "error": f"{type(e).__name__}: {e}"[:300],
            }
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
