"""Hello UIPC on the PyTorch/CUDA port: a soft tetrahedron falls onto the
ground in every env.

The port's counterpart of ``hello_uipc.py`` (one StableNeoHookean tet
dropped on the ground plane, 4 envs, 90 steps at dt 1/60), on ``--device``
(the card by default; ``--device cpu`` runs on the CPU). Prints the tet's
height range every 15 steps; after the full run it checks that the tet
landed penetration-free in all envs.

Usage: python examples/libuipc_samples/hello_uipc_torch.py [--steps 90] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

NUM_ENVS = 4
STEPS = 90
POINTS = 0.1 * np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], np.float32) + np.array(
    [0.0, 0.0, 0.15], np.float32
)
TETS = np.array([[1, 0, 2, 3]], np.int32)


def build(device):
    from tacex_tpu_torch.uipc import StableNeoHookeanCfg, UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg

    sim = UipcSim(UipcSimCfg(num_envs=NUM_ENVS, dt=1 / 60, enable_ground=True), device=device)
    tet = UipcObject(UipcObjectCfg(constitution=StableNeoHookeanCfg(youngs_modulus=0.1)), sim, points=POINTS, tets=TETS)
    sim.setup_sim()
    return sim, tet


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, tet = build(args.device)
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 15 == 0:
            z = tet.nodal_pos_w[..., 2].cpu().numpy()
            print(f"step {i:3d}: z range [{z.min():.4f}, {z.max():.4f}]")
    x = tet.nodal_pos_w.cpu().numpy()
    if args.steps >= STEPS:
        assert x[..., 2].min() > -1e-4, "tet penetrated the ground"
        assert x[..., 2].min() < 0.01, "tet did not land"
        print("hello uipc: tet landed penetration-free in all envs")
    return {"x": x, "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
