"""Falling soft cubes on the PyTorch/CUDA port: N envs each drop a soft cube
onto the ground.

The port's counterpart of ``falling_gel_cubes.py`` (a StableNeoHookean cube
of (3, 3, 3) cells, 4 envs, 60 steps at dt 1/120 onto the ground plane), on
``--device`` (the card by default; ``--device cpu`` runs on the CPU). Prints
the height range every 10 steps; after the full run it checks that the
cubes rest penetration-free and prints the sim's time report.

Usage: python examples/falling_gel_cubes_torch.py [--steps 60] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere

NUM_ENVS = 4
STEPS = 60


def build(device):
    from tacex_tpu_torch.uipc import StableNeoHookeanCfg, UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import TetMeshCfg

    sim = UipcSim(UipcSimCfg(num_envs=NUM_ENVS, dt=1 / 120, enable_ground=True), device=device)
    cube = UipcObject(
        UipcObjectCfg(
            mesh_cfg=TetMeshCfg(size=(0.04, 0.04, 0.04), resolution=(3, 3, 3), center=(0, 0, 0.08)),
            constitution=StableNeoHookeanCfg(youngs_modulus=0.05, poisson_rate=0.45),
        ),
        sim,
    )
    sim.setup_sim()
    return sim, cube


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, cube = build(args.device)
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 10 == 0:
            z = cube.nodal_pos_w[..., 2].cpu().numpy()
            print(f"step {i:3d}: min z {z.min():.4f}  max z {z.max():.4f}")
    x = cube.nodal_pos_w.cpu().numpy()
    if args.steps >= STEPS:
        assert x[..., 2].min() > -1e-4, "penetrated the ground!"
        print("cubes rest on the ground, penetration-free:", sim.get_sim_time_report())
    return {"x": x, "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
