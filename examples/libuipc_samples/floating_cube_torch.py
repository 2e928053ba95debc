"""Floating cube on the PyTorch/CUDA port: an animated soft position
constraint holds a soft cube in the air and carries it along a circle.

The port's counterpart of ``floating_cube.py`` (a StableNeoHookean cube
whose top vertices follow anchors moving on a circle, 2 envs, 150 steps at
dt 1/60, then ``check_health``), on ``--device`` (the card by default;
``--device cpu`` runs on the CPU). After the full run it checks that the
cube never fell and followed the anchors sideways.

Usage: python examples/libuipc_samples/floating_cube_torch.py [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

NUM_ENVS = 2
DT = 1 / 60
STEPS = 150


def anchor_offset(i: int) -> tuple[float, float]:
    """(x, y) offset of the anchors at frame i: a circle in xy at the rest height."""
    t = i * DT
    return 0.03 * np.sin(t), 0.03 * (1 - np.cos(t))


def build(device):
    import torch

    from tacex_tpu_torch.uipc import StableNeoHookeanCfg, UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import TetMeshCfg

    sim = UipcSim(UipcSimCfg(num_envs=NUM_ENVS, dt=DT, enable_ground=True), device=device)
    cube = UipcObject(
        UipcObjectCfg(
            mesh_cfg=TetMeshCfg(size=(0.04, 0.04, 0.04), resolution=(3, 3, 3), center=(0, 0, 0.1)),
            constitution=StableNeoHookeanCfg(youngs_modulus=0.05),
        ),
        sim,
    )
    top = np.where(cube.mesh.points[:, 2] > 0.12 - 1e-6)[0].astype(np.int32)
    dev = sim.device
    rest_top = torch.as_tensor(cube.mesh.points[top], device=dev).expand(NUM_ENVS, len(top), 3)
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], device=dev)
    frame = {"i": 0}

    def animate_anchors():
        ox, oy = anchor_offset(frame["i"])  # host floats: the targets are built on the device
        return rest_top + float(ox) * ex + float(oy) * ey

    cube.set_attachments(top, aim_provider=animate_anchors, strength_ratio=200.0)
    sim.setup_sim()
    return sim, cube, frame


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, cube, frame = build(args.device)
    z_hist, seconds = [], 0.0
    for i in range(args.steps):
        frame["i"] = i
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        z_hist.append(float(cube.root_pos_w[0, 2]))
    overflow = sim.check_health()
    z = np.asarray(z_hist)
    xy = cube.root_pos_w[0, :2].cpu().numpy()
    if args.steps >= STEPS:
        assert z.min() > 0.05, f"cube fell: {z.min():.3f}"
        assert np.linalg.norm(xy) > 0.01, xy
        print(f"floating cube: held at z ~ {z[-1]:.3f} m while tracking the anchors (xy {xy.round(3)})")
    return {"x": cube.nodal_pos_w.cpu().numpy(), "z": z, "overflow": overflow,
            "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
