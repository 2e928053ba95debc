"""Grasp-and-lift on the PyTorch/CUDA port: two FEM gel pads lift a free
rigid cube by friction in the coupled FEM+ABD world.

The port's counterpart of ``grasp_lift.py``: two gel pads of (2, 4, 4)
cells and a dynamic 15 mm affine cube (density 2000) in one Newton solve
with cross barriers and friction; the pads squeeze 1.5 mm over 30 steps,
then their mounts rise 0.15 mm a step, 2 envs, 130 steps at dt 1/100, on
``--device`` (the card by default; ``--device cpu`` runs on the CPU).
Prints the squeeze, lift and the cube's rise every 20 steps; after the full
run it checks that the cube rose with the pads.

Usage: python examples/grasp_lift_torch.py [--steps 130] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere

NUM_ENVS = 2
STEPS = 130
CUBE_HALF = 0.0075


def cube_surface(s=CUBE_HALF):
    pts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float64)
    tris = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        np.int64,
    )
    return pts, tris


def build(device):
    import torch

    from tacex_tpu_torch.physics.soft.mesh import box_tet_mesh
    from tacex_tpu_torch.uipc import (
        AffineBodyConstitutionCfg,
        StableNeoHookeanCfg,
        UipcObject,
        UipcObjectCfg,
        UipcSim,
        UipcSimCfg,
    )

    sim = UipcSim(UipcSimCfg(num_envs=NUM_ENVS, dt=1 / 100), device=device)
    dev = sim.device
    ctrl = {"squeeze": 0.0, "lift": 0.0}
    pads = []
    for sgn in (-1.0, +1.0):
        mesh = box_tet_mesh((0.01, 0.03, 0.03), (2, 4, 4), center=(sgn * 0.0135, 0, 0))
        pad = UipcObject(UipcObjectCfg(constitution=StableNeoHookeanCfg(youngs_modulus=0.1), mass_density=1000.0),
                         sim, mesh=mesh)
        mount = np.where(sgn * mesh.points[:, 0] > 0.0185 - 1e-9)[0].astype(np.int32)
        rest = torch.as_tensor(mesh.points[mount], device=dev).expand(NUM_ENVS, len(mount), 3)
        ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
        ez = torch.tensor([0.0, 0.0, 1.0], device=dev)

        def provider(rest=rest, sgn=sgn, ex=ex, ez=ez):
            return rest + float(-sgn * ctrl["squeeze"]) * ex + float(ctrl["lift"]) * ez

        pad.set_attachments(mount, aim_provider=provider)
        pads.append(pad)
    pts, tris = cube_surface()
    cube = UipcObject(
        UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=100.0, kinematic=False), mass_density=2000.0),
        sim, points=pts, triangles=tris,
    )
    sim.setup_sim()
    assert sim._coupled is not None, "expected the unified FEM<->ABD contact world"
    return sim, pads, cube, ctrl


def advance_ctrl(ctrl: dict, i: int) -> None:
    """The script's squeeze-then-lift schedule at step i."""
    if i < 30:
        ctrl["squeeze"] = min(ctrl["squeeze"] + 1.5e-3 / 30, 1.5e-3)
    else:
        ctrl["lift"] += 1.5e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, pads, cube, ctrl = build(args.device)
    seconds = 0.0
    for i in range(args.steps):
        advance_ctrl(ctrl, i)
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 20 == 0:
            z = float(sim.abd_body_pose(cube)[0, 2])
            print(f"step {i:3d}  squeeze {ctrl['squeeze']*1e3:.2f} mm  "
                  f"lift {ctrl['lift']*1e3:.2f} mm  cube dz {z*1e3:+.2f} mm")
    z = float(sim.abd_body_pose(cube)[0, 2])
    print(f"final cube rise: {z*1e3:.2f} mm of {ctrl['lift']*1e3:.2f} mm commanded")
    y = sim.abd_vertex_positions(cube).cpu().numpy()
    assert np.isfinite(y).all()
    if args.steps >= STEPS:
        assert z > 0.6 * ctrl["lift"], "cube was not carried by friction"
        print("grasp-and-lift OK: cube held and lifted by gel friction")
    return {"x": np.concatenate([p.nodal_pos_w.cpu().numpy() for p in pads], 1),
            "q": sim.abd_body_pose(cube).cpu().numpy(), "rise": z, "lift": ctrl["lift"],
            "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
