"""Wrecking balls on the PyTorch/CUDA port: a pile of affine bodies
collapsing under gravity.

The port's counterpart of ``wrecking_balls.py``: a 2x2 wall of 10 cm affine
bricks (10 MPa) and two icosphere balls dropped onto it, six bodies in one
ABD solve with body-body contact, 1 env, 120 steps at dt 1/60 (d_hat 4 mm),
then ``check_health``; on ``--device`` (the card by default; ``--device
cpu`` runs on the CPU). After the full run it checks that no vertex is
more than 2 mm under the ground and that every body came to rest below
0.4 m.

Usage: python examples/libuipc_samples/wrecking_balls_torch.py [--steps 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

STEPS = 120
HALF = 0.05


def build(device):
    from tacex_tpu_torch.assets.meshes import box_mesh, icosphere, weld_soup
    from tacex_tpu_torch.uipc import UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import AffineBodyConstitutionCfg

    sim = UipcSim(UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=True,
                             contact=UipcSimCfg.Contact(default_friction_ratio=0.5, d_hat=0.004, resistance=1e4)),
                  device=device)
    abd = AffineBodyConstitutionCfg(m_kappa=10.0)
    bodies = []
    for ix in range(2):  # the 2x2 brick wall
        for iz in range(2):
            p, t = weld_soup(box_mesh(HALF, HALF, HALF))
            off = np.array([-0.06 + 0.12 * ix, 0.0, HALF + 0.004 + iz * (2 * HALF + 0.006)], np.float32)
            bodies.append(UipcObject(UipcObjectCfg(constitution=abd), sim, points=p + off, triangles=t))
    for ib in range(2):  # two balls dropped onto the wall
        p, t = weld_soup(icosphere(0.05, 1))
        off = np.array([-0.05 + 0.1 * ib, 0.01, 0.45 + 0.14 * ib], np.float32)
        bodies.append(UipcObject(UipcObjectCfg(constitution=abd), sim, points=p + off, triangles=t))
    sim.setup_sim()
    return sim, bodies


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, bodies = build(args.device)
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 20 == 0:
            zs = [float(b.root_pos_w[0, 2]) for b in bodies]
            print(f"step {i:3d}: body z = {np.round(zs, 3)}")
    overflow = sim.check_health()
    verts = np.concatenate([b.surface_positions()[0].cpu().numpy() for b in bodies])
    zs = np.array([float(b.root_pos_w[0, 2]) for b in bodies])
    ms = 1e3 * seconds / max(args.steps, 1)
    if args.steps >= STEPS:
        assert verts[:, 2].min() > -2e-3, f"penetrated ground: {verts[:, 2].min():.4f}"
        assert zs.max() < 0.4, "bodies failed to fall/settle"
        print(f"wrecking balls: {len(bodies)} affine bodies settled penetration-free; {ms:.1f} ms/step")
    return {"x": np.concatenate([b.nodal_pos_w.cpu().numpy() for b in bodies], 1), "z": zs,
            "z_min": float(verts[:, 2].min()), "overflow": overflow, "ms_per_step": ms}


if __name__ == "__main__":
    main()
