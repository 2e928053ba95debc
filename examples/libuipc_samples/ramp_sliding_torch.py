"""Ramp sliding on the PyTorch/CUDA port: friction ratios decide whether an
affine cube slides down a ramp or sticks.

The port's counterpart of ``ramp_sliding.py``: a 4 cm affine cube (100 MPa)
set flush on a ramp tilted 0.35 rad, one scene for each friction ratio
(0.0, 0.2, 0.9), 1 env, 90 steps at dt 1/60, then ``check_health``; on
``--device`` (the card by default; ``--device cpu`` runs on the CPU). After
the full run it checks the friction ordering: the frictionless cube slides
more than 2 cm farther than the mu = 0.9 one, which moves less than 2 cm.

Usage: python examples/libuipc_samples/ramp_sliding_torch.py [--steps 90] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

STEPS = 90
FRICTIONS = (0.0, 0.2, 0.9)
TILT = 0.35
HALF = 0.02


def build(mu: float, device, tilt: float = TILT):
    """(sim, cube, ramp scene) of one friction ratio: the cube flush on the
    ramp, its center one half-extent (and 1.5 mm) above it."""
    import torch

    from tacex_tpu_torch.assets.meshes import box_mesh, weld_soup
    from tacex_tpu_torch.physics.soft.ipc import RigidSdfScene
    from tacex_tpu_torch.uipc import UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import AffineBodyConstitutionCfg

    n_vec = np.array([-np.sin(tilt), 0.0, np.cos(tilt)], np.float32)
    sim = UipcSim(UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=False,
                             contact=UipcSimCfg.Contact(default_friction_ratio=mu, d_hat=0.002, resistance=1e4)),
                  device=device)
    p, t = weld_soup(box_mesh(HALF, HALF, HALF))
    R = np.array([[np.cos(-tilt), 0.0, np.sin(-tilt)], [0.0, 1.0, 0.0], [-np.sin(-tilt), 0.0, np.cos(-tilt)]],
                 np.float32)
    p = p @ R.T + (HALF + 0.0015) * n_vec
    cube = UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=100.0)), sim,
                      points=p.astype(np.float32), triangles=t)
    sim.setup_sim()
    sc = RigidSdfScene.empty(1, device=sim.device)
    plane = torch.as_tensor(np.concatenate([n_vec, [0.0]]).astype(np.float32), device=sim.device).view(1, 1, 4)
    ramp = RigidSdfScene(sc.spheres, sc.boxes, sc.capsules, plane)
    return sim, cube, ramp


def run(mu: float, steps: int, device) -> tuple[float, np.ndarray, float]:
    """(downhill travel of the cube (m), its final vertices (1, V, 3), seconds
    of the step loop) on a ramp of friction ``mu``."""
    sim, cube, ramp = build(mu, device)
    x0 = float(cube.root_pos_w[0, 0])
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step(ramp)
    seconds = time.perf_counter() - t0
    sim.check_health()
    return x0 - float(cube.root_pos_w[0, 0]), cube.nodal_pos_w.cpu().numpy(), seconds  # downhill = -x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    travel, x, seconds = {}, {}, 0.0
    for mu in FRICTIONS:
        travel[mu], x[mu], s = run(mu, args.steps, args.device)
        seconds += s
    for mu, d in travel.items():
        print(f"friction {mu:.1f}: slid {d * 100:+.1f} cm downhill")
    if args.steps >= STEPS:
        assert travel[0.0] > travel[0.9] + 0.02, travel
        assert abs(travel[0.9]) < 0.02, travel
        assert travel[0.0] >= travel[0.2] - 1e-3, travel
        print("ramp sliding: friction ordering matches the reference sample")
    return {"travel": travel, "x": x, "ms_per_step": 1e3 * seconds / max(len(FRICTIONS) * args.steps, 1)}


if __name__ == "__main__":
    main()
