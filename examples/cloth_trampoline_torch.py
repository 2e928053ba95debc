"""Cloth trampoline on the PyTorch/CUDA port: a corner-pinned cloth catches
a falling free affine body.

The port's counterpart of ``cloth_trampoline.py``: a 7 x 7 cloth of 6 cm
(NeoHookeanShell 0.1 MPa, density 200) pinned at its four corners and a
1.2 cm affine cube (100 MPa) dropped onto it, 1 env, 80 steps at dt 1/100
over the ground. The cloth is a shell part of the nodal union and the cube
a dynamic affine body, so both meet through the coupled world's cross
barriers in one Newton solve a step: the cube rests on the cloth and the
cloth sags under it. Runs on ``--device`` (the card by default;
``--device cpu`` runs on the CPU). After the full run it checks that the
cube was caught above 2 cm and that the cloth's centre sagged below 29.5 mm.

Usage: python examples/cloth_trampoline_torch.py [--steps 80] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere

STEPS = 80
NX = 7
BODY_Z = 0.045  # the cube's rest centre


def cube_surface(s, center):
    """(points, triangles) of a closed cube of half-size s at center."""
    pts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float64) + np.asarray(center)
    tris = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    return pts, tris


def build(device, cfg=None):
    """(sim, cloth, body) of the scene; ``cfg`` replaces the sim's ``UipcSimCfg``."""
    from tacex_tpu_torch.physics.soft.shell import grid_cloth
    from tacex_tpu_torch.uipc import (AffineBodyConstitutionCfg, NeoHookeanShellCfg, UipcObject, UipcObjectCfg,
                                      UipcSim, UipcSimCfg)

    sim = UipcSim(cfg or UipcSimCfg(dt=1 / 100, num_envs=1, enable_ground=True,
                                    contact=UipcSimCfg.Contact(coupling_k=4)), device=device)
    cp, ct = grid_cloth(NX, NX, size=0.06, z=0.03)
    cloth = UipcObject(UipcObjectCfg(constitution=NeoHookeanShellCfg(youngs_modulus=0.1), mass_density=200.0), sim,
                       points=cp, triangles=ct)
    corners = np.asarray([0, NX - 1, NX * (NX - 1), NX * NX - 1], np.int32)
    cloth.set_attachments(corners, strength_ratio=1e4)
    pts, tris = cube_surface(0.006, (0.0, 0.0, BODY_Z))
    body = UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=100.0), mass_density=1000.0), sim,
                      points=pts, triangles=tris)
    sim.setup_sim()
    assert cloth._union_range is not None, "cloth should join the nodal union"
    assert sim._coupled is not None, "expected the coupled cloth-ABD world"
    return sim, cloth, body


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, cloth, body = build(args.device)
    centre = (NX * NX) // 2
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 10 == 9:
            ctr_z = BODY_Z + float(sim.abd_body_pose(body)[0, 2])
            print(f"step {i:3d}  body center z {ctr_z * 1e3:6.2f} mm  "
                  f"cloth center z {float(cloth.nodal_pos_w[0, centre, 2]) * 1e3:6.2f} mm")
    ctr_z = BODY_Z + float(sim.abd_body_pose(body)[0, 2])
    cz = cloth.nodal_pos_w[0, :, 2].cpu().numpy()
    assert np.isfinite(cz).all() and np.isfinite(ctr_z)
    if args.steps >= STEPS:
        assert ctr_z > 0.02, f"body fell through the cloth: {ctr_z}"
        assert cz[centre] < 0.0295, "cloth did not sag under the body"
        print(f"cloth-trampoline OK: body caught at {ctr_z * 1e3:.1f} mm, cloth sagged to {cz[centre] * 1e3:.1f} mm")
    return {"x": cloth.nodal_pos_w.cpu().numpy(), "q": sim.abd_body_pose(body).cpu().numpy(), "body_z": ctr_z,
            "cloth_centre_z": float(cz[centre]), "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
