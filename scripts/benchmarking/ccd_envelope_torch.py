"""The kinematic-collider CCD envelope on the PyTorch/CUDA port.

The port's counterpart of ``ccd_envelope.py``: a rigid sphere flies straight
down through a thin gel slab hung by its rim (20 x 25 x 4.5 mm, (6, 7, 2)
cells), at each (dt, velocity), and the slab's largest deflection says
whether the barrier ever saw it: a collider moves between steps, so the
line search's crossing tests cannot catch one that jumps past the slab in
one step. With ``--substeps k`` each step runs k solves at dt/k against the
sphere's pose swept from the previous frame (``IpcSolverCfg.ccd_substeps``
with ``scene_prev``), which brings a tunnelling configuration back inside
the envelope. Runs on ``--device`` (the card by default; ``--device cpu``
runs on the CPU) and prints one JSON line per (dt, velocity), as the JAX
script.

Usage: python scripts/benchmarking/ccd_envelope_torch.py [--substeps 1] [--dts 0.0166 ...] [--velocities 0.8 ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

THICK = 0.0045  # slab thickness (m), the gel pad's
D_HAT = 0.001
R_SPH = 0.005


def build_model(dt: float, substeps: int, device):
    from tacex_tpu_torch.physics.soft import IpcSolverCfg, SoftBodyModel, box_tet_mesh

    mesh = box_tet_mesh(size=(0.02, 0.025, THICK), resolution=(6, 7, 2), center=(0, 0, 0))
    p = mesh.points
    rim = np.where((np.abs(p[:, 0]) > 0.02 / 2 - 1e-6) | (np.abs(p[:, 1]) > 0.025 / 2 - 1e-6))[0].astype(np.int32)
    cfg = IpcSolverCfg(dt=dt, newton_max_iter=6, cg_iters=16, d_hat=D_HAT, ccd_substeps=substeps,
                       gravity=(0.0, 0.0, 0.0))
    return SoftBodyModel(mesh, cfg=cfg, attachment_verts=rim, device=device)


def sphere_scene(z, device):
    """The one-env scene of the sphere at height z (a 0-dim device tensor)."""
    import torch

    from tacex_tpu_torch.physics.soft import RigidSdfScene

    sc = RigidSdfScene.empty(1, device=device)
    sph = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z, torch.full_like(z, R_SPH)]).view(1, 1, 4)
    return RigidSdfScene(spheres=sph, boxes=sc.boxes, capsules=sc.capsules, planes=sc.planes)


def run(dt: float, vel: float, substeps: int, device) -> dict:
    import torch

    from tacex_tpu_torch.physics.soft import SoftBodyState

    m = build_model(dt, substeps, device)
    dev = m.device
    aim = torch.as_tensor(m.mesh.points[m.attachment_verts.cpu().numpy()], device=dev)[None]
    state = SoftBodyState.init(1, m.mesh.points, device=dev)
    x0 = state.x.clone()
    z_start = R_SPH + THICK / 2 + 2 * D_HAT + 0.002
    n_frames = int(np.ceil(2 * z_start / (vel * dt))) + 2
    zs = torch.as_tensor(np.array([z_start - vel * dt * i for i in range(n_frames + 1)], np.float32), device=dev)
    defl = torch.zeros((), device=dev)
    for i in range(1, n_frames + 1):
        state = m.step(state, sphere_scene(zs[i], dev), aim, scene_prev=sphere_scene(zs[i - 1], dev))
        defl = torch.maximum(defl, (state.x[0] - x0[0]).abs().amax())
    max_defl = float(defl)
    return {
        "dt": round(dt, 6),
        "velocity_mps": vel,
        "step_disp_mm": round(1e3 * vel * dt, 3),
        "substeps": substeps,
        "max_deflection_mm": round(1e3 * max_defl, 4),
        "tunneled": bool(max_defl < 2e-4),  # the slab never reacted
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--substeps", type=int, default=1)
    ap.add_argument("--dts", type=float, nargs="*", default=[1 / 60, 1 / 120, 1 / 240, 1 / 480])
    ap.add_argument("--velocities", type=float, nargs="*", default=[0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []
    for dt in args.dts:
        for v in args.velocities:
            rows.append(run(dt, v, args.substeps, args.device))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
