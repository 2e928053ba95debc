"""Walking cube on the PyTorch/CUDA port: a RotatingMotor-driven affine cube
tumbles across a free board.

The port's counterpart of ``walking_cube.py``: a free affine board (10 MPa,
500 kg/m^3) on the ground and an affine cube (100 MPa) on it, driven by a
RotatingMotor (+y axis, pi/2 rad/s, strength 300); the cube pushes the board
through body-body contact and friction. 1 env, 240 steps at dt 1/60, then
``check_health``, on ``--device`` (the card by default; ``--device cpu``
runs on the CPU). After the full run it checks that the cube advanced more
than 3 cm in +x and stayed above z = 2 cm (no tunneling).

Usage: python examples/libuipc_samples/walking_cube_torch.py [--steps 240] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

STEPS = 240


def build(device):
    from tacex_tpu_torch.assets.meshes import box_mesh, weld_soup
    from tacex_tpu_torch.uipc import UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import AffineBodyConstitutionCfg

    sim = UipcSim(UipcSimCfg(num_envs=1, dt=1 / 60, enable_ground=True, newton=UipcSimCfg.Newton(max_iter=8),
                             contact=UipcSimCfg.Contact(default_friction_ratio=0.5, d_hat=0.002, resistance=1e4)),
                  device=device)
    bp, bt = weld_soup(box_mesh(0.15, 0.08, 0.01))
    board = UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=10.0), mass_density=500.0), sim,
                       points=bp + np.array([0.0, 0.0, 0.0125], np.float32), triangles=bt)
    cp, ct = weld_soup(box_mesh(0.04, 0.04, 0.04))
    cube = UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(m_kappa=100.0)), sim,
                      points=cp + np.array([-0.08, 0.0, 0.068], np.float32), triangles=ct)
    # the motor turns about +y, which tumbles the cube toward +x
    cube.set_rotating_motor(axis=(0.0, 1.0, 0.0), rot_vel=0.5 * np.pi, strength=300.0)
    sim.setup_sim()
    return sim, board, cube


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, board, cube = build(args.device)
    x0_cube, x0_board = float(cube.root_pos_w[0, 0]), float(board.root_pos_w[0, 0])
    seconds = 0.0
    for i in range(args.steps):
        t0 = time.perf_counter()
        sim.step()
        seconds += time.perf_counter() - t0
        if i % 25 == 0:
            c, b = cube.root_pos_w[0].cpu().numpy(), board.root_pos_w[0].cpu().numpy()
            print(f"step {i:3d}: cube x {c[0]:+.4f} board x {b[0]:+.4f} cube z {c[2]:.4f}")
    overflow = sim.check_health()
    dx_cube = float(cube.root_pos_w[0, 0]) - x0_cube
    dx_board = float(board.root_pos_w[0, 0]) - x0_board
    z_cube = float(cube.root_pos_w[0, 2])
    if args.steps >= STEPS:
        assert dx_cube > 0.03, f"cube did not walk: dx={dx_cube:.4f}"
        assert z_cube > 0.02, f"cube fell through: z={z_cube:.4f}"
        print(f"walking cube: cube advanced {dx_cube:.3f} m, board reacted {dx_board:+.4f} m")
    return {"x": np.concatenate([board.nodal_pos_w.cpu().numpy(), cube.nodal_pos_w.cpu().numpy()], 1),
            "dx_cube": dx_cube, "dx_board": dx_board, "z_cube": z_cube, "overflow": overflow,
            "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
