"""ManiSkill FEM marker-flow demo of the PyTorch/CUDA port: press a batched
FEM gel and show the marker flow.

The port's counterpart of ``check_mani_skill_marker.py``: a FEM gel pad (two
envs in one batched IPC solve) is pressed by a ball, straight down in env 0
and with a shear in x in env 1; ``ManiSkillSimulator`` tracks the marker
grid bound to the deforming surface and emits (init_uv, curr_uv) marker
flow, on ``--device`` (the card by default; ``--device cpu`` runs on the
CPU). Prints the mean marker displacement and signed x-flow of each env,
writes the flow of both as a PNG strip, and raises unless the markers move
in both envs and the two flows differ. This path runs no custom kernel.

Usage: python scripts/demos/check_mani_skill_marker_torch.py [--steps 8] [--out /tmp/mani_skill_marker.png]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

GEL_SIZE = (0.018, 0.014, 0.004)
BALL_R = 0.004
NUM_ENVS = 2  # straight press and press + shear
SEED = 0


def flow_image(flow: np.ndarray, res=(240, 320)) -> np.ndarray:
    """Render (2, M, 2) [init_uv, curr_uv] flow as dots + displacement tails."""
    img = np.full((*res, 3), 0.35, np.float32)
    init, curr = flow[0], flow[1]
    for (u0, v0), (u1, v1) in zip(init, curr):
        if u0 <= 0 and v0 <= 0:
            continue
        # tail: a few samples along the displacement
        for t in np.linspace(0, 1, 8):
            u, v = u0 + t * (u1 - u0), v0 + t * (v1 - v0)
            ui, vi = int(round(v)), int(round(u))
            if 0 <= ui < res[0] and 0 <= vi < res[1]:
                img[max(ui - 1, 0):ui + 2, max(vi - 1, 0):vi + 2] = (0.1, 0.1, 0.1)
        ui, vi = int(round(v1)), int(round(u1))
        if 0 <= ui < res[0] and 0 <= vi < res[1]:
            img[max(ui - 2, 0):ui + 3, max(vi - 2, 0):vi + 3] = (0.9, 0.2, 0.2)
    return img


def run(steps: int, device) -> dict:
    """Press the gel ``steps`` times: {"flows": per step the (N, 2, M, 2)
    flow, "state": the last gel state, "seconds": the steps' host time,
    synchronised, set-up left out}."""
    import torch

    from tacex_tpu_torch.core import maths
    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.physics.soft.ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState
    from tacex_tpu_torch.physics.soft.mesh import box_tet_mesh
    from tacex_tpu_torch.sensors.gelsight.fem import ManiSkillSimulatorCfg
    from tacex_tpu_torch.sensors.gelsight.fem.mani_skill_sim import ManiSkillSimulator
    from tacex_tpu_torch.utils.profiling import synchronize

    dev = resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    # gel in the tool frame, contact face at max z (the ManiSkillSimulator
    # convention), camera 0.0285 m behind it
    size = GEL_SIZE
    mesh = box_tet_mesh(size, (8, 7, 2), center=(0.0, 0.0, -size[2] / 2))
    mount = np.where(mesh.points[:, 2] < -size[2] + 1e-9)[0].astype(np.int32)
    gel = SoftBodyModel(
        mesh, youngs_modulus=1.45e5, poisson_ratio=0.45,
        cfg=IpcSolverCfg(dt=1 / 60, newton_max_iter=4, cg_iters=24, d_hat=5e-4, kappa=2e4),
        attachment_verts=mount, device=dev,
    )
    sim = ManiSkillSimulator(ManiSkillSimulatorCfg(), mesh, device=dev)
    n = NUM_ENVS
    state = SoftBodyState.init(n, mesh.points, device=dev)
    cam_pos = torch.tensor([0.0, 0.0, -0.0285], **f32).expand(n, 3)
    cam_quat = maths.quat_identity((n,), device=dev)
    mount_rest = torch.as_tensor(mesh.points[mount], **f32).expand(n, len(mount), 3)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    flows = []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        t = (i + 1) / steps
        # env 0: press straight down onto the gel; env 1: press + shear in x
        bz = BALL_R + 0.002 - 0.0045 * t
        sph = torch.tensor([[[0.0, 0.0, bz, BALL_R]], [[0.004 * t, 0.0, bz, BALL_R]]], **f32)
        scene = RigidSdfScene(spheres=sph, boxes=torch.zeros((n, 1, 10), **f32),
                              capsules=torch.zeros((n, 1, 8), **f32), planes=torch.zeros((n, 1, 4), **f32))
        state = gel.step(state, scene, mount_rest)
        flows.append(sim.marker_motion_simulation(state, gel.surface_verts, cam_pos, cam_quat, generator))
    synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"flows": [f.cpu().numpy() for f in flows], "state": state, "seconds": seconds}


def main(argv: list[str] | None = None) -> dict:
    """Run the demo and save the strip; returns the final flow's numbers."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="/tmp/mani_skill_marker.png")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch.utils.png import to_uint8, write_png

    final = run(args.steps, args.device)["flows"][-1]  # (n, 2, M, 2)
    disp = np.linalg.norm(final[:, 1] - final[:, 0], axis=-1)
    # signed mean x-flow: a straight press spreads the markers about evenly,
    # a shear drags them together in +x
    mean_dx = (final[:, 1, :, 0] - final[:, 0, :, 0]).mean(axis=-1)
    print(f"mean marker displacement (px): press={disp[0].mean():.2f} shear={disp[1].mean():.2f} | "
          f"signed x-flow: press={mean_dx[0]:+.2f} shear={mean_dx[1]:+.2f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_png(args.out, to_uint8(np.concatenate([flow_image(final[0]), flow_image(final[1])], axis=1)))
    print(f"saved {args.out}")
    # the marker grid is asymmetric in x (marker_flow.py's grid), so even a
    # pure press biases the mean x-flow: check what the demo shows, that the
    # markers follow the deformation in both envs and the two flows differ
    if not disp[0].max() > 0.5:
        raise AssertionError("markers did not move under press")
    if not disp[1].max() > 0.5:
        raise AssertionError("markers did not move under shear")
    if not np.abs(final[1] - final[0]).max() > 0.5:
        raise AssertionError("press and shear flows identical")
    return {"displacement": disp, "mean_dx": mean_dx, "flow": final}


if __name__ == "__main__":
    main()
