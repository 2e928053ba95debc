"""Franka + soft gel pad attachment on the PyTorch/CUDA port.

The port's counterpart of ``single_uipc_attachment.py``: a gel pad of
(6, 8, 2) cells is attached to the Franka flange with soft position
constraints and dragged down, then sideways, over a fixed 6 mm sphere, 2
envs, 40 steps at dt 1/60, on ``--device`` (the card by default;
``--device cpu`` runs on the CPU). Prints the gel's center every 10 steps
and the sim's time report.

Usage: python examples/single_uipc_attachment_torch.py [--steps 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root, so the script runs from anywhere

NUM_ENVS = 2
STEPS = 40
SPHERE_Z = -0.012
SPHERE_R = 0.006


def build(device):
    from tacex_tpu_torch.uipc import (
        StableNeoHookeanCfg,
        UipcIsaacAttachments,
        UipcIsaacAttachmentsCfg,
        UipcObject,
        UipcObjectCfg,
        UipcSim,
        UipcSimCfg,
    )
    from tacex_tpu_torch.uipc.objects import TetMeshCfg

    sim = UipcSim(UipcSimCfg(num_envs=NUM_ENVS, dt=1 / 60), device=device)
    gel = UipcObject(
        UipcObjectCfg(
            mesh_cfg=TetMeshCfg(size=(0.0208, 0.0252, 0.0045), resolution=(6, 8, 2), center=(0, 0, -0.00225)),
            constitution=StableNeoHookeanCfg(youngs_modulus=0.145, poisson_rate=0.45),
        ),
        sim,
    )
    att = UipcIsaacAttachments(UipcIsaacAttachmentsCfg(attachment_points_radius=5e-4), gel)
    att.compute_attachment_data(np.zeros(3), np.array([1.0, 0, 0, 0]))
    sim.setup_sim()
    return sim, gel, att


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from tacex_tpu_torch.core import maths
    from tacex_tpu_torch.physics.rigid import franka
    from tacex_tpu_torch.physics.soft.ipc import RigidSdfScene

    sim, gel, att = build(args.device)
    dev, n = sim.device, NUM_ENVS
    f32 = dict(dtype=torch.float32, device=dev)
    limits = franka.ArmLimits.on(dev)
    arm = franka.ArmState.init(n, torch.tensor(franka.Q_DEFAULT, **f32))
    # spawn the gel at the flange pose (the rest mesh is in the tool frame); the
    # sphere is fixed below the tool's first commanded position
    tool_pos0, tool_quat0 = franka.forward_kinematics(arm.q)[:2]
    gel.write_vertex_positions_to_sim(maths.transform_points(torch.as_tensor(gel.init_vertex_pos, **f32)[None],
                                                             tool_pos0, tool_quat0))
    down = torch.tensor([[0.0, 0.0, -0.2 * 0.05]], **f32).expand(n, 3)
    side = torch.tensor([[0.15 * 0.05, 0.0, 0.0]], **f32).expand(n, 3)
    no_rot = torch.zeros((n, 3), **f32)
    sphere_off = torch.tensor([0.0, 0.0, SPHERE_Z], **f32)
    seconds, scene = 0.0, None
    for i in range(args.steps):
        # drive the arm down, then sideways
        arm = franka.apply_delta_pose_ik(arm, side if i > 15 else down, no_rot, limits)
        arm = franka.servo_step(arm, sim.cfg.dt, limits)
        tool_pos, tool_quat = franka.forward_kinematics(arm.q)[:2]
        gel._aim_provider = lambda p=tool_pos, q=tool_quat: att.aim_positions(p, q)
        if scene is None:  # the sphere stays below the tool's position after the first servo step
            sphere = torch.cat([tool_pos + sphere_off, torch.full((n, 1), SPHERE_R, **f32)], -1)
            scene = RigidSdfScene(spheres=sphere[:, None, :], boxes=torch.zeros((n, 1, 10), **f32),
                                  capsules=torch.zeros((n, 1, 8), **f32), planes=torch.zeros((n, 1, 4), **f32))
        t0 = time.perf_counter()
        sim.step(scene)
        seconds += time.perf_counter() - t0
        if i % 10 == 0:
            x = gel.nodal_pos_w.cpu().numpy()
            print(f"step {i:3d}: gel center {x.mean(axis=(1,)).round(4)[0]}")
    print("done;", sim.get_sim_time_report())
    return {"x": gel.nodal_pos_w.cpu().numpy(), "ms_per_step": 1e3 * seconds / max(args.steps, 1)}


if __name__ == "__main__":
    main()
