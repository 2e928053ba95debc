"""Follow-goal demo of the PyTorch/CUDA port: Franka + GelSight Mini tracks
a moving goal pose.

The port's counterpart of ``follow_goal.py``: the goal follows a scripted
square with a press dip over a plate-mounted test sphere, the arm tracks it
with the envs' damped-least-squares IK (4 iterations a control step), and
the 320x240 sensor renders every step, on ``--device`` (the card by default;
``--device cpu`` runs on the CPU). Prints the mean and final tracking error
and writes up to 8 in-contact tactile frames as a PNG strip. Each step's
sensor update is one pyramid (K1) and one LUT-shading (K2) launch on one
240x320 image.

Usage: python scripts/demos/follow_goal_torch.py [--steps 150] [--out /tmp/follow_goal.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

EE_OFF = (0.0, 0.0, 0.131)
PLATE_TOP = 0.0026
SPHERE = (0.45, 0.0, PLATE_TOP + 0.008, 0.008)  # center x, y, z, radius
CAM_EXTENT = (0.0295 * 640 / 1000.0, 0.0295 * 480 / 1000.0)
Q0 = (-1.02, 0.3175, 0.06, -2.60, 0.0, 2.91, -0.12)
IK_ITERS = 4
MAX_FRAMES = 8
CONTACT_MM = 0.05


def goal_at(t: float) -> np.ndarray:
    """Square sweep at hover height, with a press dip over the sphere."""
    cx, cy, r = SPHERE[0], SPHERE[1], 0.06
    corners = np.array([[cx - r, cy - r], [cx + r, cy - r], [cx + r, cy + r], [cx - r, cy + r]], np.float32)
    seg = t % 5
    if seg < 4:  # edges of the square
        a = corners[int(seg) % 4]
        b = corners[(int(seg) + 1) % 4]
        xy = a + (seg - int(seg)) * (b - a)
        z = 0.05
    else:  # press over the sphere
        xy = np.array([cx, cy], np.float32)
        z = 0.05 - 0.04 * np.sin(np.pi * (seg - 4))  # dip to ~1 cm (press)
    return np.array([xy[0], xy[1], z], np.float32)


def run(steps: int, dt: float, device) -> dict:
    """Track the goal for ``steps`` control steps: {"errors": (steps,) m,
    "frames": in-contact (240, 320, 3) images, "indentation": (steps,) mm,
    "seconds": the steps' host time, synchronised, set-up left out}."""
    import torch

    from tacex_tpu_torch.core import maths
    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.physics.rigid import franka
    from tacex_tpu_torch.render.depth_camera import SdfScene, render_depth_batch
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
    from tacex_tpu_torch.utils.profiling import synchronize

    dev = resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    sensor = GelSightSensor(gelsight_mini_cfg(camera_resolution=(320, 240)), num_envs=1, device=dev)
    sstate = sensor.init_state()
    limits = franka.ArmLimits.on(dev)
    q = torch.tensor([Q0], **f32)
    down_quat = maths.quat_from_angle_axis(torch.tensor(math.pi, **f32), torch.tensor([1.0, 0.0, 0.0], **f32))
    ocfg = sensor.cfg.optical_sim_cfg
    cam_dist = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
    z_unit = torch.tensor([0.0, 0.0, 1.0], **f32)
    scene = SdfScene(
        spheres=torch.tensor([[list(SPHERE)]], **f32),
        boxes=torch.zeros((1, 1, 10), **f32),
        capsules=torch.zeros((1, 1, 8), **f32),
        planes=torch.tensor([[[0.0, 0.0, 1.0, PLATE_TOP]]], **f32),
    )

    def track(q, goal):
        pos, quat, orig, ax = franka.forward_kinematics(q, ee_offset_pos=EE_OFF)
        jac = franka.geometric_jacobian(pos, orig, ax)
        rot_err = maths.axis_angle_from_quat(maths.quat_mul(down_quat.expand(quat.shape), maths.quat_conjugate(quat)))
        q = torch.clamp(franka.dls_ik_step(q, goal - pos, rot_err, jac), limits.q_lower, limits.q_upper)
        return q, pos, quat

    errors, indents, frames = [], [], []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        goal = torch.as_tensor(goal_at(i * dt * 3), device=dev)[None]
        for _ in range(IK_ITERS):
            q, pos, quat = track(q, goal)
        errors.append(torch.linalg.vector_norm(goal - pos))
        cam_pos = pos - cam_dist * maths.quat_apply(quat, z_unit)
        depth = render_depth_batch(cam_pos, quat, scene, (320, 240), CAM_EXTENT, far=0.029)
        sstate, out = sensor.update(sstate, depth)
        indents.append(out["indentation_depth"][0])
        if len(frames) < MAX_FRAMES and float(indents[-1]) > CONTACT_MM:
            frames.append(out["tactile_rgb"][0].cpu().numpy())
    synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"errors": torch.stack(errors).cpu().numpy(), "frames": frames,
            "indentation": torch.stack(indents).cpu().numpy(), "seconds": seconds}


def main(argv: list[str] | None = None) -> dict:
    """Run the demo and save the strip; returns ``run``'s dict."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--dt", type=float, default=1 / 30)
    p.add_argument("--out", default="/tmp/follow_goal.png")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch.utils.png import to_uint8, write_png

    r = run(args.steps, args.dt, args.device)
    errors = r["errors"]
    print(f"tracking error: mean {np.mean(errors) * 1000:.2f} mm, final {errors[-1] * 1000:.2f} mm")
    print(f"{args.steps} steps in {r['seconds']:.1f} s: {1e3 * r['seconds'] / args.steps:.1f} ms a step "
          "(host clock, synchronised)")
    print(f"in-contact tactile frames recorded: {len(r['frames'])}")
    if r["frames"]:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        write_png(args.out, to_uint8(np.concatenate(r["frames"], axis=1)))
        print(f"saved {args.out}")
    if not np.mean(errors[10:]) < 0.02:
        raise AssertionError("IK tracking did not converge")
    return r


if __name__ == "__main__":
    main()
