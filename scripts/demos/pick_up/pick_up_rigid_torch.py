"""Pick-up demo of the PyTorch/CUDA port (rigid gel pads): grasp a ball with
the 9-DOF gripper and lift it.

The port's counterpart of ``pick_up_rigid.py``, on ``--device`` (the card by
default; ``--device cpu`` runs on the CPU):

  * 9-DOF articulated arm+gripper dynamics (implicit PD, gravity),
  * ball-vs-finger-pad contacts resolved with the impulse model, with the
    action-reaction force fed back to the finger prismatic joints,
  * both fingers' tactile RGB rendered from the ball in each finger's frame
    (a 160x120 depth camera, resized to the sensor's 320x240 image: one
    pyramid (K1) and one LUT-shading (K2) launch on two 240x320 images at the
    end of each phase).

Phases: approach above the ball -> descend -> close fingers -> lift. Prints
each phase's state and ``ball lifted <cm> cm``, writes a left/right tactile
strip, and raises if the ball rose less than 3 cm.

Usage: python scripts/demos/pick_up/pick_up_rigid_torch.py [--steps_per_phase 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))  # repo root, so the script runs from anywhere

BALL_RADIUS, BALL_MASS, BALL_FRICTION = 0.012, 0.02, 0.9
BALL_POS0 = np.array([0.45, 0.0, 0.012 + 0.0026], np.float32)
PAD_HALF = (0.012, 0.004, 0.014)  # finger gel pad box
CAM_EXTENT = (0.0295 * 640 / 1000.0, 0.0295 * 480 / 1000.0)
CAM_RES = (160, 120)
DT = 1.0 / 120.0
IK_ITERS = 6
MIN_LIFT = 0.03


def run(steps_per_phase: int, device) -> dict:
    """The four phases: {"lifted": m, "frames": per phase a (2*240, 320, 3)
    image of both fingers, "log": per phase a dict of the printed numbers,
    "seconds": the four phases' host time, synchronised}."""
    import torch

    from tacex_tpu_torch.core import maths
    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.physics.rigid import articulation as art
    from tacex_tpu_torch.physics.rigid import contact, franka
    from tacex_tpu_torch.render.depth_camera import SdfScene, render_depth_batch
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
    from tacex_tpu_torch.utils.profiling import synchronize

    dev = resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    ball = contact.SphereParams(radius=BALL_RADIUS, mass=BALL_MASS, friction=BALL_FRICTION)
    pad_half = torch.tensor(PAD_HALF, **f32)
    sensor = GelSightSensor(gelsight_mini_cfg(camera_resolution=CAM_RES), num_envs=2, device=dev)
    sstate = sensor.init_state()
    limits = franka.ArmLimits.on(dev)

    # start joint pose: hand above the ball pointing down
    arm = art.GripperArmState.init(1, torch.tensor(franka.Q_DEFAULT, **f32), finger_width=0.06)
    ball_pos = torch.as_tensor(BALL_POS0, device=dev)[None]
    ball_lin = torch.zeros((1, 3), **f32)
    ball_ang = torch.zeros((1, 3), **f32)
    gravity = torch.tensor([0.0, 0.0, -9.81], **f32)
    down_quat = maths.quat_from_angle_axis(torch.tensor(math.pi, **f32), torch.tensor([1.0, 0.0, 0.0], **f32))
    tcp_off = (0.0, 0.0, art.HAND_TCP_OFFSET)
    planes = torch.tensor([0.0, 0.0, 1.0, -1.0], **f32).expand(2, 1, 4)

    def ik_target(arm, goal_pos):
        """Move the arm's q_target toward the goal TCP pose with DLS steps."""
        qt = arm.q_target[:, :7]
        for _ in range(IK_ITERS):
            pos, quat, orig, ax = franka.forward_kinematics(qt, ee_offset_pos=tcp_off)
            jac = franka.geometric_jacobian(pos, orig, ax)
            rot_err = maths.axis_angle_from_quat(maths.quat_mul(down_quat.expand(quat.shape), maths.quat_conjugate(quat)))
            qt = torch.clamp(franka.dls_ik_step(qt, goal_pos - pos, rot_err, jac), limits.q_lower, limits.q_upper)
        return qt

    def physics(arm, ball_pos, ball_lin, ball_ang, tau_f, q_target):
        arm = art.GripperArmState(arm.q, arm.qd, q_target)
        pads_old, _, _ = art.finger_positions(arm.q)
        # finger reaction torque lags one step (staggered coupling)
        arm = art.step(arm, DT, tau_ext=torch.cat([torch.zeros((1, 7), **f32), tau_f], -1))
        pads, _, hand_rot = art.finger_positions(arm.q)
        hand_quat = maths.quat_from_matrix(hand_rot)
        y_axis = hand_rot[..., :, 1]  # finger slide axis

        ball_lin = ball_lin + gravity * DT
        # both pads resolved against the same incoming ball velocity, then the
        # impulses summed: resolving them in turn makes the symmetric squeeze
        # asymmetric and squirts the ball out sideways
        dls, das, taus = [], [], []
        for i, sgn in enumerate((1.0, -1.0)):
            pad_vel = (pads[:, i] - pads_old[:, i]) / DT
            dl, da = contact.sphere_box_contact(ball_pos, ball_lin, ball_ang, pads[:, i], hand_quat, pad_vel,
                                                pad_half, ball, DT, lock_rotation=True)
            dls.append(dl)
            das.append(da)
            # reaction on the finger's prismatic DOF (finger 0 slides +y,
            # finger 1 slides -y; closing = moving toward the ball)
            taus.append((-dl * ball.mass / DT * (sgn * y_axis)).sum(-1))
        tau_f = torch.stack(taus, -1)
        ball_lin = ball_lin + dls[0] + dls[1]
        ball_ang = ball_ang + das[0] + das[1]
        dl, da = contact.sphere_plane_contact(ball_pos, ball_lin, ball_ang, (0.0, 0.0, 1.0), 0.0026, ball, DT)
        ball_lin, ball_ang = ball_lin + dl, ball_ang + da
        ball_pos = ball_pos + ball_lin * DT
        return arm, ball_pos, ball_lin, ball_ang, tau_f, tau_f.abs().sum(-1)

    def finger_tactile(sstate, arm, ball_pos):
        """Both finger sensors batched: a camera behind each pad looking inward."""
        pads, _, hand_rot = art.finger_positions(arm.q)
        y = hand_rot[..., :, 1]
        cam_dist = 0.0285
        cam_pos = torch.cat([pads[:, 0] + cam_dist * y, pads[:, 1] - cam_dist * y], 0)
        # camera +z looks along -y (left) / +y (right) of the hand frame
        rot_l = torch.stack([hand_rot[0, :, 0], hand_rot[0, :, 2], -hand_rot[0, :, 1]], -1)
        rot_r = torch.stack([hand_rot[0, :, 0], -hand_rot[0, :, 2], hand_rot[0, :, 1]], -1)
        cam_quat = torch.stack([maths.quat_from_matrix(rot_l), maths.quat_from_matrix(rot_r)])
        sph = torch.cat([ball_pos[0], torch.full((1,), ball.radius, **f32)]).expand(2, 1, 4)
        scene = SdfScene(spheres=sph, boxes=torch.zeros((2, 1, 10), **f32), capsules=torch.zeros((2, 1, 8), **f32),
                         planes=planes)
        depth = render_depth_batch(cam_pos, cam_quat, scene, CAM_RES, CAM_EXTENT, far=0.029)
        return sensor.update(sstate, depth)

    grasp_z = float(BALL_POS0[2])
    # close to a preload width, not zero: commanding width 0 drives the pads
    # through the ball and ejects it; the grip force is the finger PD spring
    # at the commanded 3 mm squeeze, as in the factory env's grip preload
    grip_w = 2 * (BALL_RADIUS + PAD_HALF[1] - 0.007)
    phases = [
        ("approach", np.array([*BALL_POS0[:2], grasp_z + 0.12]), 0.06),
        ("descend", np.array([*BALL_POS0[:2], grasp_z]), 0.06),
        ("close", np.array([*BALL_POS0[:2], grasp_z]), grip_w),
        ("lift", np.array([*BALL_POS0[:2], grasp_z + 0.08]), grip_w),
    ]
    frames, log = [], []
    tau_f = torch.zeros((1, 2), **f32)
    prev_goal = None
    t0 = time.perf_counter()
    for name, goal, width in phases:
        for k in range(steps_per_phase):
            # ramp the goal over the lift: a step change makes the PD arm
            # accelerate faster than the friction grip can follow
            if name == "lift" and prev_goal is not None:
                g = prev_goal + min(1.0, (k + 1) / steps_per_phase) * (goal - prev_goal)
            else:
                g = goal
            qt_arm = ik_target(arm, torch.as_tensor(g, **f32)[None])
            q_target = torch.cat([qt_arm, torch.full((1, 2), width / 2, **f32)], -1)
            arm, ball_pos, ball_lin, ball_ang, tau_f, grip = physics(arm, ball_pos, ball_lin, ball_ang, tau_f, q_target)
        prev_goal = goal
        sstate, out = finger_tactile(sstate, arm, ball_pos)
        frames.append(torch.cat(list(out["tactile_rgb"]), 0).cpu().numpy())
        entry = {"phase": name, "hand_z": float(art.finger_positions(arm.q)[1][0, 2]),
                 "ball_z": float(ball_pos[0, 2]), "qf": arm.q[0, 7:].cpu().numpy(), "grip": float(grip[0]),
                 "indent": out["indentation_depth"].cpu().numpy()}
        log.append(entry)
        print(f"{name:9s}: hand z={entry['hand_z']:.3f} ball z={entry['ball_z']:.3f} qf={entry['qf']} "
              f"grip force={entry['grip']:.2f} N indent={entry['indent']}")
    synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"lifted": float(ball_pos[0, 2]) - float(BALL_POS0[2]), "frames": frames, "log": log, "seconds": seconds}


def main(argv: list[str] | None = None) -> dict:
    """Run the demo and save the strip; returns ``run``'s dict."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps_per_phase", type=int, default=120)
    p.add_argument("--out", default="/tmp/pick_up_rigid.png")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch.utils.png import to_uint8, write_png

    r = run(args.steps_per_phase, args.device)
    print(f"ball lifted {r['lifted'] * 100:.1f} cm")
    steps = 4 * args.steps_per_phase
    print(f"{steps} steps in {r['seconds']:.1f} s: {1e3 * r['seconds'] / steps:.1f} ms a step (host clock, synchronised)")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_png(args.out, to_uint8(np.concatenate(r["frames"], axis=1)))
    print(f"saved {args.out}")
    if not r["lifted"] > MIN_LIFT:
        raise AssertionError(f"grasp failed: ball only rose {r['lifted'] * 100:.1f} cm")
    return r


if __name__ == "__main__":
    main()
