"""Pick-up demo of the PyTorch/CUDA port (FEM gel pads): grasp a ball with
soft gels on both fingers and lift it.

The port's counterpart of ``pick_up_uipc.py``, on ``--device`` (the card by
default; ``--device cpu`` runs on the CPU):

  * the two finger gels are one batched ``SoftBodyModel`` solve whose batch
    axis is the fingers,
  * each gel is attached (top face) to its finger frame and pressed against
    the ball; the ball feels the reaction of both gels' contact barriers plus
    Coulomb friction at the contact (two-way coupling),
  * tactile depth is taken from each gel's deformed contact face (a 96x72
    grid resized to the sensor's 320x240 image: one pyramid (K1) and one
    LUT-shading (K2) launch on two 240x320 images at the end of each phase).

Phases: approach -> descend -> close -> lift. Prints each phase's state and
``ball lifted <cm> cm (FEM gels)``, writes a tactile strip, and raises if
the ball rose less than 2 cm.

Usage: python scripts/demos/pick_up/pick_up_uipc_torch.py [--steps_per_phase 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))  # repo root, so the script runs from anywhere

BALL_RADIUS, BALL_MASS, BALL_FRICTION = 0.012, 0.02, 0.9
BALL_POS0 = np.array([0.45, 0.0, 0.012 + 0.0026], np.float32)
GEL_SIZE = (0.020, 0.005, 0.024)  # x, y (thickness), z in the finger frame
CAM_RES = (96, 72)
DT = 1.0 / 120.0
IK_ITERS = 6
MIN_LIFT = 0.02


def gel_mesh():
    """The gel's tet mesh in the finger-local frame: contact face at y = 0
    (facing the ball), mount face at y = thickness. Built with the thickness
    along +z, then rotated -90 deg about x (a proper rotation: swapping axes
    would mirror the mesh and invert the tets). Returns (mesh, mount ids,
    contact-face grid ids (8, 7) in row-major order)."""
    from tacex_tpu_torch.physics.soft.mesh import box_tet_mesh

    mesh = box_tet_mesh((GEL_SIZE[0], GEL_SIZE[2], GEL_SIZE[1]), (6, 7, 2), center=(0.0, 0.0, GEL_SIZE[1] / 2))
    pts = np.stack([mesh.points[:, 0], mesh.points[:, 2], -mesh.points[:, 1]], -1)
    mount = np.where(pts[:, 1] > GEL_SIZE[1] - 1e-9)[0].astype(np.int32)
    contact_face = np.where(pts[:, 1] < 1e-9)[0].astype(np.int32)
    fpts = pts[contact_face]
    grid_ids = contact_face[np.lexsort((fpts[:, 0], fpts[:, 2]))].reshape(8, 7)  # (nz+1, nx+1)
    return dataclasses.replace(mesh, points=pts), mount, grid_ids


def run(steps_per_phase: int, device) -> dict:
    """The four phases: {"lifted": m, "frames": per phase a (2*240, 320, 3)
    image of both pads, "log": per phase a dict of the printed numbers,
    "seconds": the four phases' host time, synchronised, "gel_x": the gels}."""
    import torch

    from tacex_tpu_torch.core import maths
    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.ops.resize import resize_linear
    from tacex_tpu_torch.physics.rigid import articulation as art
    from tacex_tpu_torch.physics.rigid import contact, franka
    from tacex_tpu_torch.physics.soft.ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
    from tacex_tpu_torch.utils.profiling import synchronize

    dev = resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    ball = contact.SphereParams(radius=BALL_RADIUS, mass=BALL_MASS, friction=BALL_FRICTION)
    sensor = GelSightSensor(gelsight_mini_cfg(camera_resolution=CAM_RES, with_markers=False), num_envs=2, device=dev)
    sstate = sensor.init_state()
    limits = franka.ArmLimits.on(dev)

    mesh, mount, grid_ids = gel_mesh()
    gel = SoftBodyModel(
        mesh, youngs_modulus=1.45e5, poisson_ratio=0.45,
        cfg=IpcSolverCfg(dt=DT, newton_max_iter=4, cg_iters=24, d_hat=5e-4, kappa=2e4),
        attachment_verts=mount, device=dev,
    )
    rest_local = torch.as_tensor(mesh.points, **f32)  # (V, 3) finger-local
    mount_local = rest_local[torch.as_tensor(mount, device=dev).long()]
    grid_flat = torch.as_tensor(grid_ids.reshape(-1), device=dev).long()

    arm = art.GripperArmState.init(1, torch.tensor(franka.Q_DEFAULT, **f32), finger_width=0.06)
    ball_pos = torch.as_tensor(BALL_POS0, device=dev)[None]
    ball_lin = torch.zeros((1, 3), **f32)
    ball_ang = torch.zeros((1, 3), **f32)
    gravity = torch.tensor([0.0, 0.0, -9.81], **f32)
    down_quat = maths.quat_from_angle_axis(torch.tensor(math.pi, **f32), torch.tensor([1.0, 0.0, 0.0], **f32))
    tcp_off = (0.0, 0.0, art.HAND_TCP_OFFSET)
    empty = dict(boxes=torch.zeros((2, 1, 10), **f32), capsules=torch.zeros((2, 1, 8), **f32),
                 planes=torch.zeros((2, 1, 4), **f32))

    def ball_scene(ball_pos):
        return RigidSdfScene(spheres=torch.cat([ball_pos[0], torch.full((1,), ball.radius, **f32)]).expand(2, 1, 4),
                             **empty)

    def finger_frames(arm_q):
        """Pose of each gel's local frame (origin = pad centre, contact face
        at local y = 0, mount face at local +y = into the finger body)."""
        pads, _, rot = art.finger_positions(arm_q)  # (1, 2, 3), (1, 3, 3)
        x, y, z = rot[0, :, 0], rot[0, :, 1], rot[0, :, 2]
        # finger 0 sits at +y of the hand (ball toward -y): mount dir = +y;
        # finger 1: mount dir = -y, x flipped too to stay right-handed
        r0 = torch.stack([x, y, z], -1)
        r1 = torch.stack([-x, -y, z], -1)
        return pads[0], torch.stack([maths.quat_from_matrix(r0), maths.quat_from_matrix(r1)])  # (2, 3), (2, 4)

    def ik_target(arm, goal_pos):
        qt = arm.q_target[:, :7]
        for _ in range(IK_ITERS):
            pos, quat, orig, ax = franka.forward_kinematics(qt, ee_offset_pos=tcp_off)
            jac = franka.geometric_jacobian(pos, orig, ax)
            rot_err = maths.axis_angle_from_quat(maths.quat_mul(down_quat.expand(quat.shape), maths.quat_conjugate(quat)))
            qt = torch.clamp(franka.dls_ik_step(qt, goal_pos - pos, rot_err, jac), limits.q_lower, limits.q_upper)
        return qt

    def physics(arm, gel_state, ball_pos, ball_lin, ball_ang, q_target):
        arm = art.GripperArmState(arm.q, arm.qd, q_target)
        pads_old, _, _ = art.finger_positions(arm.q)
        arm = art.step(arm, DT)
        pos, quats = finger_frames(arm.q)
        pad_vel = (pos - pads_old[0]) / DT  # (2, 3)

        # the ball: gravity + both gels' barrier reaction + friction + plate
        f_gel = gel.sphere_contact_force(gel_state, ball_scene(ball_pos))[:, 0]  # (2, 3)
        ball_lin = ball_lin + gravity * DT
        # both gels resolved against the same incoming ball velocity, the
        # impulses summed afterwards (as in pick_up_rigid)
        dv_sum = torch.zeros_like(ball_lin)
        for i in range(2):
            f = f_gel[i][None]  # (1, 3)
            f_mag = torch.linalg.vector_norm(f, dim=-1)
            dv = f * (DT / ball.mass)
            dv_n = torch.linalg.vector_norm(dv, dim=-1, keepdim=True)
            dv_sum = dv_sum + dv * torch.clamp(0.25 / dv_n.clamp_min(1e-9), max=1.0)
            # Coulomb friction against the finger-following gel; the pinch
            # locks the ball's rotation, so the slip is translational
            in_c = f_mag > 1e-6
            n_dir = f / f_mag.clamp_min(1e-9)[..., None]
            v_rel = ball_lin - pad_vel[i][None]
            vt = v_rel - (v_rel * n_dir).sum(-1, keepdim=True) * n_dir
            vt_mag = torch.linalg.vector_norm(vt, dim=-1)
            jt = torch.minimum(ball.friction * f_mag * DT, ball.mass * vt_mag)
            t_dir = vt / vt_mag.clamp_min(1e-9)[..., None]
            dv_sum = dv_sum - jt[..., None] * t_dir * in_c[..., None] / ball.mass
        ball_lin = ball_lin + dv_sum
        dl, da = contact.sphere_plane_contact(ball_pos, ball_lin, ball_ang, (0.0, 0.0, 1.0), 0.0026, ball, DT)
        ball_lin, ball_ang = ball_lin + dl, ball_ang + da
        ball_pos = ball_pos + ball_lin * DT

        # the FEM gels deform against the (new) ball
        aim = maths.transform_points(mount_local[None], pos, quats)  # (2, A, 3)
        gel_state = gel.step(gel_state, ball_scene(ball_pos), aim)
        grip = torch.linalg.vector_norm(f_gel, dim=-1).sum()
        return arm, gel_state, ball_pos, ball_lin, ball_ang, grip

    def finger_tactile(sstate, gel_state, arm):
        pos, quats = finger_frames(arm.q)
        # depth = the contact face's distance from each finger's camera,
        # 0.0285 m behind the contact face along local -y
        face_world = gel_state.x[:, grid_flat]  # (2, G, 3)
        face_local = maths.quat_apply_inverse(quats[:, None], face_world - pos[:, None])
        depth_grid = (face_local[..., 1] + 0.0285).reshape(2, *grid_ids.shape)
        return sensor.update(sstate, resize_linear(depth_grid, (2, CAM_RES[1], CAM_RES[0])))

    grasp_z = float(BALL_POS0[2])
    # the pad centres carry the gel contact face (local y = 0): a width at
    # which each face presses 1.5 mm into the ball
    grip_w = 2 * BALL_RADIUS - 0.003
    phases = [
        ("approach", np.array([*BALL_POS0[:2], grasp_z + 0.10]), 0.06),
        ("descend", np.array([*BALL_POS0[:2], grasp_z]), 0.06),
        ("close", np.array([*BALL_POS0[:2], grasp_z]), grip_w),
        ("lift", np.array([*BALL_POS0[:2], grasp_z + 0.06]), grip_w),
    ]
    pos0, quats0 = finger_frames(arm.q)
    x0 = maths.transform_points(rest_local[None], pos0, quats0)  # (2, V, 3)
    gel_state = SoftBodyState(x=x0, v=torch.zeros_like(x0))
    frames, log = [], []
    prev_goal, prev_width = None, 0.06
    t0 = time.perf_counter()
    for name, goal, width in phases:
        for k in range(steps_per_phase):
            frac = min(1.0, (k + 1) / (0.6 * steps_per_phase))
            g = goal if prev_goal is None else prev_goal + frac * (goal - prev_goal)
            w = prev_width + frac * (width - prev_width)
            qt_arm = ik_target(arm, torch.as_tensor(g, **f32)[None])
            q_target = torch.cat([qt_arm, torch.full((1, 2), w / 2, **f32)], -1)
            arm, gel_state, ball_pos, ball_lin, ball_ang, grip = physics(arm, gel_state, ball_pos, ball_lin, ball_ang,
                                                                         q_target)
        prev_goal, prev_width = goal, width
        sstate, out = finger_tactile(sstate, gel_state, arm)
        frames.append(torch.cat(list(out["tactile_rgb"]), 0).cpu().numpy())
        _, tcp, _ = art.finger_positions(arm.q)
        entry = {"phase": name, "ball_z": float(ball_pos[0, 2]), "grip": float(grip),
                 "indent": out["indentation_depth"].cpu().numpy(), "tcp": tcp[0].cpu().numpy(),
                 "ball": ball_pos[0].cpu().numpy(), "qf": arm.q[0, 7:].cpu().numpy()}
        log.append(entry)
        print(f"{name:9s}: ball z={entry['ball_z']:.3f} grip|f|={entry['grip']:.2f} N "
              f"indent={entry['indent'].round(2)} tcp={entry['tcp'].round(4)} ball={entry['ball'].round(4)} "
              f"qf={entry['qf'].round(4)}")
    synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"lifted": float(ball_pos[0, 2]) - float(BALL_POS0[2]), "frames": frames, "log": log, "seconds": seconds,
            "gel_x": gel_state.x}


def main(argv: list[str] | None = None) -> dict:
    """Run the demo and save the strip; returns ``run``'s dict."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps_per_phase", type=int, default=100)
    p.add_argument("--out", default="/tmp/pick_up_uipc.png")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch.utils.png import to_uint8, write_png

    r = run(args.steps_per_phase, args.device)
    print(f"ball lifted {r['lifted'] * 100:.1f} cm (FEM gels)")
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
