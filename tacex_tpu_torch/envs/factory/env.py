"""Factory contact-rich insertion tasks with a tactile-equipped gripper (PyTorch).

Port of ``tacex_tpu/envs/factory/env.py``: a Franka with a two-finger
gripper holds an asset (peg, gear or nut) to insert onto a fixed asset
(hole, gear shaft, bolt), with a GelSight sensor on each finger.

  * the arm is the 9-DOF second-order articulation of
    ``physics/rigid/articulation.py`` under operational-space torque control;
  * the held asset is a 6-DoF rigid body held by a compliant grasp and
    pushed against the fixed asset's SDF by penalty contact and friction
    (``contact.py``);
  * each finger's tactile image is rendered from the held asset's triangle
    mesh in that finger's camera frame: the 2N cameras of the batch are one
    rasterizer call and one sensor update, so the pyramid and shading
    kernels launch once each a step, on (2N, 32, 32) images.

Actions are 6-dim bounded delta poses smoothed by an EMA; rewards are the
keypoint squashing terms at three scales plus engagement and success
bonuses. ``step`` never reads a value back to the host: resets are selected
by mask, and random draws come from the env's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...assets import meshes
from ...core import maths
from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE
from ...physics.rigid import articulation as art
from ...physics.rigid import franka
from ...render import mesh_raster
from ...render.depth_camera import SdfScene, render_depth_batch
from ...sensors.gelsight.sensor import GelSightSensor
from ...sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from ..base import DirectRLEnv, DirectRLEnvCfg
from . import contact

IK_RESET_STEPS = 12
# the sensor window (m): the GelSight Mini camera images ~19 x 14 mm
CAM_EXTENT = (0.0189, 0.0142)
# camera orientations: rotate camera +Z onto the hand's -y / +y axis
_QUAT_PZ_TO_NY = (math.cos(math.pi / 4), math.sin(math.pi / 4), 0.0, 0.0)
_QUAT_PZ_TO_PY = (math.cos(-math.pi / 4), math.sin(-math.pi / 4), 0.0, 0.0)


@configclass
class FactoryTaskCfg:
    """Per-task geometry and reward knobs (reference factory_tasks_cfg.py)."""

    name: str = "peg_insert"
    held_diameter: float = 0.008
    held_height: float = 0.050
    fixed_size: tuple = (0.025, 0.025, 0.025)
    hole_diameter: float = 0.0081
    hole_depth: float = 0.025
    fixed_init_pos: tuple = (0.6, 0.0, 0.05)
    fixed_asset_init_pos_noise: tuple = (0.05, 0.05, 0.05)
    held_asset_pos_noise: tuple = (0.0, 0.006, 0.003)
    hand_init_pos: tuple = (0.0, 0.0, 0.047)  # relative to the fixed asset's top
    hand_init_pos_noise: tuple = (0.02, 0.02, 0.01)
    num_keypoints: int = 4
    keypoint_scale: float = 0.15
    keypoint_coef_baseline: tuple = (5.0, 4.0)
    keypoint_coef_coarse: tuple = (50.0, 2.0)
    keypoint_coef_fine: tuple = (100.0, 0.0)
    action_penalty_scale: float = 0.0
    action_grad_penalty_scale: float = 0.0
    engage_threshold: float = 0.9
    success_threshold: float = 0.04
    grip_depth: float = 0.02  # how far below the TCP the grasp line sits
    # nut_thread: the helical thread on the bolt and the nut's samples
    thread_pitch: float = 0.003  # m per turn
    thread_depth: float = 0.0012  # radial depth, crest to root
    thread_clearance: float = 0.0003  # radial nut-to-bolt clearance


def peg_insert_task() -> FactoryTaskCfg:
    return FactoryTaskCfg()


def gear_mesh_task() -> FactoryTaskCfg:
    return FactoryTaskCfg(
        name="gear_mesh", held_diameter=0.03, held_height=0.03, hole_diameter=0.006, hole_depth=0.02,
        success_threshold=0.05, engage_threshold=0.9, grip_depth=0.015,
    )


def nut_thread_task() -> FactoryTaskCfg:
    return FactoryTaskCfg(
        name="nut_thread", held_diameter=0.016, held_height=0.01, hole_diameter=0.008, hole_depth=0.015,
        success_threshold=0.375, engage_threshold=0.9, grip_depth=0.005,
    )


@configclass
class FactoryEnvCfg(DirectRLEnvCfg):
    num_envs: int = 128
    episode_length_s: float = 10.0
    decimation: int = 8
    sim_dt: float = 1.0 / 120.0
    action_space: int = 6
    task: FactoryTaskCfg = None
    ema_factor: float = 0.2
    pos_action_bounds: tuple = (0.05, 0.05, 0.05)
    rot_action_bounds: tuple = (1.0, 1.0, 1.0)
    reset_joints: tuple = (1.5178e-3, -0.19651, -1.4364e-3, -1.9761, -2.7717e-4, 1.7796, 0.78556)
    camera_resolution: tuple = (32, 32)
    vision_obs_shape: tuple = (32, 32, 3)
    obs_noise_std: float = 0.0
    # task-space PD gains (reference factory ctrl default_task_prop_gains)
    task_kp: tuple = (300.0, 300.0, 300.0, 30.0, 30.0, 30.0)
    grip_preload: float = 0.0012  # base gel indentation from the grasp (m)

    def __post_init__(self):
        if self.task is None:
            self.task = peg_insert_task()


@dataclasses.dataclass(frozen=True)
class FactoryState:
    arm: art.GripperArmState
    held: contact.HeldState
    grip_offset: torch.Tensor  # (N, 3) off-centre grasp (held frame vs TCP), kept per episode
    fixed_pos: torch.Tensor  # (N, 3)
    fixed_quat: torch.Tensor  # (N, 4)
    ctrl_target: torch.Tensor  # (N, 3) the persistent absolute task-space target
    ema_target: torch.Tensor  # (N, 6) smoothed action target
    actions: torch.Tensor  # (N, 6)
    prev_actions: torch.Tensor  # (N, 6)
    ep_succeeded: torch.Tensor  # (N,) bool
    episode_length: torch.Tensor  # (N,) int32


def _held_mesh(t: FactoryTaskCfg) -> np.ndarray:
    """Triangle mesh of the held asset (local frame, origin = bottom centre)."""
    if t.name == "peg_insert":
        return meshes.cylinder_mesh(t.held_diameter / 2, t.held_height, segments=24)
    if t.name == "gear_mesh":
        return meshes.gear_mesh(0.75 * t.held_diameter / 2, t.held_diameter / 2, 12, t.held_height, seg_per_tooth=2)
    if t.name == "nut_thread":
        return meshes.nut_mesh(
            t.held_diameter * math.sqrt(3.0) / 2, t.hole_diameter / 2 + 2e-4, t.held_height, segments=18
        )
    raise ValueError(t.name)


class FactoryEnv(DirectRLEnv):
    cfg: FactoryEnvCfg

    def __init__(self, cfg: FactoryEnvCfg | None = None, device=DEFAULT_DEVICE):
        super().__init__(cfg or FactoryEnvCfg(), device=device)
        c = self.cfg
        t = c.task
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        n = c.num_envs
        res = tuple(c.camera_resolution)
        sensor_cfg = gelsight_mini_cfg(with_markers=False, camera_resolution=res, tactile_img_res=res)
        # one batched sensor renders both fingers: its env axis is 2N. The
        # step makes a fresh sensor state every frame (the optical path has no
        # state), so FOTS markers, which track a trajectory, stay off.
        self.sensor = GelSightSensor(sensor_cfg, num_envs=2 * n, device=dev)
        assert sensor_cfg.marker_motion_sim_cfg is None, "markers need the sensor state carried in FactoryState"
        self._q0 = torch.tensor(c.reset_joints, **f32)
        self._ee_off = (0.0, 0.0, art.HAND_TCP_OFFSET)
        self.limits = franka.ArmLimits.on(dev)
        # keypoints along the held asset's axis
        ko = np.zeros((t.num_keypoints, 3), np.float32)
        ko[:, 2] = (np.linspace(0.0, 1.0, t.num_keypoints) - 0.5) * t.keypoint_scale
        self._keypoint_offsets = torch.from_numpy(ko).to(dev)
        self._sdf = contact.make_fixed_sdf(t.name, t, device=dev)
        self._pts = torch.from_numpy(contact.make_held_points(t.name, t)).to(dev)
        self._params = contact.ContactParams()
        self._tris = torch.from_numpy(_held_mesh(t)).to(dev)
        self._kp_task = torch.tensor(c.task_kp, **f32)
        self._kd_task = 2.0 * torch.sqrt(self._kp_task)
        # grip width target: the fingers squeeze the asset by the preload
        self._grip_half = t.held_diameter / 2 - c.grip_preload

        self._grasp_off = torch.tensor([0.0, 0.0, t.held_height - t.grip_depth], **f32)
        self._flip = torch.tensor([0.0, 1.0, 0.0, 0.0], **f32)  # 180 deg about x
        self._fixed_top = torch.tensor([0.0, 0.0, t.fixed_size[2] / 2], **f32)
        self._fixed0 = torch.tensor(t.fixed_init_pos, **f32)
        self._fixed_noise = torch.tensor(t.fixed_asset_init_pos_noise, **f32)
        self._hand_init = torch.tensor(t.hand_init_pos, **f32)
        self._hand_noise = torch.tensor(t.hand_init_pos_noise, **f32)
        self._grip_noise = torch.tensor(t.held_asset_pos_noise, **f32)
        self._down = maths.quat_from_angle_axis(torch.tensor(math.pi, **f32), torch.tensor([1.0, 0.0, 0.0], **f32))
        self._target_lo = torch.tensor([-0.15, -0.15, -0.02], **f32)
        self._target_hi = torch.tensor([0.15, 0.15, 0.30], **f32)
        self._pos_bounds = torch.tensor(c.pos_action_bounds, **f32)
        self._rot_bounds = torch.tensor(c.rot_action_bounds, **f32)
        if t.name == "nut_thread":  # the nut succeeds half-depth down the bolt
            target_off = (0.0, 0.0, 0.5 * t.hole_depth)
        elif t.name == "gear_mesh":  # the gear seats on the plate's top
            target_off = (0.0, 0.0, 0.0)
        else:  # the peg goes all the way down the hole
            target_off = (0.0, 0.0, -t.hole_depth)
        self._hole_target_off = torch.tensor(target_off, **f32)
        self._cam_quats = torch.tensor([_QUAT_PZ_TO_NY, _QUAT_PZ_TO_PY], **f32)
        self._scene = SdfScene(
            spheres=torch.zeros((2 * n, 1, 4), **f32),
            boxes=torch.zeros((2 * n, 1, 10), **f32),
            capsules=torch.zeros((2 * n, 1, 8), **f32),
            planes=torch.zeros((2 * n, 1, 4), **f32),
        )

    # ---------------------------------------------------------------- helpers
    def _tool_pose(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pos, quat, _, _ = franka.forward_kinematics(q[:, :7], ee_offset_pos=self._ee_off)
        return pos, quat

    def _grasp_pose(self, tool_pos, tool_quat, grip_offset=None):
        """Grasp target pose of the held asset's origin (bottom centre): the
        grasp line sits grip_depth above the asset's bottom, moved by an
        off-centre grip. The asset's z points down the tool's z (the tool
        hangs flipped), so its orientation is the tool's composed with a
        180 deg turn about x."""
        off = self._grasp_off if grip_offset is None else self._grasp_off + grip_offset
        pos = tool_pos + maths.quat_apply(tool_quat, off)
        return pos, maths.quat_mul(tool_quat, self._flip.expand(tool_quat.shape))

    def _fixed_target(self, state: FactoryState) -> torch.Tensor:
        """The insertion target on the fixed asset: the top centre of the hole."""
        return state.fixed_pos + maths.quat_apply(state.fixed_quat, self._fixed_top)

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device) * 2.0 - 1.0

    # ------------------------------------------------------------------ state
    def init_state(self) -> FactoryState:
        n = self.cfg.num_envs
        zeros = lambda *s: torch.zeros((n,) + s, device=self.device)
        return FactoryState(
            arm=art.GripperArmState.init(n, self._q0, finger_width=2 * self._grip_half),
            held=contact.HeldState.init(n, device=self.device),
            grip_offset=zeros(3),
            fixed_pos=self._fixed0.expand(n, 3).clone(),
            fixed_quat=maths.quat_identity((n,), device=self.device),
            ctrl_target=zeros(3),
            ema_target=zeros(6),
            actions=zeros(6),
            prev_actions=zeros(6),
            ep_succeeded=torch.zeros((n,), dtype=torch.bool, device=self.device),
            episode_length=torch.zeros((n,), dtype=torch.int32, device=self.device),
        )

    def _reset_where(self, state: FactoryState, mask: torch.Tensor) -> FactoryState:
        """Masked reset: envs where ``mask`` holds restart. The IK solve runs
        on every env and the mask selects."""
        c, t = self.cfg, self.cfg.task
        n = c.num_envs
        m1 = mask[:, None]
        new_fixed = self._fixed0 + self._uniform((n, 3)) * self._fixed_noise
        hand_jitter = self._uniform((n, 3)) * self._hand_noise
        # the arm starts above the new fixed asset: IK_RESET_STEPS DLS steps
        # toward hand_init_pos over its top
        arm_q = torch.where(m1, self._q0.expand(n, 7), state.arm.q[:, :7])
        target = new_fixed + self._fixed_top
        target = target + self._hand_init + hand_jitter + self._grasp_off
        down = self._down.expand(n, 4)
        for _ in range(IK_RESET_STEPS):
            pos, quat, orig, ax = franka.forward_kinematics(arm_q, ee_offset_pos=self._ee_off)
            jac = franka.geometric_jacobian(pos, orig, ax)
            rot_err = maths.axis_angle_from_quat(maths.quat_mul(down, maths.quat_conjugate(quat)))
            arm_q_new = franka.dls_ik_step(arm_q, target - pos, rot_err, jac)
            arm_q = torch.where(m1, torch.clamp(arm_q_new, self.limits.q_lower, self.limits.q_upper), arm_q)
        q9 = torch.cat([arm_q, torch.full((n, 2), self._grip_half, device=self.device)], -1)
        arm = art.GripperArmState(
            q=torch.where(m1, q9, state.arm.q),
            qd=torch.where(m1, 0.0, state.arm.qd),
            q_target=torch.where(m1, q9, state.arm.q_target),
        )
        # the held asset spawns in the grasp, off centre by a sampled offset
        # that lasts the episode (reference held_asset_pos_noise)
        grip_offset = torch.where(m1, self._uniform((n, 3)) * self._grip_noise, state.grip_offset)
        tool_pos, tool_quat = self._tool_pose(arm.q)
        grasp_pos, grasp_quat = self._grasp_pose(tool_pos, tool_quat, grip_offset)
        held = contact.HeldState(
            pos=torch.where(m1, grasp_pos, state.held.pos),
            quat=torch.where(m1, grasp_quat, state.held.quat),
            linvel=torch.where(m1, 0.0, state.held.linvel),
            angvel=torch.where(m1, 0.0, state.held.angvel),
        )
        return FactoryState(
            arm=arm,
            held=held,
            grip_offset=grip_offset,
            fixed_pos=torch.where(m1, new_fixed, state.fixed_pos),
            fixed_quat=torch.where(m1, maths.quat_identity((n,), device=self.device), state.fixed_quat),
            ctrl_target=torch.where(m1, tool_pos, state.ctrl_target),
            ema_target=torch.where(m1, 0.0, state.ema_target),
            actions=torch.where(m1, 0.0, state.actions),
            prev_actions=torch.where(m1, 0.0, state.prev_actions),
            ep_succeeded=torch.where(mask, False, state.ep_succeeded),
            episode_length=torch.where(mask, 0, state.episode_length),
        )

    def reset_all(self, state: FactoryState):
        state = self._reset_where(state, torch.ones((self.cfg.num_envs,), dtype=torch.bool, device=self.device))
        return state, self._observations(state, None)

    # ------------------------------------------------------------------- step
    def _physics_step(self, state: FactoryState, action: torch.Tensor):
        """Action smoothing, then ``decimation`` rounds of arm control and
        held-asset contact."""
        c = self.cfg
        n = c.num_envs
        actions = torch.clamp(torch.nan_to_num(action), -1.0, 1.0)
        ema = c.ema_factor * actions + (1 - c.ema_factor) * state.ema_target
        delta_pos = ema[:, :3] * self._pos_bounds
        delta_rot = ema[:, 3:6] * self._rot_bounds * 0.1

        # the persistent absolute task-space target
        target_pos = state.ctrl_target + delta_pos * 0.25
        target_pos = torch.clamp(target_pos, state.fixed_pos + self._target_lo, state.fixed_pos + self._target_hi)
        angle = torch.linalg.vector_norm(delta_rot, dim=-1)
        axis = delta_rot / torch.linalg.vector_norm(delta_rot, dim=-1, keepdim=True).clamp_min(1e-9)
        target_quat = maths.quat_mul(maths.quat_from_angle_axis(angle, axis), self._down.expand(n, 4))

        arm, held = state.arm, state.held
        grasp_force = grasp_torque = torch.zeros((n, 3), device=self.device)
        diag = None
        for _ in range(c.decimation):
            # the grasp's reaction loads the arm through J^T
            reaction = torch.cat([-grasp_force, -grasp_torque], -1)
            tau_ext = art.ee_wrench_to_tau(arm.q, reaction, ee_offset_pos=self._ee_off)
            arm = art.osc_step(
                arm, target_pos, target_quat, self._kp_task, self._kd_task, c.sim_dt,
                tau_ext=tau_ext, ee_offset_pos=self._ee_off, substeps=2,
            )
            tool_pos, tool_quat = self._tool_pose(arm.q)
            grasp_pos, grasp_quat = self._grasp_pose(tool_pos, tool_quat, state.grip_offset)
            held, diag = contact.held_asset_step(
                held, grasp_pos, grasp_quat, state.fixed_pos, state.fixed_quat,
                self._pts, self._sdf, self._params, c.task.name, c.sim_dt,
            )
            grasp_force, grasp_torque = diag["grasp_force"], diag["grasp_torque"]
        return arm, held, diag, actions, ema, target_pos

    def step(self, state: FactoryState, action: torch.Tensor):
        c, t = self.cfg, self.cfg.task
        n = c.num_envs
        prev_actions = state.actions
        arm, held, diag, actions, ema, target_pos = self._physics_step(state, action)

        # tactile: the held asset rendered from each finger, one sensor update
        depth_two = self._finger_depths(arm, held)  # (2N, h, w): [left N | right N]
        _, sensor_out = self.sensor.update(self.sensor.init_state(), depth_two)
        tac = sensor_out["tactile_rgb"]
        tactile = torch.stack([tac[:n], tac[n:]], dim=1)  # (N, 2, h, w, 3)

        state = FactoryState(
            arm=arm, held=held, grip_offset=state.grip_offset, fixed_pos=state.fixed_pos,
            fixed_quat=state.fixed_quat, ctrl_target=target_pos, ema_target=ema, actions=actions,
            prev_actions=prev_actions, ep_succeeded=state.ep_succeeded,
            episode_length=state.episode_length + 1,
        )

        # keypoints and success
        held_tip = held.pos  # the held asset's bottom (its origin)
        hole_top = self._fixed_target(state)
        xy_dist = torch.linalg.vector_norm(held_tip[:, :2] - hole_top[:, :2], dim=-1)
        kp_held = held_tip[:, None, :] + self._keypoint_offsets[None]
        hole_target = hole_top + self._hole_target_off
        kp_fixed = hole_target[:, None, :] + self._keypoint_offsets[None]
        keypoint_dist = torch.linalg.vector_norm(kp_held - kp_fixed, dim=-1).mean(-1)

        z_disp = held_tip[:, 2] - hole_target[:, 2]
        is_centered = xy_dist < 0.0025
        success = is_centered & (z_disp < t.hole_depth * t.success_threshold)
        engaged = is_centered & (z_disp < t.hole_depth * t.engage_threshold)

        def squash(x, a, b):
            return 1.0 / (torch.exp(a * x) + b + torch.exp(-a * x))

        rew = (
            squash(keypoint_dist, *t.keypoint_coef_baseline)
            + squash(keypoint_dist, *t.keypoint_coef_coarse)
            + squash(keypoint_dist, *t.keypoint_coef_fine)
            + engaged.to(torch.float32)
            + success.to(torch.float32)
            - t.action_penalty_scale * torch.linalg.vector_norm(actions, dim=-1)
            - t.action_grad_penalty_scale * torch.linalg.vector_norm(actions - prev_actions, dim=-1)
        )

        state = dataclasses.replace(state, ep_succeeded=state.ep_succeeded | success)
        terminated = torch.zeros((n,), dtype=torch.bool, device=self.device)
        truncated = state.episode_length >= c.max_episode_length - 1
        info = {
            "log": {
                "keypoint_dist": keypoint_dist.mean(),
                "successes": success.to(torch.float32).mean(),
                "engaged": engaged.to(torch.float32).mean(),
                "contact_force_z": diag["contact_force"][:, 2].mean(),
                "max_penetration": diag["max_penetration"].amax(),
            },
            "tactile_rgb_fingers": tactile,
        }
        state = self._reset_where(state, terminated | truncated)
        return state, self._observations(state, tactile), rew, terminated, truncated, info

    # ----------------------------------------------------------------- vision
    def _finger_depths(self, arm: art.GripperArmState, held: contact.HeldState) -> torch.Tensor:
        """Both fingers' depth maps rendered from the held asset's mesh,
        (2N, h, w) in meters, [left N | right N]. Each finger camera sits
        behind its gel pad and looks inward along the hand's -y (left) or +y
        (right) axis."""
        sc = self.sensor.cfg.sensor_camera_cfg
        far = sc.clipping_range[1]
        gel_top = sc.clipping_range[0] + 0.0045
        n = self.cfg.num_envs

        _, tcp, hand_rot = art.finger_positions(arm.q)
        hand_quat = maths.quat_from_matrix(hand_rot)
        rot_left = maths.quat_mul(hand_quat, self._cam_quats[0].expand(n, 4))
        rot_right = maths.quat_mul(hand_quat, self._cam_quats[1].expand(n, 4))
        y_axis = hand_rot[..., :, 1]
        pad_l = tcp + arm.q[:, 7:8] * y_axis
        pad_r = tcp - arm.q[:, 8:9] * y_axis
        cam_l = pad_l - gel_top * (-y_axis)  # the camera sits gel_top behind the pad
        cam_r = pad_r - gel_top * (+y_axis)

        tris_w = mesh_raster.transform_tris(held.pos, held.quat, self._tris)  # (N, T, 3, 3)
        scene = dataclasses.replace(self._scene, triangles=torch.cat([tris_w, tris_w]))
        return render_depth_batch(
            torch.cat([cam_l, cam_r]), torch.cat([rot_left, rot_right]), scene,
            tuple(self.cfg.camera_resolution), CAM_EXTENT, far,
        )

    # -------------------------------------------------------------------- obs
    def _observations(self, state: FactoryState, tactile) -> dict:
        c = self.cfg
        n = c.num_envs
        tool_pos, tool_quat = self._tool_pose(state.arm.q)
        hole_top = self._fixed_target(state)
        # the tool's velocity from the joint rates through the Jacobian
        _, _, orig, ax = franka.forward_kinematics(state.arm.q[:, :7], ee_offset_pos=self._ee_off)
        jac = franka.geometric_jacobian(tool_pos, orig, ax)
        ee_vel = (jac @ state.arm.qd[:, :7, None])[..., 0]
        proprio = torch.cat([tool_pos - hole_top, tool_quat, ee_vel[:, :3], ee_vel[:, 3:6], state.prev_actions], -1)
        if tactile is None:
            vision = torch.zeros((n,) + tuple(c.vision_obs_shape[:2]) + (6,), device=self.device)
        else:
            # both finger images, stacked along channels: (N, 32, 32, 6)
            vision = torch.cat([tactile[:, 0], tactile[:, 1]], dim=-1)
        return {"proprio_obs": proprio, "vision_obs": vision}
