"""Pole balancing on the tactile sensor (PyTorch).

Port of ``tacex_tpu/envs/pole_balancing/env.py``: the Franka holds the
GelSight face-up, a pole stands on the gel pad and must stay balanced while
the end effector tracks a target height. Observations are proprio plus the
sensor camera's depth image (32x32x1); the sensor runs without its optical
path (``data_types = ["height_map", "camera_depth"]``), so no kernel runs.

The pole is a uniform rod with full 6-DoF dynamics; its lower tip meets the
moving gel pad as a sphere-vs-box impulse with friction, applied at the tip
so that the reaction torque tips the rod. ``step`` never reads a value back
to the host; random draws come from the env's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core import maths
from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE
from ...ops.resize import resize_linear
from ...physics.rigid import contact, franka
from ...render.depth_camera import SdfScene, render_depth_batch
from ...sensors.gelsight.sensor import GelSightSensor
from ...sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from ..ball_rolling.env import CAM_EXTENT, GELPAD_HALF
from ..base import DirectRLEnv, DirectRLEnvCfg


@configclass
class PoleBalancingEnvCfg(DirectRLEnvCfg):
    num_envs: int = 1024
    episode_length_s: float = 8.3333 / 2
    decimation: int = 1
    sim_dt: float = 1.0 / 120.0
    physics_substeps: int = 2
    action_space: int = 6
    action_scale: float = 0.05
    action_noise: float = 0.001
    obs_noise_std: float = 0.002

    # pole (reference Props/pole.usd: a slender rod standing on the gel)
    pole_length: float = 0.2
    pole_radius: float = 0.005
    pole_mass: float = 0.02
    default_joint_pos: tuple = (1.5, -1.76, -1.84, -2.52, 1.25, 1.58, -1.72)
    ee_offset: tuple = (0.0, 0.0, 0.131)

    x_bounds: tuple = (0.0, 0.9)
    y_bounds: tuple = (-0.5, 0.5)
    too_far_away_threshold: float = 0.3
    min_height_threshold: float = 0.05

    camera_resolution: tuple = (32, 32)
    vision_obs_shape: tuple = (32, 32, 1)
    sensor_clipping: tuple = (0.015, 0.029)

    reward_terms: dict = dataclasses.field(
        default_factory=lambda: {
            "at_obj_reward": {"weight": 0.75, "minimal_distance": 0.005},
            "height_reward": {"weight": 0.25, "w": 10.0, "v": 0.3, "alpha": 0.00067, "target_height_cm": 50},
            "orient_reward": {"weight": 0.25},
            "ee_goal_fine_tracking_reward": {"weight": 0.75, "std": 0.0380},
            "staying_alive_rew": {"weight": 1.0},
            "termination_penalty": {"weight": -5.0},
            "action_rate_penalty": {"weight": -1e-4},
            "joint_vel_penalty": {"weight": -1e-4},
        }
    )


@dataclasses.dataclass(frozen=True)
class PoleBalancingState:
    arm: franka.ArmState
    pole_pos: torch.Tensor  # (N, 3) the rod's centre of mass
    pole_quat: torch.Tensor  # (N, 4)
    pole_lin: torch.Tensor  # (N, 3)
    pole_ang: torch.Tensor  # (N, 3)
    actions: torch.Tensor  # (N, 6)
    prev_actions: torch.Tensor  # (N, 6)
    episode_length: torch.Tensor  # (N,) int32


class PoleBalancingEnv(DirectRLEnv):
    cfg: PoleBalancingEnvCfg

    def __init__(self, cfg: PoleBalancingEnvCfg | None = None, device=DEFAULT_DEVICE):
        super().__init__(cfg or PoleBalancingEnvCfg(), device=device)
        c = self.cfg
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        n = c.num_envs
        res = tuple(c.camera_resolution)
        sensor_cfg = gelsight_mini_cfg(with_markers=False, camera_resolution=res, tactile_img_res=res)
        sensor_cfg.sensor_camera_cfg.clipping_range = tuple(c.sensor_clipping)
        sensor_cfg.data_types = ["height_map", "camera_depth"]
        self.sensor = GelSightSensor(sensor_cfg, num_envs=n, device=dev)
        self.limits = franka.ArmLimits.on(dev)
        self._q0 = torch.tensor(c.default_joint_pos, **f32)
        self.tip_params = contact.SphereParams(radius=c.pole_radius, mass=c.pole_mass, friction=1.0)
        # uniform rod inertia about its centre, body z = the rod's axis
        m, length, r = c.pole_mass, c.pole_length, c.pole_radius
        i_perp = m * (length**2) / 12.0 + 0.25 * m * r * r
        i_axial = 0.5 * m * r * r
        self._inv_inertia_body = torch.tensor([1 / i_perp, 1 / i_perp, 1 / i_axial], **f32)
        self._z_axis = torch.tensor([0.0, 0.0, 1.0], **f32)
        self._gravity = torch.tensor([0.0, 0.0, -9.81], **f32)
        self._gelpad_half = torch.tensor(GELPAD_HALF, **f32)
        self._boxes = torch.zeros((n, 1, 10), **f32)
        self._planes = torch.zeros((n, 1, 4), **f32)

    # ---------------------------------------------------------------- helpers
    def _tool_pose(self, q: torch.Tensor):
        pos, quat, _, _ = franka.forward_kinematics(q, ee_offset_pos=self.cfg.ee_offset)
        return pos, quat

    def _tip_pos(self, pole_pos, pole_quat):
        axis = maths.quat_apply(pole_quat, self._z_axis)
        return pole_pos - (self.cfg.pole_length / 2) * axis, axis

    # ------------------------------------------------------------------ state
    def init_state(self) -> PoleBalancingState:
        n = self.cfg.num_envs
        tool_pos, _ = self._tool_pose(self._q0.expand(n, 7))
        # the pole stands upright on the face-up sensor (world up = tool +z)
        # (a fill: an indexed write of a Python number would copy it from the host)
        lift = torch.full_like(tool_pos[:, :1], self.cfg.pole_length / 2 + 1e-4)
        lift = torch.cat([torch.zeros_like(tool_pos[:, :2]), lift], -1)
        zeros = lambda *s: torch.zeros((n,) + s, device=self.device)
        return PoleBalancingState(
            arm=franka.ArmState.init(n, self._q0),
            pole_pos=tool_pos + lift,
            pole_quat=maths.quat_identity((n,), device=self.device),
            pole_lin=zeros(3),
            pole_ang=zeros(3),
            actions=zeros(self.cfg.action_space),
            prev_actions=zeros(self.cfg.action_space),
            episode_length=torch.zeros((n,), dtype=torch.int32, device=self.device),
        )

    def _reset_where(self, state: PoleBalancingState, mask: torch.Tensor) -> PoleBalancingState:
        fresh = self.init_state()
        m1 = mask[:, None]
        return PoleBalancingState(
            arm=franka.ArmState(
                q=torch.where(m1, fresh.arm.q, state.arm.q),
                qd=torch.where(m1, 0.0, state.arm.qd),
                q_target=torch.where(m1, fresh.arm.q_target, state.arm.q_target),
            ),
            pole_pos=torch.where(m1, fresh.pole_pos, state.pole_pos),
            pole_quat=torch.where(m1, fresh.pole_quat, state.pole_quat),
            pole_lin=torch.where(m1, 0.0, state.pole_lin),
            pole_ang=torch.where(m1, 0.0, state.pole_ang),
            actions=torch.where(m1, 0.0, state.actions),
            prev_actions=torch.where(m1, 0.0, state.prev_actions),
            episode_length=torch.where(mask, 0, state.episode_length),
        )

    def reset_all(self, state: PoleBalancingState):
        state = self._reset_where(state, torch.ones((self.cfg.num_envs,), dtype=torch.bool, device=self.device))
        return state, self._observations(state, None)

    # ------------------------------------------------------------------- step
    def step(self, state: PoleBalancingState, action: torch.Tensor):
        c = self.cfg
        n = c.num_envs

        prev_actions = state.actions
        actions = torch.clamp(torch.nan_to_num(action), -1.0, 1.0)
        noise = torch.rand(actions.shape, generator=self.generator, device=self.device)
        actions = actions + (noise * (2 * c.action_noise) - c.action_noise)
        processed = actions * c.action_scale
        arm = franka.apply_delta_pose_ik(
            state.arm, processed[:, :3], processed[:, 3:6], self.limits, ee_offset_pos=c.ee_offset
        )

        pos, quat = state.pole_pos, state.pole_quat
        lin, ang = state.pole_lin, state.pole_ang
        sub_dt = c.sim_dt / c.physics_substeps
        half = self._gelpad_half
        tool_pos, _ = self._tool_pose(arm.q)
        for _ in range(c.physics_substeps):
            tool_prev = tool_pos
            arm = franka.servo_step(arm, sub_dt, self.limits)
            tool_pos, tool_quat = self._tool_pose(arm.q)
            # the gel pad box, half a thickness behind the contact face (tool
            # +z points up out of the face-up sensor)
            pad_pos = tool_pos - half[2] * maths.quat_apply(tool_quat, self._z_axis)
            pad_vel = (tool_pos - tool_prev) / sub_dt

            lin = lin + self._gravity * sub_dt
            tip, _ = self._tip_pos(pos, quat)
            # the contact impulse at the tip (sphere vs box), through the rod's
            # dynamics: dv = J / m, dw = I^-1 (r x J)
            dl, _ = contact.sphere_box_contact(
                tip, lin + maths.cross(ang, tip - pos), torch.zeros_like(ang),
                pad_pos, tool_quat, pad_vel, half, self.tip_params, sub_dt, stiffness_scale=0.5,
            )
            imp = dl * self.tip_params.mass
            lin = lin + imp / c.pole_mass
            ang_imp = maths.cross(tip - pos, imp)
            rot = maths.matrix_from_quat(quat)
            inv_i_world = torch.einsum("nij,j,nkj->nik", rot, self._inv_inertia_body, rot)
            ang = ang + (inv_i_world @ ang_imp[..., None])[..., 0]

            pos = pos + lin * sub_dt
            wq = torch.cat([torch.zeros_like(ang[..., :1]), ang], -1)
            quat = maths.quat_normalize(quat + 0.5 * sub_dt * maths.quat_mul(wq, quat))

        # the sensor frame: the camera looks along tool +z, up at the pole
        tool_pos, tool_quat = self._tool_pose(arm.q)
        ocfg = self.sensor.cfg.optical_sim_cfg
        dist = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
        cam_pos = tool_pos - dist * maths.quat_apply(tool_quat, self._z_axis)
        tip, _ = self._tip_pos(pos, quat)
        radius = torch.full((n, 1), c.pole_radius, device=self.device)
        scene = SdfScene(
            spheres=torch.cat([tip, radius], -1)[:, None, :],
            boxes=self._boxes,
            capsules=torch.cat([tip, pos + (pos - tip), radius, torch.ones_like(radius)], -1)[:, None, :],
            planes=self._planes,
        )
        depth = render_depth_batch(
            cam_pos, tool_quat, scene, tuple(c.camera_resolution), CAM_EXTENT, far=c.sensor_clipping[1]
        )
        _, sensor_out = self.sensor.update(self.sensor.init_state(), depth)

        state = PoleBalancingState(
            arm=arm, pole_pos=pos, pole_quat=quat, pole_lin=lin, pole_ang=ang, actions=actions,
            prev_actions=prev_actions, episode_length=state.episode_length + 1,
        )

        # dones
        oob = (
            (pos[:, 0] < c.x_bounds[0]) | (pos[:, 0] > c.x_bounds[1])
            | (pos[:, 1] < c.y_bounds[0]) | (pos[:, 1] > c.y_bounds[1])
        )
        roll, pitch, _ = maths.euler_xyz_from_quat(quat)
        tipped = (roll.abs() > math.pi / 4) | (pitch.abs() > math.pi / 4)
        obj_ee_dist = torch.linalg.vector_norm(pos - tool_pos, dim=-1)
        ee_far = obj_ee_dist > c.too_far_away_threshold
        too_low = (tool_pos[:, 2] < c.min_height_threshold) | (pos[:, 2] < c.min_height_threshold)
        terminated = oob | tipped | ee_far | too_low
        truncated = state.episode_length >= c.max_episode_length - 1

        # rewards
        r = c.reward_terms
        at_obj = torch.where(
            obj_ee_dist <= r["at_obj_reward"]["minimal_distance"] + c.pole_length / 2, r["at_obj_reward"]["weight"], 0.0
        )
        hr = r["height_reward"]
        hd = (hr["target_height_cm"] - tool_pos[:, 2] * 100.0) * 0.1
        height = -torch.clamp(hr["w"] * hd**2 + hr["v"] * torch.log(hd**2 + hr["alpha"]), -1.0, 1.0)
        height = torch.where(tool_pos[:, 2] <= c.min_height_threshold, height - 10.0, height) * hr["weight"]
        orient = torch.where(
            (roll.abs() < math.pi / 8) | (pitch.abs() < math.pi / 8), r["orient_reward"]["weight"], 0.0
        )
        goal = torch.stack(
            [tool_pos[:, 0], tool_pos[:, 1], torch.full_like(tool_pos[:, 0], hr["target_height_cm"] / 100.0)], -1
        )
        ee_goal_dist = torch.linalg.vector_norm(tool_pos - goal, dim=-1)
        fine = 1.0 - torch.tanh(ee_goal_dist / r["ee_goal_fine_tracking_reward"]["std"]) ** 2
        fine = fine * r["ee_goal_fine_tracking_reward"]["weight"]
        term_f = terminated.to(torch.float32)
        alive = r["staying_alive_rew"]["weight"] * (1.0 - term_f)
        term_pen = r["termination_penalty"]["weight"] * term_f
        act_rate = r["action_rate_penalty"]["weight"] * (actions - prev_actions).square().sum(-1)
        joint_vel = r["joint_vel_penalty"]["weight"] * arm.qd.square().sum(-1)
        reward = at_obj + height + orient + fine + alive + term_pen + act_rate + joint_vel

        state = self._reset_where(state, terminated | truncated)
        obs = self._observations(state, sensor_out, noise=True)
        return state, obs, reward, terminated, truncated, {"log": {"full_reward": reward.mean()}}

    # -------------------------------------------------------------------- obs
    def _observations(self, state: PoleBalancingState, sensor_out, noise: bool = False) -> dict:
        c = self.cfg
        n = c.num_envs
        tool_pos, tool_quat = self._tool_pose(state.arm.q)
        roll, pitch, yaw = maths.euler_xyz_from_quat(tool_quat)
        proprio = torch.cat(
            [tool_pos, roll[:, None], pitch[:, None], yaw[:, None], state.pole_pos[:, :2], state.actions], -1
        )
        if noise:
            proprio = proprio + c.obs_noise_std * torch.randn(proprio.shape, generator=self.generator, device=self.device)
        vh, vw, _ = c.vision_obs_shape
        if sensor_out is None:
            return {"proprio_obs": proprio, "vision_obs": torch.zeros((n, vh, vw, 1), device=self.device)}
        d = sensor_out["camera_depth"]
        if tuple(d.shape[1:3]) != (vh, vw):
            d = resize_linear(d, (n, vh, vw, 1))
        return {"proprio_obs": proprio, "vision_obs": d}
