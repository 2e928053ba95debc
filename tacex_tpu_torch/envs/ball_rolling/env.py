"""Ball-rolling tactile task: roll a ball to a goal with a GelSight fingertip.

Port of ``tacex_tpu/envs/ball_rolling/env.py`` for the flagship
``TacEx-Ball-Rolling-Taxim-Fots-v0`` (tactile RGB x marker-dot vision obs,
default-joint resets; the other obs modes and reset variants are not ported
yet): a Franka with a GelSight Mini on the flange presses a 5 mm ball on
a plate and rolls it to a randomized goal. One ``step`` runs, for the whole
env batch on one device: relative-pose DLS IK, servo + sphere-box and
sphere-plane contact substeps, the analytic depth render, the Taxim + FOTS
tactile frame, dones, rewards, the curriculum, masked resets and the
observations.

``step`` never reads a value back to the host: no ``.item()``, no branch on
a tensor, no boolean-mask indexing; choices are ``torch.where``. Random draws
come from the env's ``torch.Generator`` on its device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core import maths
from ...core.config import configclass
from ...physics.rigid import contact, franka
from ...render.depth_camera import SdfScene, render_depth_batch
from ...sensors.gelsight.fots import marker_motion as fots
from ...sensors.gelsight.sensor import GelSightSensor, GelSightSensorState
from ...sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from ..base import DirectRLEnv, DirectRLEnvCfg

GELPAD_HALF = (0.020750 / 2, 0.025250 / 2, 0.004500 / 2)
# camera window matched to the Taxim calibration pixel pitch (0.0295 mm/px at
# 640x480 -> 18.88 x 14.16 mm)
CAM_EXTENT = (0.0295 * 640 / 1000.0, 0.0295 * 480 / 1000.0)


@configclass
class BallRollingEnvCfg(DirectRLEnvCfg):
    num_envs: int = 1024
    episode_length_s: float = 8.3333 * 2
    decimation: int = 1
    sim_dt: float = 1.0 / 60.0
    physics_substeps: int = 4
    action_space: int = 6
    action_scale: float = 0.05
    action_noise: float = 0.001
    obs_noise_std: float = 0.002

    # scene (reference cfg values)
    ball_radius: float = 0.005
    ball_mass: float = 0.01
    ball_friction: float = 0.8
    plate_top_z: float = 0.0026
    ball_default_pos: tuple = (0.25, -0.35, 0.0051 + 0.0025)
    default_joint_pos: tuple = (-1.02, 0.3175, 0.06, -2.60, 0.0, 2.91, -0.12)
    ee_offset: tuple = (0.0, 0.0, 0.131)
    gel_compliance: float = 0.35  # softened Baumgarte for the compliant gel contact

    # bounds / termination
    x_bounds: tuple = (0.2, 0.8)
    y_bounds: tuple = (-0.4, 0.4)
    too_far_away_threshold: float = 0.015
    min_height_threshold: float = 0.002

    goal_randomization_range_x: tuple = (0.0, 0.5)
    goal_randomization_range_y: tuple = (0.0, 0.7)

    # sensor
    camera_resolution: tuple = (32, 24)
    vision_obs_shape: tuple = (24, 32, 3)  # (h, w, c)
    with_markers: bool = True
    sensor_clipping: tuple = (0.015, 0.029)

    # rewards (reference reward_cfg, ball_rolling_taxim_fots.py:357-382)
    reward_cfg: dict = dataclasses.field(
        default_factory=lambda: {
            "at_obj_reward": {"weight": 0.25, "min_depth": 0.5, "max_depth": 4.0},
            "centering_error": {"weight": -0.05},
            "off_the_ground_penalty": {"weight": -15.0, "max_height": 0.025},
            "height_reward": {"weight": 0.15, "std": 0.4901, "target_height_cm": 1.225},
            "orient_reward": {"weight": -1.25},
            "ee_goal_tracking": {"weight": 0.75, "std": 0.2},
            "obj_goal_tracking": {"weight": 0.75, "std": 0.6},
            "obj_goal_fine_tracking": {"weight": 1.25, "std": 0.2},
            "obj_goal_super_fine_tracking": {"weight": 1.75, "std": 0.08},
            "success_reward": {"weight": 5.0, "threshold": 0.005},
            "action_rate_penalty": {"weight": -1e-4},
            "joint_vel_penalty": {"weight": -1e-4},
        }
    )
    curriculum_cfg: dict = dataclasses.field(
        default_factory=lambda: {
            "goal_randomization_range": {"min": 0.0, "max": 0.0, "num_levels": 10, "threshold": 550.0},
            "action_rate_penalty": {"min": 0.0, "max": 1e-5, "num_levels": 30, "threshold": 5500.0},
            "joint_vel_penalty": {"min": 0.0, "max": 1e-5, "num_levels": 30, "threshold": 5500.0},
        }
    )

    # domain-randomization events, resampled per env at reset (reference
    # EventCfg, ball_rolling_taxim_fots.py:84-165). Pair friction is the mean
    # of the two bodies' sampled frictions (PhysX "average").
    events_cfg: dict = dataclasses.field(
        default_factory=lambda: {
            "enabled": True,
            "ball_friction_range": (0.25, 1.0),
            "ball_restitution_range": (0.0, 0.5),
            "ball_mass_add_range": (-0.005, 0.005),
            "plate_friction_range": (0.1, 1.0),
            "pad_friction_range": (0.5, 1.0),
            "gravity_z_std": 0.4,
        }
    )


@dataclasses.dataclass(frozen=True)
class DomainRandomization:
    """Per-env physics parameters, resampled at reset."""

    ball_friction: torch.Tensor  # (N,)
    ball_restitution: torch.Tensor  # (N,)
    ball_mass: torch.Tensor  # (N,)
    plate_friction: torch.Tensor  # (N,)
    pad_friction: torch.Tensor  # (N,)
    gravity_z: torch.Tensor  # (N,)


@dataclasses.dataclass(frozen=True)
class BallRollingState:
    arm: franka.ArmState
    ball_pos: torch.Tensor  # (N, 3)
    ball_quat: torch.Tensor  # (N, 4)
    ball_lin: torch.Tensor  # (N, 3)
    ball_ang: torch.Tensor  # (N, 3)
    sensor: GelSightSensorState
    goal_pos: torch.Tensor  # (N, 2)
    actions: torch.Tensor  # (N, 6)
    prev_actions: torch.Tensor  # (N, 6)
    episode_length: torch.Tensor  # (N,) int32
    total_episode_rew: torch.Tensor  # (N,)
    curriculum: torch.Tensor  # (3,) int32
    dr: DomainRandomization


class BallRollingEnv(DirectRLEnv):
    cfg: BallRollingEnvCfg

    def __init__(self, cfg: BallRollingEnvCfg | None = None, device="cpu"):
        super().__init__(cfg or BallRollingEnvCfg(), device=device)
        c = self.cfg
        dev = self.device
        res = tuple(c.camera_resolution)
        sensor_cfg = gelsight_mini_cfg(with_markers=c.with_markers, camera_resolution=res, tactile_img_res=res)
        sensor_cfg.sensor_camera_cfg.clipping_range = tuple(c.sensor_clipping)
        self.sensor = GelSightSensor(sensor_cfg, num_envs=c.num_envs, device=dev)
        self.limits = franka.ArmLimits.on(dev)

        n = c.num_envs
        f32 = dict(dtype=torch.float32, device=dev)
        self._q0 = torch.tensor(c.default_joint_pos, **f32)
        self._ball0 = torch.tensor(c.ball_default_pos, **f32)
        self._z_axis = torch.tensor([0.0, 0.0, 1.0], **f32)
        self._gelpad_half = torch.tensor(GELPAD_HALF, **f32)
        self._boxes = torch.zeros((n, 1, 10), **f32)
        self._capsules = torch.zeros((n, 1, 8), **f32)
        self._planes = torch.tensor([0.0, 0.0, 1.0, c.plate_top_z], **f32).expand(n, 1, 4)

        def levels(name):
            cc = c.curriculum_cfg[name]
            return torch.linspace(cc["min"], cc["max"], cc["num_levels"], **f32)

        self._goal_rand_levels = levels("goal_randomization_range")
        self._act_rate_levels = levels("action_rate_penalty")
        self._joint_vel_levels = levels("joint_vel_penalty")

    # ------------------------------------------------------------------ tools
    def _tool_pose(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pos, quat, _, _ = franka.forward_kinematics(q, ee_offset_pos=self.cfg.ee_offset)
        return pos, quat

    def _gelpad_pose(self, tool_pos, tool_quat):
        """Gelpad box center: half a gel thickness behind the gel top plane."""
        z_axis = maths.quat_apply(tool_quat, self._z_axis)
        return tool_pos - GELPAD_HALF[2] * z_axis, tool_quat

    def _camera_pose(self, tool_pos, tool_quat):
        """Sensor camera: 0.0285 m behind the gel top, looking along tool +z."""
        ocfg = self.sensor.cfg.optical_sim_cfg
        dist = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
        z_axis = maths.quat_apply(tool_quat, self._z_axis)
        return tool_pos - dist * z_axis, tool_quat

    def _uniform(self, shape, low, high) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (high - low) + low

    # ------------------------------------------------------------------ state
    def _default_dr(self, n: int) -> DomainRandomization:
        c = self.cfg
        full = lambda v: torch.full((n,), v, dtype=torch.float32, device=self.device)
        return DomainRandomization(
            ball_friction=full(c.ball_friction),
            ball_restitution=full(0.0),
            ball_mass=full(c.ball_mass),
            plate_friction=full(c.ball_friction),
            pad_friction=full(c.ball_friction),
            gravity_z=full(-9.81),
        )

    def _sample_dr(self, n: int) -> DomainRandomization:
        """Per-env event sampling (reference EventCfg 'reset'-mode terms)."""
        c = self.cfg
        e = c.events_cfg
        if not e.get("enabled", False):
            return self._default_dr(n)
        u = lambda rng: self._uniform((n,), rng[0], rng[1])
        ball_friction = u(e["ball_friction_range"])
        ball_restitution = u(e["ball_restitution_range"])
        ball_mass = torch.clamp(c.ball_mass + u(e["ball_mass_add_range"]), min=0.2 * c.ball_mass)
        plate_friction = u(e["plate_friction_range"])
        pad_friction = u(e["pad_friction_range"])
        gravity = -9.81 + e["gravity_z_std"] * torch.randn((n,), generator=self.generator, device=self.device)
        return DomainRandomization(ball_friction, ball_restitution, ball_mass, plate_friction, pad_friction, gravity)

    def init_state(self) -> BallRollingState:
        n = self.cfg.num_envs
        zeros = lambda *s: torch.zeros((n,) + s, device=self.device)
        return BallRollingState(
            arm=franka.ArmState.init(n, self._q0),
            ball_pos=self._ball0.expand(n, 3).clone(),
            ball_quat=maths.quat_identity((n,), device=self.device),
            ball_lin=zeros(3),
            ball_ang=zeros(3),
            sensor=self.sensor.init_state(),
            goal_pos=self._ball0[:2].expand(n, 2).clone(),
            actions=zeros(self.cfg.action_space),
            prev_actions=zeros(self.cfg.action_space),
            episode_length=torch.zeros((n,), dtype=torch.int32, device=self.device),
            total_episode_rew=zeros(),
            curriculum=torch.zeros((3,), dtype=torch.int32, device=self.device),
            dr=self._default_dr(n),
        )

    def _reset_where(self, state: BallRollingState, mask: torch.Tensor) -> BallRollingState:
        """Masked vectorized reset: envs where ``mask`` holds restart."""
        c = self.cfg
        n = c.num_envs
        m1 = mask[:, None]

        new_dr = self._sample_dr(n)
        dr = DomainRandomization(
            **{
                f.name: torch.where(mask, getattr(new_dr, f.name), getattr(state.dr, f.name))
                for f in dataclasses.fields(DomainRandomization)
            }
        )

        ball_noise = self._uniform((n, 2), -0.00025, 0.00025)
        new_ball = torch.cat([self._ball0[:2] + ball_noise, self._ball0[2:].expand(n, 1)], -1)

        goal_curr = torch.index_select(self._goal_rand_levels, 0, state.curriculum[0:1])  # (1,)
        gx = self._uniform(
            (n,), c.goal_randomization_range_x[0] - goal_curr, c.goal_randomization_range_x[1] + goal_curr
        )
        gy = self._uniform(
            (n,), c.goal_randomization_range_y[0] - goal_curr, c.goal_randomization_range_y[1] + goal_curr
        )
        new_goal = torch.stack([self._ball0[0] + gx, self._ball0[1] + gy], -1)

        q0 = self._q0.expand(n, 7)
        arm = franka.ArmState(
            q=torch.where(m1, q0, state.arm.q),
            qd=torch.where(m1, 0.0, state.arm.qd),
            q_target=torch.where(m1, q0, state.arm.q_target),
        )
        return BallRollingState(
            arm=arm,
            ball_pos=torch.where(m1, new_ball, state.ball_pos),
            ball_quat=torch.where(m1, maths.quat_identity((n,), device=self.device), state.ball_quat),
            ball_lin=torch.where(m1, 0.0, state.ball_lin),
            ball_ang=torch.where(m1, 0.0, state.ball_ang),
            sensor=self.sensor.reset(state.sensor, mask),
            goal_pos=torch.where(m1, new_goal, state.goal_pos),
            actions=torch.where(m1, 0.0, state.actions),
            prev_actions=torch.where(m1, 0.0, state.prev_actions),
            episode_length=torch.where(mask, 0, state.episode_length),
            total_episode_rew=torch.where(mask, 0.0, state.total_episode_rew),
            curriculum=state.curriculum,
            dr=dr,
        )

    def reset_all(self, state: BallRollingState):
        state = self._reset_where(state, torch.ones((self.cfg.num_envs,), dtype=torch.bool, device=self.device))
        return state, self._observations(state, sensor_out=None, noise=False)

    # ------------------------------------------------------------------- step
    def _physics_step(self, state: BallRollingState, action: torch.Tensor):
        """IK + servo + contact substeps (everything before the tactile frame)."""
        c = self.cfg

        prev_actions = state.actions
        # NaN guard: a diverged policy must not poison the sim state
        actions = torch.clamp(torch.nan_to_num(action), -1.0, 1.0)
        actions = actions + self._uniform(actions.shape, -c.action_noise, c.action_noise)
        processed = actions * c.action_scale

        arm = franka.apply_delta_pose_ik(
            state.arm, processed[:, :3], processed[:, 3:6], self.limits, ee_offset_pos=c.ee_offset
        )

        ball_pos, ball_quat = state.ball_pos, state.ball_quat
        ball_lin, ball_ang = state.ball_lin, state.ball_ang

        dr = state.dr
        pad_params = contact.SphereParams(
            radius=c.ball_radius, mass=dr.ball_mass, restitution=dr.ball_restitution,
            friction=0.5 * (dr.ball_friction + dr.pad_friction),
        )
        plate_params = dataclasses.replace(pad_params, friction=0.5 * (dr.ball_friction + dr.plate_friction))
        zero = torch.zeros_like(dr.gravity_z)
        gravity = torch.stack([zero, zero, dr.gravity_z], -1)

        sub_dt = c.sim_dt / c.physics_substeps
        tool_pos, _ = self._tool_pose(arm.q)
        for _ in range(c.decimation):
            for _ in range(c.physics_substeps):
                tool_prev = tool_pos
                arm = franka.servo_step(arm, sub_dt, self.limits)
                tool_pos, tool_quat = self._tool_pose(arm.q)
                pad_pos, pad_quat = self._gelpad_pose(tool_pos, tool_quat)
                pad_vel = (tool_pos - tool_prev) / sub_dt

                ball_lin = ball_lin + gravity * sub_dt
                dl, da = contact.sphere_box_contact(
                    ball_pos, ball_lin, ball_ang, pad_pos, pad_quat, pad_vel,
                    self._gelpad_half, pad_params, sub_dt, stiffness_scale=c.gel_compliance,
                )
                ball_lin, ball_ang = ball_lin + dl, ball_ang + da
                dl, da = contact.sphere_plane_contact(
                    ball_pos, ball_lin, ball_ang, (0.0, 0.0, 1.0), c.plate_top_z, plate_params, sub_dt,
                )
                ball_lin, ball_ang = ball_lin + dl, ball_ang + da
                ball_pos = ball_pos + ball_lin * sub_dt
                wq = torch.cat([torch.zeros_like(ball_ang[..., :1]), ball_ang], -1)
                ball_quat = maths.quat_normalize(ball_quat + 0.5 * sub_dt * maths.quat_mul(wq, ball_quat))

        return arm, ball_pos, ball_quat, ball_lin, ball_ang, actions, prev_actions

    def step(self, state: BallRollingState, action: torch.Tensor):
        c = self.cfg
        n = c.num_envs

        arm, ball_pos, ball_quat, ball_lin, ball_ang, actions, prev_actions = self._physics_step(state, action)

        # ---------------- tactile frame
        tool_pos, tool_quat = self._tool_pose(arm.q)
        cam_pos, cam_quat = self._camera_pose(tool_pos, tool_quat)
        radius = torch.full((n, 1), c.ball_radius, device=self.device)
        scene = SdfScene(
            spheres=torch.cat([ball_pos, radius], -1)[:, None, :],
            boxes=self._boxes,
            capsules=self._capsules,
            planes=self._planes,
        )
        depth = render_depth_batch(
            cam_pos, cam_quat, scene, tuple(c.camera_resolution), CAM_EXTENT, far=c.sensor_clipping[1]
        )
        rel_yaw = maths.yaw_from_quat(maths.quat_mul(maths.quat_conjugate(tool_quat), ball_quat))
        sensor_state, sensor_out = self.sensor.update(state.sensor, depth, obj_yaw=rel_yaw)

        state = BallRollingState(
            arm=arm, ball_pos=ball_pos, ball_quat=ball_quat, ball_lin=ball_lin, ball_ang=ball_ang,
            sensor=sensor_state, goal_pos=state.goal_pos, actions=actions, prev_actions=prev_actions,
            episode_length=state.episode_length + 1, total_episode_rew=state.total_episode_rew,
            curriculum=state.curriculum, dr=state.dr,
        )

        # ---------------- dones
        obj = ball_pos
        oob = (
            (obj[:, 0] < c.x_bounds[0]) | (obj[:, 0] > c.x_bounds[1])
            | (obj[:, 1] < c.y_bounds[0]) | (obj[:, 1] > c.y_bounds[1])
        )
        obj_goal_dist = torch.linalg.vector_norm(state.goal_pos - obj[:, :2], dim=-1)
        obj_far = obj_goal_dist > 0.75
        ee_far = torch.linalg.vector_norm(obj - tool_pos, dim=-1) > c.too_far_away_threshold
        # the reference tool frame is flipped 180deg about y vs ours; upright
        # there == pi rotation here, so measure tilt from straight-down.
        down = maths.quat_apply(tool_quat, self._z_axis)
        tilt = torch.acos(torch.clamp(-down[:, 2], -1.0, 1.0))
        tilted = tilt > math.pi / 4
        too_low = tool_pos[:, 2] < c.min_height_threshold
        terminated = oob | obj_far | ee_far | tilted | too_low
        truncated = state.episode_length >= c.max_episode_length - 1

        # ---------------- rewards
        reward, rew_info = self._rewards(state, tool_pos, tilt, sensor_out, obj_goal_dist)
        state = dataclasses.replace(state, total_episode_rew=state.total_episode_rew + reward)

        # ---------------- curriculum (mean episode reward vs thresholds)
        state = dataclasses.replace(state, curriculum=self._update_curriculum(state))

        # ---------------- masked reset + observations
        done = terminated | truncated
        state = self._reset_where(state, done)
        obs = self._observations(state, sensor_out=sensor_out, noise=True)

        info = {"log": rew_info, "indentation_depth": sensor_out["indentation_depth"]}
        return state, obs, reward, terminated, truncated, info

    # ---------------------------------------------------------------- rewards
    def _rewards(self, state, tool_pos, tilt, sensor_out, obj_goal_dist):
        c = self.cfg
        r = c.reward_cfg
        indent = sensor_out["indentation_depth"]
        obj_xy = state.ball_pos[:, :2]
        obj_z = state.ball_pos[:, 2] + c.ball_radius  # ball top

        in_band = (indent > r["at_obj_reward"]["min_depth"]) & (indent < r["at_obj_reward"]["max_depth"])
        at_obj = torch.where(in_band, r["at_obj_reward"]["weight"], 0.0)
        center_err = ((obj_xy - tool_pos[:, :2]) * 100.0).square().sum(-1) * r["centering_error"]["weight"]
        off_ground = torch.where(
            obj_z > r["off_the_ground_penalty"]["max_height"], r["off_the_ground_penalty"]["weight"], 0.0
        )
        height_diff = r["height_reward"]["target_height_cm"] - tool_pos[:, 2] * 100.0
        height_rew = (1.0 - torch.tanh(height_diff / r["height_reward"]["std"])) * r["height_reward"]["weight"]
        orient = torch.where(tilt < math.pi / 10, 0.0, r["orient_reward"]["weight"])

        ee_goal_dist = torch.linalg.vector_norm(tool_pos[:, :2] - state.goal_pos, dim=-1)
        ee_goal = (1.0 - torch.tanh(ee_goal_dist / r["ee_goal_tracking"]["std"])) * r["ee_goal_tracking"]["weight"]
        track = (1.0 - torch.tanh(obj_goal_dist / r["obj_goal_tracking"]["std"])) * r["obj_goal_tracking"]["weight"]
        fine = (
            1.0 - torch.tanh(obj_goal_dist / r["obj_goal_fine_tracking"]["std"])
        ) * r["obj_goal_fine_tracking"]["weight"]
        superfine = (
            1.0 - torch.tanh(obj_goal_dist / r["obj_goal_super_fine_tracking"]["std"]) ** 2
        ) * r["obj_goal_super_fine_tracking"]["weight"]
        success = torch.where(
            (obj_goal_dist < r["success_reward"]["threshold"]) & in_band, r["success_reward"]["weight"], 0.0
        )
        level = lambda levels, i: torch.index_select(levels, 0, state.curriculum[i : i + 1])
        act_w = r["action_rate_penalty"]["weight"] - level(self._act_rate_levels, 1)
        act_rate = (state.actions - state.prev_actions).square().sum(-1) * act_w
        jv_w = r["joint_vel_penalty"]["weight"] - level(self._joint_vel_levels, 2)
        joint_vel = state.arm.qd.square().sum(-1) * jv_w

        full = at_obj + off_ground + center_err + orient + track + fine + superfine + success + act_rate + joint_vel
        info = {
            "at_obj_reward": at_obj.mean(),
            "off_the_ground_penalty": off_ground.mean(),
            "height_reward": height_rew.mean(),
            "orient_reward": orient.mean(),
            "ee_goal_tracking_reward": ee_goal.mean(),
            "obj_goal_tracking_reward": track.mean(),
            "obj_goal_fine_tracking_reward": fine.mean(),
            "obj_goal_super_fine_tracking_reward": superfine.mean(),
            "success_reward": success.mean(),
            "action_rate_penalty": act_rate.mean(),
            "joint_vel_penalty": joint_vel.mean(),
            "full_reward": full.mean(),
            "Metric/obj_goal_error": obj_goal_dist.mean(),
            "Metric/indentation_depth": indent.mean(),
        }
        return full, info

    def _update_curriculum(self, state) -> torch.Tensor:
        c = self.cfg
        mean_rew = state.total_episode_rew.mean()

        def adjust(i, name, num_levels):
            level = state.curriculum[i]
            thr = c.curriculum_cfg[name]["threshold"]
            up = (mean_rew > thr) & (level < num_levels - 1)
            down = (mean_rew < thr * 0.90) & (level > 0)
            return level + up.to(torch.int32) - down.to(torch.int32)

        return torch.stack(
            [
                adjust(0, "goal_randomization_range", len(self._goal_rand_levels)),
                adjust(1, "action_rate_penalty", len(self._act_rate_levels)),
                adjust(2, "joint_vel_penalty", len(self._joint_vel_levels)),
            ]
        )

    # ------------------------------------------------------------------- obs
    def _observations(self, state, sensor_out=None, noise: bool = False):
        c = self.cfg
        n = c.num_envs
        tool_pos, tool_quat = self._tool_pose(state.arm.q)
        roll, pitch, yaw = maths.euler_xyz_from_quat(tool_quat)
        proprio = torch.cat(
            [tool_pos, roll[:, None], pitch[:, None], yaw[:, None], state.goal_pos, state.actions], dim=-1
        )
        if noise:
            proprio = proprio + c.obs_noise_std * torch.randn(
                proprio.shape, generator=self.generator, device=self.device
            )

        vh, vw, vc = c.vision_obs_shape
        if sensor_out is None:
            return {"proprio_obs": proprio, "vision_obs": torch.zeros((n, vh, vw, vc), device=self.device)}
        rgb = sensor_out["tactile_rgb"]
        if tuple(rgb.shape[1:3]) != (vh, vw):
            raise NotImplementedError("resizing the tactile image to the vision obs is not ported yet")
        if c.with_markers and "marker_motion" in sensor_out:
            mcfg = self.sensor.marker_cfg
            markers = sensor_out["marker_motion"][:, 1]  # (N, M, 2)
            sx, sy = vw / mcfg.tactile_img_width, vh / mcfg.tactile_img_height
            dot_cfg = dataclasses.replace(mcfg, marker_dot_radius_px=max(mcfg.marker_dot_radius_px * sx, 0.45))
            scaled = torch.stack([markers[..., 0] * sx, markers[..., 1] * sy], -1)
            dots = fots.draw_marker_image(dot_cfg, scaled, hw=(vh, vw))
            rgb = rgb * dots[..., None]
        return {"proprio_obs": proprio, "vision_obs": rgb}
