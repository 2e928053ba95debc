"""Grasp and lift a free cube with two FEM gel pads, batched (PyTorch).

Port of ``tacex_tpu/envs/grasp_lift/env.py``: two gel pads on a kinematic
parallel gripper and a free affine cube solve as one contact world
(``physics/soft/coupled.py``), every env in one batched Newton solve. The
cube rises only if the gel's friction carries it.

Action (2): [squeeze rate, lift rate] in [-1, 1], driving the pads' mount
faces (attachment targets).

Observations (``obs_mode``):
  * privileged: cube position and velocity, then the gripper's own
    proprio (squeeze, lift, each pad's mean gel compression, last actions);
  * depth: the gripper proprio and a (gh, gw, 2) image of each pad's
    inner-face compression (positive where the cube presses the gel in);
  * tactile: the gripper proprio and the full GelSight stack on both pads:
    one ``GelSightSensor`` over 2N pad-major images (the camera rides the
    mount, so the camera-frame depth is ``cam_to_contact - compression``),
    Taxim RGB through the pyramid and LUT-shade kernels, FOTS markers drawn
    into it; the two pads' images channel-stacked, (vh, vw, 6).

Rewards: lift progress, grip shaping, a drop penalty, an action-rate
penalty and a success bonus paid every step the cube is held lifted.
``step`` reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE
from ...ops.resize import resize_linear
from ...physics.soft.abd import AbdModel, AbdSolverCfg, AbdState
from ...physics.soft.coupled import CoupledModel
from ...physics.soft.embed import EmbeddedFaceGrid
from ...physics.soft.ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState
from ...physics.soft.mesh import box_tet_mesh, union_meshes
from ...sensors.gelsight.fots import marker_motion as fots
from ...sensors.gelsight.sensor import GelSightSensor, GelSightSensorState
from ...sensors.gelsight.sensor_cfg import gelsight_mini_cfg
from ...parallel.mesh import PAD_MAJOR
from ..base import DirectRLEnv, DirectRLEnvCfg

PAD_SIZE = (0.01, 0.03, 0.03)  # per-pad box (m)
PAD_CENTER_X = 0.0135  # pad centres at +-13.5 mm: a 1 mm gap to the cube on each side
CUBE_HALF = 0.0075


def _cube_surface(s: float = CUBE_HALF) -> tuple[np.ndarray, np.ndarray]:
    pts = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float64)
    tris = np.array(
        [
            [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
            [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
            [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
        ],
        np.int64,
    )
    return pts, tris


class PadRig:
    """The two gel pads of the gripper as one union FEM model: pad i centred
    at x = (2i - 1) * PAD_CENTER_X, its outer x face attached to the mount,
    its inner face a regular (nz + 1, ny + 1) vertex grid (rows z, columns
    y), optionally with a dense grid embedded in it. Shared by the
    Grasp-Lift and Factory-UIPC envs."""

    def __init__(self, cfg, z0: float, device):
        c = cfg
        meshes, mounts, inner_grids = [], [], []
        for sgn in (-1.0, +1.0):
            mesh = box_tet_mesh(PAD_SIZE, c.pad_resolution, center=(sgn * PAD_CENTER_X, 0.0, z0))
            meshes.append(mesh)
            xo = sgn * (PAD_CENTER_X + PAD_SIZE[0] / 2)
            xi = sgn * (PAD_CENTER_X - PAD_SIZE[0] / 2)
            mounts.append(np.where(np.abs(mesh.points[:, 0] - xo) < 1e-9)[0])
            inner = np.where(np.abs(mesh.points[:, 0] - xi) < 1e-9)[0]
            p = mesh.points[inner]
            order = np.lexsort((p[:, 1], p[:, 2]))  # rows = z, cols = y
            _, ny, nz = c.pad_resolution
            inner_grids.append(inner[order].reshape(nz + 1, ny + 1))
        union, offsets = union_meshes(meshes)
        self.union = union
        att = np.concatenate([m + offsets[i] for i, m in enumerate(mounts)]).astype(np.int64)
        grids = np.stack([g + offsets[i] for i, g in enumerate(inner_grids)])  # (2, gh, gw)
        f32 = dict(dtype=torch.float32, device=device)
        self.mount_rest = torch.as_tensor(union.points[att], **f32)  # (Va, 3)
        self.mount_sgn = torch.sign(self.mount_rest[:, 0])  # (Va,)
        self.rest_points = torch.as_tensor(union.points, **f32)  # (V, 3)
        self.pad_sgn = torch.tensor([-1.0, 1.0], **f32)
        if c.tactile_embed is not None:
            # bilinear binding into each pad's inner-face grid
            self.embeds = [EmbeddedFaceGrid(g, union.points, c.tactile_embed, device=device) for g in grids]
            self.shape = self.embeds[0].shape
            rest_x = np.stack([e.rest_points[:, 0] for e in self.embeds])
        else:
            self.embeds = None
            self.shape = grids.shape[1:]
            self._grid_ids = torch.as_tensor(grids.reshape(-1), dtype=torch.int64, device=device)
            rest_x = union.points[grids.reshape(-1), 0]
        self.rest_x = torch.as_tensor(np.asarray(rest_x, np.float32).reshape((2,) + tuple(self.shape)), **f32)

        fem_cfg = IpcSolverCfg(
            dt=c.sim_dt, newton_max_iter=c.newton_iters, cg_iters=c.cg_iters, d_hat=c.d_hat, kappa=c.kappa,
            friction_mu=c.friction_mu,
        )
        self.gel = SoftBodyModel(
            union, youngs_modulus=c.gel_youngs_modulus_mpa * 1e6, poisson_ratio=c.gel_poisson_ratio,
            mass_density=c.gel_density, cfg=fem_cfg, attachment_verts=att, device=device,
        )

    def abd_cfg(self, cfg) -> AbdSolverCfg:
        """The free body's solver settings: one body, so no body-body pairs."""
        return AbdSolverCfg(
            dt=cfg.sim_dt, d_hat=cfg.d_hat, kappa_contact=cfg.kappa, friction_mu=cfg.friction_mu, contact_k=0,
            ee_contact_k=0, linear_solver="cg", newton_max_iter=cfg.newton_iters,
        )

    def face_x(self, gel_x: torch.Tensor) -> torch.Tensor:
        """(N, 2, gh, gw) current x of each pad's inner-face grid (dense when embedded)."""
        n = gel_x.shape[0]
        if self.embeds is not None:
            x = torch.stack([e.positions(gel_x)[..., 0] for e in self.embeds], dim=1)
        else:
            x = gel_x.index_select(1, self._grid_ids)[..., 0]
        return x.reshape((n, 2) + tuple(self.shape))

    def compression(self, gel_x: torch.Tensor, shift_x: torch.Tensor) -> torch.Tensor:
        """(N, 2, gh, gw) inner-face compression in mm: how far the gel is held
        back from where a rigid pad would sit, the rest face moved by
        ``shift_x`` (N, 2) along x, measured along the pad's inward normal."""
        sgn = self.pad_sgn[None, :, None, None]
        expected = self.rest_x[None] + shift_x[:, :, None, None]
        return (expected - self.face_x(gel_x)) * (-sgn) * 1e3


@configclass
class GraspLiftEnvCfg(DirectRLEnvCfg):
    num_envs: int = 16
    episode_length_s: float = 2.0
    sim_dt: float = 1.0 / 100.0
    decimation: int = 2
    action_space: int = 2  # squeeze rate, lift rate
    obs_mode: str = "privileged"  # privileged | depth | tactile

    # tactile mode: each pad's sensor camera resolution (w, h); vision obs
    # (vh, vw, 6) stacks the two pads' images along the channels
    camera_resolution: tuple = (32, 32)
    vision_obs_shape: tuple = (32, 32, 3)

    # scene
    pad_resolution: tuple = (2, 4, 4)
    # an (eh, ew) dense grid embedded in each pad's inner face; None: the coarse grid
    tactile_embed: tuple | None = None
    gel_youngs_modulus_mpa: float = 0.1
    gel_poisson_ratio: float = 0.45
    gel_density: float = 1000.0
    cube_density: float = 2000.0
    friction_mu: float = 0.5
    ground_z: float = -0.02  # dropped cubes land here

    # gripper kinematics (m/s per action unit)
    squeeze_rate: float = 5.0e-3
    lift_rate: float = 2.0e-2
    max_squeeze: float = 1.5e-3  # inward travel per pad (m)
    max_lift: float = 0.03

    # task
    lift_target: float = 0.015
    drop_z: float = -0.008  # cube centre below this: dropped
    reset_xy_noise: float = 1.0e-3
    # random initial episode counters, so that envs do not truncate together
    stagger_initial_episodes: bool = True
    # log CoupledModel.missed_barriers every step
    log_broad_phase_overflow: bool = True

    # solver
    newton_iters: int = 6
    cg_iters: int = 24
    coupling_k: int = 4
    d_hat: float = 1.0e-3
    kappa: float = 1.0e4

    # rewards
    w_lift: float = 2.0
    w_grip: float = 0.5
    w_drop: float = 10.0
    w_action_rate: float = 0.01
    w_success: float = 10.0
    grip_target_mm: float = 0.4  # per-pad mean compression that saturates the grip reward


@dataclasses.dataclass(frozen=True)
class GraspLiftState:
    ENV_LAYOUT = {"sensor": PAD_MAJOR}  # parallel.mesh: every other field leads with the env axis

    gel: SoftBodyState  # the union of both pads
    cube: AbdState  # B = 1
    squeeze: torch.Tensor  # (N,) inward travel per pad (m)
    lift: torch.Tensor  # (N,) mount height offset (m)
    actions: torch.Tensor  # (N, 2)
    prev_actions: torch.Tensor  # (N, 2)
    episode_length: torch.Tensor  # (N,) int32
    ep_succeeded: torch.Tensor  # (N,) bool
    # FOTS trajectory state of both pad sensors, pad-major (2N rows), in every obs_mode
    sensor: GelSightSensorState


class GraspLiftEnv(DirectRLEnv):
    """Two FEM gel pads and one free affine cube in one contact world."""

    cfg: GraspLiftEnvCfg

    def __init__(self, cfg: GraspLiftEnvCfg | None = None, device=DEFAULT_DEVICE):
        cfg = cfg or GraspLiftEnvCfg()
        super().__init__(cfg, device=device)
        c, dev = cfg, self.device
        self.rig = PadRig(c, 0.0, dev)
        self.gel = self.rig.gel
        pts, tris = _cube_surface()
        self.cube = AbdModel([pts], [tris], mass_density=c.cube_density, kappa_ortho=1e7, cfg=self.rig.abd_cfg(c),
                             device=dev)
        self.world = CoupledModel(self.gel, self.cube, cross_k=c.coupling_k)

        # the ground plane for dropped cubes
        sc = RigidSdfScene.empty(c.num_envs, device=dev)
        planes = torch.tensor([0.0, 0.0, 1.0, c.ground_z], device=dev).expand_as(sc.planes).contiguous()
        self.scene = dataclasses.replace(sc, planes=planes)
        self._zeros2 = torch.zeros((c.num_envs, 2), device=dev)
        self._q_identity = AbdState.identity(c.num_envs, 1, device=dev).q  # (N, 1, 12)

        if c.obs_mode == "tactile":
            res = tuple(c.camera_resolution)
            self.sensor = GelSightSensor(
                gelsight_mini_cfg(with_markers=True, camera_resolution=res, tactile_img_res=res),
                num_envs=2 * c.num_envs, device=dev,
            )
            ocfg = self.sensor.cfg.optical_sim_cfg
            # camera to the rest contact face: the undeformed gel images at zero indentation
            self._cam_to_contact = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
            mcfg = self.sensor.marker_cfg
            vh, vw, _ = c.vision_obs_shape
            sx, sy = vw / mcfg.tactile_img_width, vh / mcfg.tactile_img_height
            self._dot_cfg = dataclasses.replace(mcfg, marker_dot_radius_px=max(mcfg.marker_dot_radius_px * sx, 0.45))
            self._dot_scale = torch.tensor([sx, sy], device=dev)
        elif c.obs_mode in ("privileged", "depth"):
            self.sensor = None
        else:
            raise ValueError(f"unknown obs_mode {c.obs_mode!r}")

    # ------------------------------------------------------------------ state
    def init_state(self) -> GraspLiftState:
        n, dev = self.cfg.num_envs, self.device
        z = torch.zeros((n,), device=dev)
        return GraspLiftState(
            gel=SoftBodyState.init(n, self.rig.union.points, device=dev),
            cube=AbdState.identity(n, 1, device=dev),
            squeeze=z, lift=z.clone(), actions=self._zeros2.clone(), prev_actions=self._zeros2.clone(),
            episode_length=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_succeeded=torch.zeros((n,), dtype=torch.bool, device=dev),
            sensor=GelSightSensorState.init(2 * n, device=dev),
        )

    def reset_all(self, state: GraspLiftState):
        c = self.cfg
        state = self._reset_where(state, torch.ones((c.num_envs,), dtype=torch.bool, device=self.device))
        if c.stagger_initial_episodes:
            ep0 = torch.randint(0, c.max_episode_length, (c.num_envs,), generator=self.generator,
                                device=self.device, dtype=torch.int32)
            state = dataclasses.replace(state, episode_length=ep0)
        obs, state, _ = self._observations(state)
        return state, obs

    def _uniform_xy(self, bound: float) -> torch.Tensor:
        u = torch.rand((self.cfg.num_envs, 2), generator=self.generator, device=self.device)
        return u * (2.0 * bound) - bound

    def _reset_where(self, state: GraspLiftState, mask: torch.Tensor) -> GraspLiftState:
        n = self.cfg.num_envs
        m1, m2 = mask[:, None], mask[:, None, None]
        # the cube: identity pose with a small xy offset
        xy = self._uniform_xy(self.cfg.reset_xy_noise)
        q0 = self._q_identity
        q0 = torch.cat([q0[..., :2] + xy[:, None, :], q0[..., 2:]], -1)
        cube = AbdState(q=torch.where(m2, q0, state.cube.q), qd=torch.where(m2, 0.0, state.cube.qd))
        gel = SoftBodyState(
            x=torch.where(m2, self.rig.rest_points, state.gel.x), v=torch.where(m2, 0.0, state.gel.v)
        )
        # the sensor rows are pad-major (2N): both pads reset together
        mask2 = torch.cat([mask, mask])
        sensor = GelSightSensorState(
            traj_start=torch.where(mask2[:, None], 0.0, state.sensor.traj_start),
            traj_curr=torch.where(mask2[:, None], 0.0, state.sensor.traj_curr),
            traj_count=torch.where(mask2, 0, state.sensor.traj_count),
        )
        return GraspLiftState(
            gel=gel, cube=cube,
            squeeze=torch.where(mask, 0.0, state.squeeze), lift=torch.where(mask, 0.0, state.lift),
            actions=torch.where(m1, 0.0, state.actions), prev_actions=torch.where(m1, 0.0, state.prev_actions),
            episode_length=torch.where(mask, 0, state.episode_length),
            ep_succeeded=torch.where(mask, False, state.ep_succeeded), sensor=sensor,
        )

    # ------------------------------------------------------------------- step
    def _aim_positions(self, squeeze: torch.Tensor, lift: torch.Tensor) -> torch.Tensor:
        """Mount targets (N, Va, 3): the rest mount moved inward by squeeze and up by lift."""
        inward = -self.rig.mount_sgn[None, :] * squeeze[:, None]  # (N, Va)
        off = torch.stack([inward, torch.zeros_like(inward), lift[:, None].expand_as(inward)], -1)
        return self.rig.mount_rest[None] + off

    def _pad_compression(self, gel_x: torch.Tensor, squeeze: torch.Tensor) -> torch.Tensor:
        """(N, 2, gh, gw) inner-face compression (mm): a rigid pad's face
        would sit at rest - sgn * squeeze along x."""
        return self.rig.compression(gel_x, -self.rig.pad_sgn[None, :] * squeeze[:, None])

    def step(self, state: GraspLiftState, action: torch.Tensor):
        c = self.cfg
        action = torch.clamp(torch.nan_to_num(action), -1.0, 1.0)
        prev_actions = state.actions
        gel, cube, squeeze, lift = state.gel, state.cube, state.squeeze, state.lift
        for _ in range(c.decimation):
            squeeze = torch.clamp(squeeze + action[:, 0] * c.squeeze_rate * c.sim_dt, 0.0, c.max_squeeze)
            lift = torch.clamp(lift + action[:, 1] * c.lift_rate * c.sim_dt, 0.0, c.max_lift)
            gel, cube = self.world.step(gel, cube, self.scene, aim_pos=self._aim_positions(squeeze, lift))

        cube_z = cube.q[:, 0, 2]
        grip = self._pad_compression(gel.x, squeeze).mean((2, 3))  # (N, 2)
        state = dataclasses.replace(
            state, gel=gel, cube=cube, squeeze=squeeze, lift=lift, actions=action, prev_actions=prev_actions,
            episode_length=state.episode_length + 1,
        )

        # rewards
        r_lift = c.w_lift * torch.clamp(cube_z / c.lift_target, 0.0, 1.2)
        grip_min = grip.amin(-1)
        r_grip = c.w_grip * torch.clamp(grip_min / c.grip_target_mm, 0.0, 1.0)
        dropped = cube_z < c.drop_z
        success = (cube_z > 0.9 * c.lift_target) & (grip_min > 0.05)
        r_drop = -c.w_drop * dropped.float()
        act_rate = -c.w_action_rate * ((action - prev_actions) ** 2).sum(-1)
        # success is a held state that pays every step, not a termination
        r_success = c.w_success * success.float()
        reward = r_lift + r_grip + r_drop + act_rate + r_success

        state = dataclasses.replace(state, ep_succeeded=state.ep_succeeded | success)
        terminated = dropped
        truncated = state.episode_length >= c.max_episode_length
        done = terminated | truncated

        log = {"lift_reward": r_lift.mean()}
        if c.log_broad_phase_overflow:
            log["Metric/missed_barriers"] = self.world.missed_barriers(gel.x, cube.q).sum().float()
        log.update({
            "grip_reward": r_grip.mean(),
            "drop_penalty": r_drop.mean(),
            "success_reward": r_success.mean(),
            "Metric/cube_z_mm": (cube_z * 1e3).mean(),
            "Metric/grip_mm": grip_min.mean(),
            "Metric/success_rate": success.float().mean(),
        })
        info = {"log": log, "cube_z": cube_z, "grip": grip}

        state = self._reset_where(state, done)
        obs, state, sensor_out = self._observations(state)
        if sensor_out is not None:
            # pad-major (2N, ...) -> (N, 2, ...)
            n = c.num_envs
            info["tactile_rgb"] = torch.stack([sensor_out["tactile_rgb"][:n], sensor_out["tactile_rgb"][n:]], 1)
            if "marker_motion" in sensor_out:
                mm = sensor_out["marker_motion"]
                info["marker_motion"] = torch.stack([mm[:n], mm[n:]], 1)
        return state, obs, reward, terminated, truncated, info

    # ------------------------------------------------------------------- obs
    def _pad_sensor_depth(self, comp_mm: torch.Tensor) -> torch.Tensor:
        """Each pad's camera depth (2N, res_h, res_w) in metres, pad-major:
        the camera rides the mount, so the face sits at ``cam_to_contact``
        less its compression."""
        n, _, gh, gw = comp_mm.shape
        depth = self._cam_to_contact - comp_mm * 1e-3
        depth = torch.cat([depth[:, 0], depth[:, 1]], 0)
        res_w, res_h = self.cfg.camera_resolution
        if (gh, gw) != (res_h, res_w):
            depth = resize_linear(depth, (2 * n, res_h, res_w))
        return depth

    def _cube_pose_in_pads(self, state: GraspLiftState):
        """The cube's position (mm) and in-plane yaw in each pad's sensor
        frame, pad-major (2N,): image x = -sgn y, image y = z."""
        q = state.cube.q[:, 0]
        t = q[:, :3]
        pos, yaw = [], []
        for sgn in (-1.0, 1.0):
            pos.append(torch.stack([-sgn * t[:, 1], t[:, 2] - state.lift], -1) * 1e3)
            # the body axis resting along image x is b = -sgn y; w = A b = -sgn A[:, 1]
            w_y, w_z = -sgn * q[:, 7], -sgn * q[:, 10]  # A[1, 1], A[2, 1]
            yaw.append(torch.atan2(w_z, -sgn * w_y))
        return torch.cat(pos, 0), torch.cat(yaw, 0)

    def _observations(self, state: GraspLiftState):
        """(obs, state, sensor_out): the tactile path advances the FOTS state."""
        comp = self._pad_compression(state.gel.x, state.squeeze)
        grip = comp.mean((2, 3))
        # what the gripper knows of itself
        gripper_proprio = torch.cat(
            [state.squeeze[:, None] * 1e3, state.lift[:, None] * 1e2, grip, state.actions], -1
        )
        if self.cfg.obs_mode == "privileged":
            proprio = torch.cat([state.cube.q[:, 0, :3], state.cube.qd[:, 0, :3], gripper_proprio], -1)
            return {"proprio_obs": proprio}, state, None
        if self.cfg.obs_mode == "depth":
            return {"proprio_obs": gripper_proprio, "vision_obs": comp.permute(0, 2, 3, 1)}, state, None

        n = self.cfg.num_envs
        obj_pos_mm, obj_yaw = self._cube_pose_in_pads(state)
        sensor_state, sensor_out = self.sensor.update(
            state.sensor, self._pad_sensor_depth(comp), obj_yaw=obj_yaw, obj_pos_mm=obj_pos_mm
        )
        state = dataclasses.replace(state, sensor=sensor_state)
        vh, vw, _ = self.cfg.vision_obs_shape
        rgb = sensor_out["tactile_rgb"]  # (2N, th, tw, 3)
        if tuple(rgb.shape[1:3]) != (vh, vw):
            rgb = resize_linear(rgb, (2 * n, vh, vw, 3))
        if "marker_motion" in sensor_out:
            markers = sensor_out["marker_motion"][:, 1]  # (2N, M, 2)
            dots = fots.draw_marker_image(self._dot_cfg, markers * self._dot_scale, hw=(vh, vw))
            rgb = rgb * dots[..., None]
        return {"proprio_obs": gripper_proprio, "vision_obs": torch.cat([rgb[:n], rgb[n:]], -1)}, state, sensor_out
