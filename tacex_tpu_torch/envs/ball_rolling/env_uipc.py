"""Ball rolling with a soft FEM gel pad (the UIPC env variant), batched.

Port of ``tacex_tpu/envs/ball_rolling/env_uipc.py``, the tasks
``TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0`` and
``TacEx-Ball-Rolling-Uipc-Textured-v0``: the rigid ball-rolling task with
the gel pad simulated as a stable Neo-Hookean FEM body that every env
solves in one batched IPC step (``physics/soft/ipc.py``). The reference
runs one env, because its libuipc scene is single-env.

Coupling, explicit each substep:
  * the gel's mount-face vertices are soft-position-constrained to the tool
    pose (attachments);
  * the gel deforms against the ball and the plate as analytic SDFs (IPC
    barrier, one solve a step after the ball substeps);
  * the ball feels the gel through the barrier's reaction,
    -dE_barrier/d(ball centre), at the last solve's gel surface, with a
    Coulomb friction impulse, and the plate through rigid contact.

The tactile image comes from the deformed FEM surface: the contact face of
the structured gel mesh is a regular grid (or a dense grid embedded in it,
``gel_embed_surface``), so its camera-frame depth resamples to the sensor
resolution with one linear resize. ``obs_mode="camera_rgb"`` films a marker
texture on the deformed surface (rasterized with per-vertex UVs) and
modulates it by the tactile image. ``step`` reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core import maths
from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE
from ...ops.resize import resize_linear
from ...physics.rigid import contact, franka
from ...physics.soft.embed import EmbeddedFaceGrid
from ...physics.soft.ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState
from ...physics.soft.mesh import box_tet_mesh
from ...render import mesh_raster
from ...sensors.gelsight.fem import FemMarkerFlow, ManiSkillSimulatorCfg
from ...sensors.gelsight.fots import marker_motion as fots
from .env import GELPAD_HALF, OBS_MODES, BallRollingEnv, BallRollingEnvCfg, BallRollingState


def _col(v):
    """Broadcast a scalar-or-(N,) parameter against (N, 3) vectors."""
    return v[..., None] if isinstance(v, torch.Tensor) and v.ndim == 1 else v


# the gel's solve: Newton and CG iterations a step
NEWTON_ITERS = 4
CG_ITERS = 16


@configclass
class BallRollingUipcEnvCfg(BallRollingEnvCfg):
    # gel material (reference UipcObjectCfg StableNeoHookean)
    gel_youngs_modulus_pa: float = 1.45e5
    gel_poisson_ratio: float = 0.45
    # mixed resolution: solve the coarse mesh, bind a dense contact-face grid
    # to it once (physics/soft/embed.py); depth and marker flow sample the
    # dense surface. A preset name or an (eh, ew) vertex count; None: off.
    gel_embed_surface: str | tuple | None = None
    # gel mesh density: presets named after the reference's gelpad variants
    gel_resolution: str | tuple = "low"


GEL_RESOLUTION_PRESETS: dict[str, tuple] = {
    "low": (8, 10, 2),
    "mid": (16, 20, 3),
    "high": (24, 30, 4),
    "extremely_high": (40, 50, 5),
}


@dataclasses.dataclass(frozen=True)
class UipcBallRollingState:
    base: BallRollingState
    gel: SoftBodyState


class BallRollingUipcEnv(BallRollingEnv):
    """FEM-gelpad variant; shares actions, rewards and dones with the rigid env."""

    obs_modes = OBS_MODES + ("camera_rgb",)

    cfg: BallRollingUipcEnvCfg

    def __init__(self, cfg: BallRollingUipcEnvCfg | None = None, device=DEFAULT_DEVICE, with_marker_flow: bool = True):
        if cfg is None:
            cfg = BallRollingUipcEnvCfg(num_envs=16, obs_mode="rgb", with_markers=False)
        super().__init__(cfg, device=device)
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        res = cfg.gel_resolution
        if isinstance(res, str):
            res = GEL_RESOLUTION_PRESETS[res]
        gel_size = (2 * GELPAD_HALF[0], 2 * GELPAD_HALF[1], 2 * GELPAD_HALF[2])
        # gel mesh in the TOOL frame: the tool point is the gel's contact
        # surface, so the contact face sits at z = 0, the mount face at -h
        self.gel_mesh = box_tet_mesh(gel_size, res, center=(0.0, 0.0, -GELPAD_HALF[2]))
        points = self.gel_mesh.points
        top = np.where(points[:, 2] < -gel_size[2] + 1e-9)[0]
        solver_cfg = IpcSolverCfg(dt=cfg.sim_dt, newton_max_iter=NEWTON_ITERS, cg_iters=CG_ITERS, d_hat=5e-4, kappa=2e4)
        self.gel = SoftBodyModel(
            self.gel_mesh,
            youngs_modulus=cfg.gel_youngs_modulus_pa,
            poisson_ratio=cfg.gel_poisson_ratio,
            cfg=solver_cfg,
            attachment_verts=top,
            device=dev,
        )
        self._gel_top_rest = torch.as_tensor(points[top], **f32)
        self._gel_rest_points = torch.as_tensor(points, **f32)
        n = cfg.num_envs
        self._no_planes = torch.zeros((n, 1, 4), **f32)
        self._ball_radius = torch.full((n, 1), cfg.ball_radius, **f32)

        # the contact-face vertices form a regular (ny+1, nx+1) grid
        nx, ny, _ = res
        contact_ids = np.where(np.abs(points[:, 2]) < 1e-9)[0]
        order = np.lexsort((points[contact_ids, 0], points[contact_ids, 1]))  # row-major: y rows, x cols
        grid_ids = contact_ids[order].reshape(ny + 1, nx + 1)
        self._grid_shape = grid_ids.shape
        self._contact_grid_ids = torch.as_tensor(grid_ids.reshape(-1), device=dev)

        # mixed resolution: a dense contact-face grid bound once
        embed = cfg.gel_embed_surface
        if embed is not None:
            if isinstance(embed, str):
                enx, eny, _ = GEL_RESOLUTION_PRESETS[embed]
                embed = (eny + 1, enx + 1)
            st = np.asarray(self.gel_mesh.surface_tris)
            on_face = np.abs(points[:, 2]) < 1e-9
            self.embed = EmbeddedFaceGrid(grid_ids, points, embed, face_tris=st[on_face[st].all(axis=1)], device=dev)
        else:
            self.embed = None

        # textured filming (obs_mode "camera_rgb"): the camera rasterizes the
        # deformed contact surface with per-vertex UVs (the rest layout,
        # normalised) and samples a procedural marker-dot texture
        if cfg.obs_mode == "camera_rgb":
            film = self.embed if self.embed is not None else EmbeddedFaceGrid(grid_ids, points, grid_ids.shape, device=dev)
            film_rest, film_tris = film.rest_points, film.triangles
            hx, hy = GELPAD_HALF[0], GELPAD_HALF[1]
            uv = np.stack([(film_rest[:, 0] + hx) / (2 * hx), (film_rest[:, 1] + hy) / (2 * hy)], -1).astype(np.float32)
            self._film_tris = torch.as_tensor(film_tris.reshape(-1).astype(np.int64), device=dev)
            self._film_uv = torch.as_tensor(uv[film_tris], **f32)  # (T, 3, 2)
            mc = fots.FOTSMarkerCfg()
            tex = np.full((mc.tactile_img_height, mc.tactile_img_width, 3), 0.6, np.float32)
            yy0, xx0 = np.mgrid[0 : mc.tactile_img_height, 0 : mc.tactile_img_width]
            for mx, my in fots.init_marker_grid(mc).numpy():
                tex[(xx0 - mx) ** 2 + (yy0 - my) ** 2 <= (1.5 * mc.marker_dot_radius_px) ** 2] = 0.15
            self._film_tex = torch.as_tensor(tex, **f32)
            vh, vw, _ = cfg.vision_obs_shape
            px = np.linspace(-hx, hx, vw, dtype=np.float32)
            py = np.linspace(-hy, hy, vh, dtype=np.float32)
            gx, gy = np.meshgrid(px, py)  # rows = y (the depth grid's convention)
            self._film_pix = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1), **f32)

        # FEM marker flow on the contact face (camera frame: +z from the camera)
        if with_marker_flow:
            ocfg = self.sensor.cfg.optical_sim_cfg
            cam_to_contact = ocfg.gelpad_to_camera_min_distance + ocfg.gelpad_height
            if self.embed is not None:
                rest_cam = self.embed.rest_points.copy()
                tris = self.embed.triangles
            else:
                remap = -np.ones(self.gel_mesh.num_vertices, np.int64)
                remap[self.gel_mesh.surface_verts] = np.arange(len(self.gel_mesh.surface_verts))
                tris = remap[self.gel_mesh.surface_tris].astype(np.int32)
                rest_cam = points[self.gel_mesh.surface_verts].copy()
            rest_cam[:, 2] += cam_to_contact  # contact face -> z = 0.0285
            self.marker_flow = FemMarkerFlow(ManiSkillSimulatorCfg(), rest_cam.astype(np.float32), tris, seed=0, device=dev)
        else:
            self.marker_flow = None

    # ------------------------------------------------------------------ state
    def init_state(self) -> UipcBallRollingState:
        base = super().init_state()
        return UipcBallRollingState(base=base, gel=self._gel_world_rest_state(base))

    def _gel_world_rest_state(self, base: BallRollingState) -> SoftBodyState:
        tool_pos, tool_quat = self._tool_pose(base.arm.q)
        x = maths.transform_points(self._gel_rest_points, tool_pos, tool_quat)  # (N, V, 3)
        return SoftBodyState(x=x, v=torch.zeros_like(x))

    def reset_all(self, state: UipcBallRollingState):
        base = self._reset_where(state.base, torch.ones((self.cfg.num_envs,), dtype=torch.bool, device=self.device))
        obs = self._observations(base, sensor_out=None, noise=False)
        return UipcBallRollingState(base=base, gel=self._gel_world_rest_state(base)), obs

    # ------------------------------------------------------------------- step
    def _scene(self, ball_pos: torch.Tensor, planes: torch.Tensor) -> RigidSdfScene:
        return RigidSdfScene(
            spheres=torch.cat([ball_pos, self._ball_radius], -1)[:, None, :],
            boxes=self._boxes, capsules=self._capsules, planes=planes,
        )

    def _physics_step(self, state: UipcBallRollingState, action: torch.Tensor):
        """IK + servo + the two-way ball/gel coupling + the FEM gel solve."""
        c = self.cfg
        base, gel_state = state.base, state.gel

        prev_actions = base.actions
        actions = torch.clamp(torch.nan_to_num(action), -1.0, 1.0)
        actions = actions + self._uniform(actions.shape, -c.action_noise, c.action_noise)
        processed = actions * c.action_scale
        if processed.shape[-1] < 6:
            processed = F.pad(processed, (0, 6 - processed.shape[-1]))
        arm = franka.apply_delta_pose_ik(
            base.arm, processed[:, :3], processed[:, 3:6], self.limits, ee_offset_pos=c.ee_offset
        )

        ball_pos, ball_quat = base.ball_pos, base.ball_quat
        ball_lin, ball_ang = base.ball_lin, base.ball_ang
        # rigid ball substeps: plate contact and the gel's barrier reaction at
        # the last solve's surface (staggered: the gel re-solves below)
        sub_dt = c.sim_dt / c.physics_substeps
        dr = base.dr
        bp = contact.SphereParams(
            radius=c.ball_radius, mass=dr.ball_mass, restitution=dr.ball_restitution,
            friction=0.5 * (dr.ball_friction + dr.pad_friction),
        )
        plate_params = dataclasses.replace(bp, friction=0.5 * (dr.ball_friction + dr.plate_friction))
        zero = torch.zeros_like(dr.gravity_z)
        gravity = torch.stack([zero, zero, dr.gravity_z], -1)
        m_eff = 1.0 / (bp.inv_mass + bp.inv_inertia * c.ball_radius**2)  # tangential effective mass
        tool_pos, _ = self._tool_pose(arm.q)
        for _ in range(c.physics_substeps):
            tool_prev = tool_pos
            arm = franka.servo_step(arm, sub_dt, self.limits)
            tool_pos, tool_quat = self._tool_pose(arm.q)
            pad_vel = (tool_pos - tool_prev) / sub_dt

            ball_lin = ball_lin + gravity * sub_dt
            f_gel = self.gel.sphere_contact_force(gel_state, self._scene(ball_pos, self._no_planes))[:, 0]  # (N, 3)
            f_mag = torch.linalg.vector_norm(f_gel, dim=-1)
            # normal impulse, capped (the log barrier is singular at d -> 0)
            dv = f_gel * (sub_dt * _col(bp.inv_mass))
            dv_n = torch.linalg.vector_norm(dv, dim=-1, keepdim=True)
            ball_lin = ball_lin + dv * torch.clamp(0.25 / torch.clamp(dv_n, min=1e-9), max=1.0)
            # Coulomb friction against the slip of the ball on the tool-following gel
            in_contact = f_mag > 1e-6
            n_dir = f_gel / torch.clamp(f_mag, min=1e-9)[..., None]
            r_vec = -c.ball_radius * n_dir
            v_cp = ball_lin + maths.cross(ball_ang, r_vec) - pad_vel
            vt = v_cp - (v_cp * n_dir).sum(-1, keepdim=True) * n_dir
            vt_mag = torch.linalg.vector_norm(vt, dim=-1)
            jt = torch.minimum(bp.friction * f_mag * sub_dt, m_eff * vt_mag)
            t_dir = vt / torch.clamp(vt_mag, min=1e-9)[..., None]
            imp = -jt[..., None] * t_dir * in_contact[..., None]
            ball_lin = ball_lin + imp * _col(bp.inv_mass)
            ball_ang = ball_ang + _col(bp.inv_inertia) * maths.cross(r_vec, imp)

            dl, da = contact.sphere_plane_contact(
                ball_pos, ball_lin, ball_ang, (0.0, 0.0, 1.0), c.plate_top_z, plate_params, sub_dt
            )
            ball_lin, ball_ang = ball_lin + dl, ball_ang + da
            ball_pos = ball_pos + ball_lin * sub_dt
            wq = torch.cat([torch.zeros_like(ball_ang[..., :1]), ball_ang], -1)
            ball_quat = maths.quat_normalize(ball_quat + 0.5 * sub_dt * maths.quat_mul(wq, ball_quat))

        # the FEM gel step (one dt): deform against the ball and the plate
        tool_pos, tool_quat = self._tool_pose(arm.q)
        aim = maths.transform_points(self._gel_top_rest, tool_pos, tool_quat)
        gel_state = self.gel.step(gel_state, self._scene(ball_pos, self._planes), aim)
        return arm, ball_pos, ball_quat, ball_lin, ball_ang, gel_state, actions, prev_actions, tool_pos, tool_quat

    def step_physics_only(self, state: UipcBallRollingState, action: torch.Tensor) -> UipcBallRollingState:
        """Physics (the FEM gel solve included) without the tactile stage: a
        harness times this beside ``step``."""
        arm, ball_pos, ball_quat, ball_lin, ball_ang, gel, actions, prev_actions, _, _ = self._physics_step(
            state, action
        )
        base = dataclasses.replace(
            state.base, arm=arm, ball_pos=ball_pos, ball_quat=ball_quat, ball_lin=ball_lin, ball_ang=ball_ang,
            actions=actions, prev_actions=prev_actions, episode_length=state.base.episode_length + 1,
        )
        return UipcBallRollingState(base=base, gel=gel)

    def step(self, state: UipcBallRollingState, action: torch.Tensor):
        c = self.cfg
        n = c.num_envs
        base = state.base
        (arm, ball_pos, ball_quat, ball_lin, ball_ang, gel_state,
         actions, prev_actions, tool_pos, tool_quat) = self._physics_step(state, action)

        # ---------------- tactile frame from the deformed FEM surface
        cam_pos, cam_quat, grid_world, grid_cam, depth = self.contact_surface(gel_state.x, tool_pos, tool_quat)
        rel_yaw = maths.yaw_from_quat(maths.quat_mul(maths.quat_conjugate(tool_quat), ball_quat))
        sensor_state, sensor_out = self.sensor.update(base.sensor, depth, obj_yaw=rel_yaw)

        if self.marker_flow is not None:
            surf_world = grid_world if self.embed is not None else self.gel.surface_positions(gel_state)
            surf_cam = maths.quat_apply_inverse(cam_quat[:, None], surf_world - cam_pos[:, None])
            sensor_out["marker_flow"] = self.marker_flow.flow(surf_cam, self.generator)
        if c.obs_mode == "camera_rgb":
            sensor_out["filmed_rgb"] = self._film_texture_frame(grid_cam)

        base = BallRollingState(
            arm=arm, ball_pos=ball_pos, ball_quat=ball_quat, ball_lin=ball_lin, ball_ang=ball_ang,
            sensor=sensor_state, goal_pos=base.goal_pos, actions=actions, prev_actions=prev_actions,
            episode_length=base.episode_length + 1, total_episode_rew=base.total_episode_rew,
            curriculum=base.curriculum, dr=base.dr,
        )

        # ---------------- dones and rewards (as the rigid env)
        obj = ball_pos
        oob = (
            (obj[:, 0] < c.x_bounds[0]) | (obj[:, 0] > c.x_bounds[1])
            | (obj[:, 1] < c.y_bounds[0]) | (obj[:, 1] > c.y_bounds[1])
        )
        obj_goal_dist = torch.linalg.vector_norm(base.goal_pos - obj[:, :2], dim=-1)
        down = maths.quat_apply(tool_quat, self._z_axis)
        tilt = torch.acos(torch.clamp(-down[:, 2], -1.0, 1.0))
        terminated = (
            oob
            | (obj_goal_dist > 0.75)
            | (torch.linalg.vector_norm(obj - tool_pos, dim=-1) > c.too_far_away_threshold)
            | (tilt > math.pi / 4)
            | (tool_pos[:, 2] < c.min_height_threshold)
        )
        truncated = base.episode_length >= c.max_episode_length - 1
        reward, rew_info = self._rewards(base, tool_pos, tilt, sensor_out, obj_goal_dist)
        # as the JAX UIPC env: the curriculum reads the episode totals before
        # this step's reward (the rigid env reads them after it)
        base = dataclasses.replace(
            base, total_episode_rew=base.total_episode_rew + reward, curriculum=self._update_curriculum(base)
        )

        done = terminated | truncated
        base = self._reset_where(base, done)
        # gel reset: the rest mesh at the (possibly reset) tool pose
        rest = self._gel_world_rest_state(base)
        m = done[:, None, None]
        gel_state = SoftBodyState(x=torch.where(m, rest.x, gel_state.x), v=torch.where(m, 0.0, gel_state.v))

        obs = self._observations(base, sensor_out=sensor_out, noise=True)
        info = {"log": rew_info, "indentation_depth": sensor_out["indentation_depth"]}
        if "marker_flow" in sensor_out:
            info["marker_flow"] = sensor_out["marker_flow"]
        return UipcBallRollingState(base=base, gel=gel_state), obs, reward, terminated, truncated, info

    def contact_surface(self, gel_x: torch.Tensor, tool_pos: torch.Tensor, tool_quat: torch.Tensor):
        """The sensor camera's pose, the contact surface (the face grid, or
        the embedded dense grid) in the world and camera frames, and the
        camera depth map resampled to the sensor resolution, of the gel
        ``gel_x`` (N, V, 3) under the tool pose."""
        n = gel_x.shape[0]
        cam_pos, cam_quat = self._camera_pose(tool_pos, tool_quat)
        if self.embed is not None:
            grid_world = self.embed.positions(gel_x)  # (N, eh*ew, 3)
            gh, gw = self.embed.shape
        else:
            grid_world = gel_x.index_select(1, self._contact_grid_ids)  # (N, G, 3)
            gh, gw = self._grid_shape
        grid_cam = maths.quat_apply_inverse(cam_quat[:, None], grid_world - cam_pos[:, None])
        res_w, res_h = self.cfg.camera_resolution
        depth = resize_linear(grid_cam[..., 2].reshape(n, gh, gw), (n, res_h, res_w))
        return cam_pos, cam_quat, grid_world, grid_cam, depth

    def _film_texture_frame(self, grid_cam: torch.Tensor) -> torch.Tensor:
        """(N, Vs, 3) camera-frame film surface -> (N, vh, vw, 3) filmed
        texture frame: the deformed triangles rasterized with their UVs and
        the marker texture fetched bilinearly; off the gel, the dark case."""
        n = grid_cam.shape[0]
        tris_cam = grid_cam.index_select(1, self._film_tris).unflatten(1, (-1, 3))  # (N, T, 3, 3)
        depth, uv = mesh_raster.raster_attributes(tris_cam, self._film_uv, self._film_pix, near=1e-4)
        texel = mesh_raster.sample_texture_bilinear(self._film_tex, uv)
        hit = (depth < mesh_raster.BIG * 0.5)[..., None]
        vh, vw, _ = self.cfg.vision_obs_shape
        return torch.where(hit, texel, 0.3).reshape(n, vh, vw, 3)

    def _observations(self, state, sensor_out=None, noise: bool = False):
        if self.cfg.obs_mode == "camera_rgb" and sensor_out is not None and "filmed_rgb" in sensor_out:
            # the sensor camera films the marker texture on the deformed gel,
            # modulated by the tactile illumination
            obs = super()._observations(state, sensor_out=None, noise=noise)
            n = self.cfg.num_envs
            vh, vw, _ = self.cfg.vision_obs_shape
            rgb = sensor_out.get("tactile_rgb")
            if rgb is None:
                rgb = torch.full((n, vh, vw, 3), 0.45, device=self.device)
            elif tuple(rgb.shape[1:3]) != (vh, vw):
                rgb = resize_linear(rgb, (n, vh, vw, 3))
            # the texture's base gray is 0.6: the background matches the
            # tactile frame and the dots darken it
            obs["vision_obs"] = torch.clamp(rgb * sensor_out["filmed_rgb"] / 0.6, 0.0, 1.0)
            return obs
        return super()._observations(state, sensor_out=sensor_out, noise=noise)
