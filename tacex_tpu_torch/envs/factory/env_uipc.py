"""Factory peg insertion with two FEM gel pads and a free affine peg (PyTorch).

Port of ``tacex_tpu/envs/factory/env_uipc.py``: the Grasp-Lift rig (two gel
pads on a kinematic parallel gripper, ``grasp_lift/env.py``'s ``PadRig``)
holds a free affine square peg above a socket, all in one batched coupled
FEM+ABD solve (``physics/soft/coupled.py``). The socket is four boxes
around a square pocket and the ground plane closes it: analytic colliders
for both the gel and the peg. Insertion succeeds only if friction carries
the peg into the pocket.

Action (4): [dx, dy, dz, squeeze] rates in [-1, 1] driving the gripper
mount. Observations: privileged (16-dim proprio) or depth (the same proprio
and each pad's inner-face compression image). Rewards follow the Factory
keypoint recipe: two squash kernels of the peg tip's distance to the hole
target, an engagement bonus, a held success bonus, a drop penalty and an
action-rate penalty. ``step`` reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE
from ...physics.soft.abd import AbdModel, AbdState
from ...physics.soft.coupled import CoupledModel
from ...physics.soft.ipc import RigidSdfScene, SoftBodyState
from ..base import DirectRLEnv, DirectRLEnvCfg
from ..grasp_lift.env import PadRig, _cube_surface

# a square peg, 15 x 15 x 60 mm, gripped at its centre: its tip reaches
# below the pads, so it can enter the pocket while the pads clear the socket
PEG_HALF = (0.0075, 0.0075, 0.03)


@configclass
class FactoryUipcEnvCfg(DirectRLEnvCfg):
    num_envs: int = 16
    episode_length_s: float = 4.0
    sim_dt: float = 1.0 / 100.0
    decimation: int = 2
    action_space: int = 4  # dx, dy, dz, squeeze rates
    obs_mode: str = "privileged"  # privileged | depth

    # scene
    pad_resolution: tuple = (2, 4, 4)
    tactile_embed: tuple | None = None  # (eh, ew) dense embedded pad surface
    gel_youngs_modulus_mpa: float = 0.1
    gel_poisson_ratio: float = 0.45
    gel_density: float = 1000.0
    peg_density: float = 2000.0
    friction_mu: float = 0.5

    # socket: 4 walls around a square pocket, open to the ground plane
    hole_half_width: float = 0.0095  # 2 mm clearance a side
    socket_half_xy: float = 0.026
    socket_height: float = 0.025
    start_clearance: float = 0.01  # peg bottom above the socket top at the start
    reset_xy_noise: float = 3.0e-3  # gripper start offset the policy must undo

    # gripper kinematics (m/s per action unit)
    move_rate: float = 2.0e-2
    squeeze_rate: float = 5.0e-3
    max_squeeze: float = 3.0e-3
    max_xy: float = 0.012  # mount travel box
    z_range: tuple = (-0.032, 0.015)  # mount z offset from the start pose

    # task
    success_depth: float = 0.008  # peg tip this far below the socket top
    success_xy_tol: float = 2.5e-3
    drop_dist: float = 0.05  # peg this far from the mount: lost

    # solver
    newton_iters: int = 6
    cg_iters: int = 24
    coupling_k: int = 4
    d_hat: float = 1.0e-3
    kappa: float = 1.0e4

    # rewards (Factory keypoint squash pair)
    kp_coef: tuple = (100.0, 5.0)
    kp_scale: tuple = (1.0, 2.0)
    w_engage: float = 1.0
    w_success: float = 5.0
    w_action_rate: float = 0.01
    w_drop: float = 10.0
    stagger_initial_episodes: bool = True
    log_broad_phase_overflow: bool = True


@dataclasses.dataclass(frozen=True)
class FactoryUipcState:
    gel: SoftBodyState
    peg: AbdState  # B = 1
    mount: torch.Tensor  # (N, 3) gripper translation from the build pose
    squeeze: torch.Tensor  # (N,)
    actions: torch.Tensor  # (N, 4)
    prev_actions: torch.Tensor
    episode_length: torch.Tensor  # (N,) int32
    ep_succeeded: torch.Tensor  # (N,) bool


class FactoryUipcEnv(DirectRLEnv):
    """Two FEM gel pads, a free affine peg and a socket in one contact world."""

    cfg: FactoryUipcEnvCfg

    def __init__(self, cfg: FactoryUipcEnvCfg | None = None, device=DEFAULT_DEVICE):
        cfg = cfg or FactoryUipcEnvCfg()
        super().__init__(cfg, device=device)
        c, dev = cfg, self.device
        if c.obs_mode not in ("privileged", "depth"):
            raise ValueError(f"unknown obs_mode {c.obs_mode!r}")
        # build pose: the socket at the origin, the gripper centred above it
        self._z0 = c.socket_height + c.start_clearance + PEG_HALF[2]
        self.rig = PadRig(c, self._z0, dev)
        self.gel = self.rig.gel
        # the peg's body frame is centred at its own origin; reset places it
        pts, tris = _cube_surface(1.0)
        pts = pts * np.asarray(PEG_HALF)
        self.peg = AbdModel([pts], [tris], mass_density=c.peg_density, kappa_ortho=1e7, cfg=self.rig.abd_cfg(c),
                            device=dev)
        self.world = CoupledModel(self.gel, self.peg, cross_k=c.coupling_k)

        # the socket: 4 walls (identity orientation) overlapping at the corners
        hw, so, hz = c.hole_half_width, c.socket_half_xy, c.socket_height / 2
        tx = (so - hw) / 2  # x-wall half thickness
        walls = [
            ((+(hw + tx), 0.0, hz), (tx, so, hz)),
            ((-(hw + tx), 0.0, hz), (tx, so, hz)),
            ((0.0, +(hw + tx), hz), (hw, tx, hz)),
            ((0.0, -(hw + tx), hz), (hw, tx, hz)),
        ]
        boxes = np.zeros((len(walls), 10), np.float32)
        for i, (ctr, half) in enumerate(walls):
            boxes[i, :3], boxes[i, 3:7], boxes[i, 7:10] = ctr, (1.0, 0.0, 0.0, 0.0), half
        sc = RigidSdfScene.empty(c.num_envs, b=len(walls), device=dev)
        self.scene = dataclasses.replace(
            sc,
            boxes=torch.as_tensor(boxes, device=dev).expand_as(sc.boxes).contiguous(),
            planes=torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev).expand_as(sc.planes).contiguous(),  # ground z = 0
        )
        self._hole_top_z = c.socket_height
        self._tip_target = torch.tensor([0.0, 0.0, c.socket_height - c.success_depth], device=dev)
        self._tip_offset = torch.tensor([0.0, 0.0, PEG_HALF[2]], device=dev)
        self._z0_vec = torch.tensor([0.0, 0.0, self._z0], device=dev)
        self._x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
        self._q_identity = AbdState.identity(c.num_envs, 1, device=dev).q  # (N, 1, 12)

    # ------------------------------------------------------------------ state
    def init_state(self) -> FactoryUipcState:
        n, dev = self.cfg.num_envs, self.device
        z4 = torch.zeros((n, 4), device=dev)
        return FactoryUipcState(
            gel=SoftBodyState.init(n, self.rig.union.points, device=dev),
            peg=AbdState.identity(n, 1, device=dev),
            mount=torch.zeros((n, 3), device=dev), squeeze=torch.zeros((n,), device=dev),
            actions=z4, prev_actions=z4.clone(),
            episode_length=torch.zeros((n,), dtype=torch.int32, device=dev),
            ep_succeeded=torch.zeros((n,), dtype=torch.bool, device=dev),
        )

    def reset_all(self, state: FactoryUipcState):
        c = self.cfg
        state = self._reset_where(state, torch.ones((c.num_envs,), dtype=torch.bool, device=self.device))
        if c.stagger_initial_episodes:
            ep0 = torch.randint(0, c.max_episode_length, (c.num_envs,), generator=self.generator,
                                device=self.device, dtype=torch.int32)
            state = dataclasses.replace(state, episode_length=ep0)
        return state, self._observations(state)

    def _reset_where(self, state: FactoryUipcState, mask: torch.Tensor) -> FactoryUipcState:
        n = self.cfg.num_envs
        b = self.cfg.reset_xy_noise
        # the gripper's (and the peg's) start offset carries the per-env randomisation
        xy = torch.rand((n, 2), generator=self.generator, device=self.device) * (2.0 * b) - b
        mount0 = torch.cat([xy, torch.zeros_like(xy[:, :1])], -1)
        m1, m2 = mask[:, None], mask[:, None, None]
        q0 = self._q_identity
        q0 = torch.cat([q0[..., :3] + (mount0 + self._z0_vec)[:, None, :], q0[..., 3:]], -1)
        peg = AbdState(q=torch.where(m2, q0, state.peg.q), qd=torch.where(m2, 0.0, state.peg.qd))
        gel0 = self.rig.rest_points[None] + mount0[:, None, :]
        gel = SoftBodyState(x=torch.where(m2, gel0, state.gel.x), v=torch.where(m2, 0.0, state.gel.v))
        return FactoryUipcState(
            gel=gel, peg=peg, mount=torch.where(m1, mount0, state.mount),
            squeeze=torch.where(mask, 0.0, state.squeeze),
            actions=torch.where(m1, 0.0, state.actions), prev_actions=torch.where(m1, 0.0, state.prev_actions),
            episode_length=torch.where(mask, 0, state.episode_length),
            ep_succeeded=torch.where(mask, False, state.ep_succeeded),
        )

    # ------------------------------------------------------------------- step
    def _aim_positions(self, mount: torch.Tensor, squeeze: torch.Tensor) -> torch.Tensor:
        """Mount targets (N, Va, 3): rest + the gripper's translation, the pads
        moved inward by squeeze."""
        inward = -self.rig.mount_sgn[None, :, None] * squeeze[:, None, None]
        return self.rig.mount_rest[None] + (mount[:, None, :] + inward * self._x_axis)

    def _pad_compression(self, gel_x: torch.Tensor, mount: torch.Tensor, squeeze: torch.Tensor) -> torch.Tensor:
        """(N, 2, gh, gw) inner-face compression (mm): the rigid motion to take
        off is the mount's x translation and the squeeze."""
        return self.rig.compression(gel_x, mount[:, 0, None] - self.rig.pad_sgn[None, :] * squeeze[:, None])

    def step(self, state: FactoryUipcState, action: torch.Tensor):
        c = self.cfg
        action = torch.clamp(torch.nan_to_num(action), -1.0, 1.0)
        prev_actions = state.actions
        gel, peg, mount, squeeze = state.gel, state.peg, state.mount, state.squeeze
        for _ in range(c.decimation):
            mount = mount + action[:, :3] * c.move_rate * c.sim_dt
            mount = torch.stack(
                [
                    torch.clamp(mount[:, 0], -c.max_xy, c.max_xy),
                    torch.clamp(mount[:, 1], -c.max_xy, c.max_xy),
                    torch.clamp(mount[:, 2], c.z_range[0], c.z_range[1]),
                ],
                -1,
            )
            squeeze = torch.clamp(squeeze + action[:, 3] * c.squeeze_rate * c.sim_dt, 0.0, c.max_squeeze)
            gel, peg = self.world.step(gel, peg, self.scene, aim_pos=self._aim_positions(mount, squeeze))

        peg_pos = peg.q[:, 0, :3]
        peg_tip = peg_pos - self._tip_offset
        grip = self._pad_compression(gel.x, mount, squeeze).mean((2, 3))  # (N, 2)
        state = FactoryUipcState(
            gel=gel, peg=peg, mount=mount, squeeze=squeeze, actions=action, prev_actions=prev_actions,
            episode_length=state.episode_length + 1, ep_succeeded=state.ep_succeeded,
        )

        # rewards: the Factory keypoint squash pair on the tip-to-target distance
        d = torch.linalg.vector_norm(peg_tip - self._tip_target, dim=-1)

        def squash(x, a, b):
            return 1.0 / (torch.exp(a * x) + b + torch.exp(-a * x))

        r_kp = c.kp_scale[0] * squash(d, c.kp_coef[0], 2.0) + c.kp_scale[1] * squash(d, c.kp_coef[1], 2.0)
        tip_xy = torch.linalg.vector_norm(peg_tip[:, :2], dim=-1)
        engaged = (peg_tip[:, 2] < self._hole_top_z) & (tip_xy < c.hole_half_width)
        r_engage = c.w_engage * engaged.float()
        success = (peg_tip[:, 2] < self._hole_top_z - c.success_depth) & (tip_xy < c.success_xy_tol)
        r_success = c.w_success * success.float()
        dropped = torch.linalg.vector_norm(peg_pos - (mount + self._z0_vec), dim=-1) > c.drop_dist
        r_drop = -c.w_drop * dropped.float()
        act_rate = -c.w_action_rate * ((action - prev_actions) ** 2).sum(-1)
        reward = r_kp + r_engage + r_success + r_drop + act_rate

        state = dataclasses.replace(state, ep_succeeded=state.ep_succeeded | success)
        terminated = dropped
        truncated = state.episode_length >= c.max_episode_length
        done = terminated | truncated

        log = {
            "kp_reward": r_kp.mean(),
            "engage_reward": r_engage.mean(),
            "success_reward": r_success.mean(),
            "drop_penalty": r_drop.mean(),
            "Metric/peg_tip_z_mm": (peg_tip[:, 2] * 1e3).mean(),
            "Metric/engaged_rate": engaged.float().mean(),
            "Metric/success_rate": success.float().mean(),
            "Metric/grip_mm": grip.amin(-1).mean(),
        }
        if c.log_broad_phase_overflow:
            log["Metric/missed_barriers"] = self.world.missed_barriers(gel.x, peg.q).sum().float()
        info = {"log": log, "peg_tip": peg_tip, "grip": grip}

        state = self._reset_where(state, done)
        return state, self._observations(state), reward, terminated, truncated, info

    # ------------------------------------------------------------------- obs
    def _observations(self, state: FactoryUipcState):
        comp = self._pad_compression(state.gel.x, state.mount, state.squeeze)
        peg_tip = state.peg.q[:, 0, :3] - self._tip_offset
        proprio = torch.cat(
            [
                (peg_tip - self._tip_target) * 1e2,
                state.peg.qd[:, 0, :3],
                state.mount * 1e2,
                state.squeeze[:, None] * 1e3,
                comp.mean((2, 3)),
                state.actions,
            ],
            -1,
        )  # 16-dim
        if self.cfg.obs_mode == "privileged":
            return {"proprio_obs": proprio}
        return {"proprio_obs": proprio, "vision_obs": comp.permute(0, 2, 3, 1)}
