"""GelSightSensor: batched tactile sensor (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/sensor.py``. ``update`` maps
``(state, camera depth) -> (state, outputs)`` for the whole env batch with
tensor ops only: it reads nothing back to the host, so a step never waits
on the card. Outputs carry a leading ``num_envs`` axis:

  height_map     (N, h, w)        mm, camera resolution
  camera_depth   (N, h, w, 1)     m
  tactile_rgb    (N, H, W, 3)     float in [0, 1], tactile resolution
  marker_motion  (N, 2, M, 2)     initial/current marker (x, y) pixel coords
  indentation_depth (N,)          mm

The gel deformation is computed once per frame and shared by the optical
and marker paths.
"""

from __future__ import annotations

import dataclasses

import torch

from ...ops.resize import resize_linear
from .fots import marker_motion as fots
from .sensor_cfg import GelSightSensorCfg
from .taxim import calib as taxim_calib
from .taxim import optical as taxim_optical


@dataclasses.dataclass(frozen=True)
class GelSightSensorState:
    """Per-env FOTS trajectory state: the first and the latest in-contact
    samples and the count of consecutive in-contact frames."""

    traj_start: torch.Tensor  # (N, 3): [x_mm, y_mm, theta] at first contact
    traj_curr: torch.Tensor  # (N, 3): latest sample
    traj_count: torch.Tensor  # (N,) int32

    @staticmethod
    def init(num_envs: int, device=None) -> "GelSightSensorState":
        z = torch.zeros((num_envs, 3), device=device)
        return GelSightSensorState(z, z.clone(), torch.zeros((num_envs,), dtype=torch.int32, device=device))


class GelSightSensor:
    """Holds static config and calibration on ``device``; ``update`` and
    ``reset`` return new state and leave their inputs alone."""

    def __init__(self, cfg: GelSightSensorCfg, num_envs: int, device="cpu"):
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = torch.device(device)

        self.camera_res = tuple(cfg.sensor_camera_cfg.resolution)  # (w, h)
        ocfg = cfg.optical_sim_cfg
        self._optical_enabled = ocfg is not None and "tactile_rgb" in cfg.data_types
        self._markers_enabled = cfg.marker_motion_sim_cfg is not None and "marker_motion" in cfg.data_types

        if ocfg is not None:
            if ocfg.with_shadow:
                raise NotImplementedError("the shadow pass is not ported yet")
            folder = ocfg.calib_folder_path or None
            self.tactile_res = tuple(ocfg.tactile_img_res)  # (w, h)
            th, tw = self.tactile_res[1], self.tactile_res[0]
            self.calib = taxim_calib.load_calib(folder).at_resolution((th, tw)).to(self.device)
        else:
            self.tactile_res = self.camera_res
            self.calib = None

        if cfg.marker_motion_sim_cfg is not None:
            self.marker_cfg = cfg.marker_motion_sim_cfg.to_marker_cfg()
            self.init_markers = fots.init_marker_grid(self.marker_cfg, device=self.device)
        else:
            self.marker_cfg = None
            self.init_markers = None

    # ------------------------------------------------------------------ state
    def init_state(self) -> GelSightSensorState:
        return GelSightSensorState.init(self.num_envs, self.device)

    def reset(self, state: GelSightSensorState, env_mask: torch.Tensor) -> GelSightSensorState:
        """Clear trajectory state where ``env_mask`` is True."""
        m = env_mask[:, None]
        return GelSightSensorState(
            traj_start=torch.where(m, 0.0, state.traj_start),
            traj_curr=torch.where(m, 0.0, state.traj_curr),
            traj_count=torch.where(env_mask, 0, state.traj_count),
        )

    # ------------------------------------------------------------- main update
    def height_map_from_depth(self, camera_depth_m: torch.Tensor) -> torch.Tensor:
        """Depth (m) -> height map (mm), non-finite values clipped to the far
        plane."""
        far = self.cfg.sensor_camera_cfg.clipping_range[1]
        hm = torch.where(torch.isfinite(camera_depth_m), camera_depth_m, far)
        hm = torch.clamp(hm, 0.0, far)
        return hm * 1000.0

    def compute_indentation_depth(self, height_map_mm: torch.Tensor) -> torch.Tensor:
        """(N,) indentation depth in mm."""
        ocfg = self.cfg.optical_sim_cfg
        hm_m = height_map_mm / 1000.0
        min_dist = hm_m.amin(dim=(-2, -1))
        dist = torch.clamp(min_dist - ocfg.gelpad_to_camera_min_distance, min=0.0)
        return torch.where(dist <= ocfg.gelpad_height, (ocfg.gelpad_height - dist) * 1000.0, 0.0)

    def update(
        self,
        state: GelSightSensorState,
        camera_depth_m: torch.Tensor,  # (N, h, w) meters
        obj_yaw: torch.Tensor | None = None,  # (N,) object yaw relative to sensor
        obj_pos_mm: torch.Tensor | None = None,  # (N, 2) object xy in sensor frame (mm)
    ) -> tuple[GelSightSensorState, dict[str, torch.Tensor]]:
        """One sensor frame.

        ``obj_pos_mm`` selects the frame-transformer FOTS variant: the marker
        trajectory's contact centre comes from the tracked object's pose in
        the sensor frame instead of the contact-mask centroid."""
        n = camera_depth_m.shape[0]
        out: dict[str, torch.Tensor] = {}

        height_map = self.height_map_from_depth(camera_depth_m)
        if "camera_depth" in self.cfg.data_types:
            out["camera_depth"] = camera_depth_m[..., None]
        if "height_map" in self.cfg.data_types:
            out["height_map"] = height_map

        if self.cfg.optical_sim_cfg is not None:
            indent = self.compute_indentation_depth(height_map)
            out["indentation_depth"] = indent

        if not (self._optical_enabled or self._markers_enabled):
            return state, out

        th, tw = self.tactile_res[1], self.tactile_res[0]
        hm_t = height_map
        if tuple(hm_t.shape[-2:]) != (th, tw):
            hm_t = resize_linear(hm_t, (n, th, tw))

        shifted = taxim_optical.shift_height_map(hm_t, indent)
        deformed, contact_mask = taxim_optical.compute_gel_deformation(self.calib, shifted)

        if self._optical_enabled:
            deformed_px = deformed / self.calib.sensor_params.pixmm
            grad_mag, grad_dir = taxim_optical.generate_normals(self.calib, -deformed_px)
            raw = taxim_optical.shade(self.calib, grad_mag, grad_dir)
            out["tactile_rgb"] = torch.clamp(raw + self.calib.background, 0.0, 1.0)

        if self._markers_enabled:
            in_contact = indent > 0.0
            # marker coordinates live at the marker cfg's nominal resolution
            mcfg = self.marker_cfg
            sx = mcfg.tactile_img_width / tw
            sy = mcfg.tactile_img_height / th
            if obj_pos_mm is not None:
                cx_mm = obj_pos_mm[:, 0]
                cy_mm = obj_pos_mm[:, 1]
            else:
                rows = torch.arange(th, dtype=torch.float32, device=self.device)[:, None]
                cols = torch.arange(tw, dtype=torch.float32, device=self.device)[None, :]
                denom = torch.clamp(contact_mask.sum(dim=(-2, -1)), min=1)
                cy = (contact_mask * rows).sum(dim=(-2, -1)) / denom * sy
                cx = (contact_mask * cols).sum(dim=(-2, -1)) / denom * sx
                cx_mm = (cx - mcfg.tactile_img_width / 2.0) / mcfg.mm_to_pixel
                cy_mm = (cy - mcfg.tactile_img_height / 2.0) / mcfg.mm_to_pixel
            theta = obj_yaw if obj_yaw is not None else torch.zeros_like(cx_mm)
            sample = torch.stack([cx_mm, cy_mm, theta], dim=-1)

            first_contact = in_contact & (state.traj_count == 0)
            traj_start = torch.where(first_contact[:, None], sample, state.traj_start)
            traj_curr = torch.where(in_contact[:, None], sample, state.traj_curr)
            traj_count = torch.where(in_contact, state.traj_count + 1, 0)
            traj_valid = traj_count >= 2

            # FOTS reads the inverted deformation
            depth_for_markers = deformed.amax(dim=(-2, -1), keepdim=True) - deformed
            markers = fots.marker_motion(
                mcfg,
                depth_for_markers,
                contact_mask,
                traj_start,
                traj_curr,
                traj_valid,
                self.init_markers,
                sample_scale=(1.0 / sx, 1.0 / sy),
            )
            out["marker_motion"] = fots.marker_flow(self.init_markers, markers)
            state = GelSightSensorState(traj_start, traj_curr, traj_count)

        return state, out
