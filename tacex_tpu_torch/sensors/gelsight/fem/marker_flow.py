"""FEM-surface marker flow (ManiSkill-ViTac protocol), batched (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/fem/marker_flow.py``: a randomized
marker grid on the gel contact surface, bound once (numpy, at construction)
to surface triangles with barycentric weights, projected into the sensor
camera with pinhole intrinsics, with lose-tracking dropout, pixel noise and
a fixed-size (2, marker_flow_size, 2) flow a step. The per-step path is
tensor ops over all envs: gather, barycentric combine, projection, masked
dropout and noise, and a static-shape random subsample (valid markers
ranked by a random score, invalid ones pushed to the end). Its random
draws come from an explicit ``torch.Generator``, or are passed in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ....core import maths
from ....core.config import configclass
from ....core.device import DEFAULT_DEVICE, resolve


@configclass
class ManiSkillSimulatorCfg:
    """Field names mirror the reference ManiSkillSimulatorCfg
    (fem_based/mani_skill_sim_cfg.py:10-70)."""

    marker_interval_range: tuple = (2.0625, 2.0625)  # mm
    marker_rotation_range: float = 0.0  # rad
    marker_translation_range: tuple = (0.0, 0.0)  # mm
    marker_pos_shift_range: tuple = (0.0, 0.0)  # mm
    marker_random_noise: float = 0.0  # px
    marker_lose_tracking_probability: float = 0.0
    normalize: bool = False
    marker_flow_size: int = 128
    camera_params: tuple = (340.0, 325.0, 160.0, 125.0, 0.0)  # fx, fy, cx, cy, distortion
    tactile_img_res: tuple = (320, 240)


def _generate_marker_grid(cfg: ManiSkillSimulatorCfg, rng: np.random.Generator) -> np.ndarray:
    """Randomized marker grid in the gel plane, meters (reference :189-247)."""
    lo, hi = cfg.marker_interval_range
    interval = rng.random() * (hi - lo) + lo
    rot = 2 * cfg.marker_rotation_range * rng.random() - cfg.marker_rotation_range
    tx = 2 * cfg.marker_translation_range[0] * rng.random() - cfg.marker_translation_range[0]
    ty = 2 * cfg.marker_translation_range[1] * rng.random() - cfg.marker_translation_range[1]

    x_start = -math.ceil((8 + tx) / interval) * interval + tx
    x_end = math.ceil((16.5 - tx) / interval) * interval + tx
    y_start = -math.ceil((6 + ty) / interval) * interval + ty
    y_end = math.ceil((6 - ty) / interval) * interval + ty
    xs = np.linspace(x_start, x_end, round((x_end - x_start) / interval) + 1, True)
    ys = np.linspace(y_start, y_end, round((y_end - y_start) / interval) + 1, True)
    xy = np.array(np.meshgrid(xs, ys)).reshape(2, -1).T
    xy[:, 0] += rng.random(len(xy)) * cfg.marker_pos_shift_range[0] * 2 - cfg.marker_pos_shift_range[0]
    xy[:, 1] += rng.random(len(xy)) * cfg.marker_pos_shift_range[1] * 2 - cfg.marker_pos_shift_range[1]
    rot_mat = np.array([[math.cos(rot), -math.sin(rot)], [math.sin(rot), math.cos(rot)]])
    return (xy @ rot_mat.T) / 1000.0  # mm -> m


def _bind_barycentric(
    marker_xy: np.ndarray,  # (M0, 2) meters, gel plane (camera-frame xy)
    surface_pts: np.ndarray,  # (Vs, 3) rest surface vertices, camera frame
    surface_tris: np.ndarray,  # (S, 3) indices into surface_pts
) -> tuple[np.ndarray, np.ndarray]:
    """Containing triangle (xy projection) and barycentric weights of each
    marker, among the contact-face triangles (all vertices on the far z
    plane), by a brute-force point-in-triangle test. Returns (tri_vert_ids
    (M, 3), weights (M, 3)); markers without a containing triangle are
    dropped."""
    z_far = surface_pts[:, 2].max()
    on_face = np.abs(surface_pts[:, 2] - z_far) < 1e-6
    face_tris = surface_tris[on_face[surface_tris].all(axis=1)]

    p0 = surface_pts[face_tris[:, 0], :2]  # (S, 2)
    e1 = surface_pts[face_tris[:, 1], :2] - p0
    e2 = surface_pts[face_tris[:, 2], :2] - p0
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]  # (S,)
    valid_tri = np.abs(det) > 1e-18

    d = marker_xy[:, None, :] - p0[None, :, :]  # (M0, S, 2)
    w1 = (d[..., 0] * e2[None, :, 1] - d[..., 1] * e2[None, :, 0]) / det[None, :]
    w2 = (e1[None, :, 0] * d[..., 1] - e1[None, :, 1] * d[..., 0]) / det[None, :]
    inside = (w1 >= -1e-9) & (w2 >= -1e-9) & (w1 + w2 <= 1 + 1e-9) & valid_tri[None, :]

    has_tri = inside.any(axis=1)
    tri_idx = inside.argmax(axis=1)
    ids = face_tris[tri_idx]
    w1s = w1[np.arange(len(marker_xy)), tri_idx]
    w2s = w2[np.arange(len(marker_xy)), tri_idx]
    weights = np.stack([1 - w1s - w2s, w1s, w2s], axis=-1)
    return ids[has_tri].astype(np.int32), weights[has_tri].astype(np.float32)


class FemMarkerFlow:
    """Per-topology marker-flow generator over batched FEM surface states."""

    def __init__(
        self,
        cfg: ManiSkillSimulatorCfg,
        rest_surface_camera: np.ndarray,  # (Vs, 3) rest surface verts, camera frame
        surface_tris: np.ndarray,  # (S, 3) indices into the surface array
        seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = cfg
        self.device = dev = resolve(device)
        rng = np.random.default_rng(seed)
        grid = _generate_marker_grid(cfg, rng)
        # recenter the nominal grid onto the gel footprint
        cx = rest_surface_camera[:, 0].mean()
        cy = rest_surface_camera[:, 1].mean()
        grid = grid - grid.mean(axis=0) + np.array([cx, cy])
        ids, w = _bind_barycentric(grid, rest_surface_camera, surface_tris)
        self.tri_ids = torch.as_tensor(ids.astype(np.int64), device=dev)  # (M, 3)
        self.weights = torch.as_tensor(w, device=dev)  # (M, 3)
        self.num_bound = len(ids)
        rest = torch.as_tensor(np.asarray(rest_surface_camera, np.float32), device=dev)
        self.init_pts = (rest[self.tri_ids] * self.weights[..., None]).sum(dim=1)  # (M, 3)
        self._init_uv = self._project(self.init_pts)  # (M, 2)
        self._pos = torch.arange(cfg.marker_flow_size, device=dev)

    def _project(self, pts: torch.Tensor) -> torch.Tensor:
        """Pinhole projection (..., M, 3) -> (..., M, 2) pixel uv
        (reference gen_marker_uv: u = fx x/z + cx, v = fy y/z + cy)."""
        fx, fy, cx, cy, _ = self.cfg.camera_params
        z = torch.clamp(pts[..., 2], min=1e-6)
        return torch.stack([fx * pts[..., 0] / z + cx, fy * pts[..., 1] / z + cy], dim=-1)

    def draws(self, n: int, generator: torch.Generator | None = None) -> dict:
        """The step's random draws for ``n`` envs: the keep test's uniforms,
        the pixel noise and the subsample scores."""
        m = self.num_bound
        kw = dict(generator=generator, device=self.device)
        return {
            "keep": torch.rand((n, m), **kw),
            "noise": torch.randn((n, 2, m, 2), **kw),
            "score": torch.rand((n, m), **kw),
        }

    def flow(self, surface_camera: torch.Tensor, generator: torch.Generator | None = None,
             draws: dict | None = None) -> torch.Tensor:
        """Marker flow of a batch of surface states.

        Args:
          surface_camera: (N, Vs, 3) current surface vertices in camera frame.
          generator: the source of the random draws, unless ``draws`` (as
            ``FemMarkerFlow.draws`` gives them) is passed.
        Returns: (N, 2, marker_flow_size, 2) [init_uv, curr_uv].
        """
        cfg = self.cfg
        n = surface_camera.shape[0]
        m = self.num_bound
        w_img, h_img = cfg.tactile_img_res
        if draws is None:
            draws = self.draws(n, generator)

        corners = surface_camera.index_select(1, self.tri_ids.reshape(-1)).unflatten(1, (m, 3))  # (N, M, 3, 3)
        curr_uv = self._project((corners * self.weights[None, ..., None]).sum(dim=2))  # (N, M, 2)
        init_uv = self._init_uv.expand(n, m, 2)

        # in-bounds mask on the initial uv (reference convention :383-388)
        in_bounds = (init_uv[..., 0] > 5) & (init_uv[..., 0] < w_img) & (init_uv[..., 1] > 5) & (init_uv[..., 1] < h_img)
        valid = in_bounds & (draws["keep"] > cfg.marker_lose_tracking_probability)

        flow = torch.stack([init_uv, curr_uv], dim=1)  # (N, 2, M, 2)
        flow = flow + cfg.marker_random_noise * draws["noise"]

        # static-shape subsample of the valid markers: rank by the random
        # score with the invalid ones pushed to the end, take the first K
        # (equal in distribution to choice without replacement)
        order = torch.argsort(draws["score"] + (~valid) * 10.0, dim=-1, stable=True)  # (N, M)
        k = cfg.marker_flow_size
        take = order[:, :k] if m >= k else torch.cat([order, order[:, -1:].expand(n, k - m)], dim=1)
        picked = torch.gather(flow, 2, take[:, None, :, None].expand(n, 2, k, 2))
        # pad: past the valid markers, repeat the last valid one
        last_valid = torch.clamp(valid.sum(dim=-1) - 1, 0, k - 1)  # (N,)
        src = torch.minimum(self._pos[None, :], last_valid[:, None])  # (N, k)
        picked = torch.gather(picked, 2, src[:, None, :, None].expand(n, 2, k, 2))
        if cfg.normalize:
            picked = picked / (w_img / 2.0) - 1.0
        return picked


def surface_to_camera_frame(
    surface_world: torch.Tensor,  # (N, Vs, 3)
    cam_pos: torch.Tensor,  # (N, 3)
    cam_quat: torch.Tensor,  # (N, 4) +z forward
) -> torch.Tensor:
    """World -> camera frame for batched surface vertices."""
    return maths.quat_apply_inverse(cam_quat[:, None, :], surface_world - cam_pos[:, None, :])
