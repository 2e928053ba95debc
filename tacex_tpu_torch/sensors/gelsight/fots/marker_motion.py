"""FOTS marker-motion simulation, batched (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/fots/marker_motion.py``: three
closed-form Gaussian-damped displacement fields (normal-load dilation, shear,
twist) over a regular marker grid, evaluated for the whole env batch at once.
The reference's quirks are kept on purpose: the twist uses ``cos(theta - 1)``,
marker sampling truncates to int, and the shear centre and magnitude use
``floor`` and ``trunc``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ....core.config import configclass


@configclass
class FOTSMarkerCfg:
    """Marker-field configuration (defaults = reference
    fots/fots_marker_sim_cfg.py:15-76: 11x9 grid, λ=[1.25e-3, 2.1e-4, 3.8e-4],
    mm_to_pixel=19.58, image 320x240)."""

    lamb: list = dataclasses.field(default_factory=lambda: [0.00125, 0.00021, 0.00038])
    num_markers_row: int = 11
    num_markers_col: int = 9
    x0: float = 15.0
    y0: float = 26.0
    tactile_img_width: int = 320
    tactile_img_height: int = 240
    mm_to_pixel: float = 19.58
    shear_max_px: float = 10.0
    twist_max_deg: float = 60.0
    marker_dot_radius_px: float = 2.0

    @property
    def num_markers(self) -> int:
        return self.num_markers_row * self.num_markers_col


def init_marker_grid(cfg: FOTSMarkerCfg, device=None) -> torch.Tensor:
    """Initial marker positions (num_markers, 2) as (x, y) pixel coords on an
    int-truncated grid over [x0, W-x0] x [y0, H-y0]."""
    xs = torch.floor(torch.linspace(cfg.x0, cfg.tactile_img_width - cfg.x0, cfg.num_markers_col, device=device))
    ys = torch.floor(torch.linspace(cfg.y0, cfg.tactile_img_height - cfg.y0, cfg.num_markers_row, device=device))
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")  # (rows, cols)
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def marker_sample_index(
    init_markers: torch.Tensor, hw: tuple[int, int], sample_scale: tuple[float, float] = (1.0, 1.0)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, col) int64 indices of each marker on an (h, w) depth grid,
    truncated toward zero and clipped to the grid."""
    h, w = hw
    mx = (init_markers[:, 0] * sample_scale[0]).to(torch.int32).clamp(0, w - 1)
    my = (init_markers[:, 1] * sample_scale[1]).to(torch.int32).clamp(0, h - 1)
    return my.long(), mx.long()


def marker_motion(
    cfg: FOTSMarkerCfg,
    depth_map: torch.Tensor,  # (N, h, w) gel deformation depth (mm, >= 0 inward)
    contact_mask: torch.Tensor,  # (N, h, w) bool
    traj_start: torch.Tensor,  # (N, 3) [x_mm, y_mm, theta_rad] at contact start
    traj_curr: torch.Tensor,  # (N, 3) current relative pose
    traj_valid: torch.Tensor,  # (N,) bool: has a trajectory (>= 2 samples seen)
    init_markers: torch.Tensor,  # (M, 2)
    sample_scale: tuple[float, float] = (1.0, 1.0),
) -> torch.Tensor:
    """Current marker (x, y) positions, (N, M, 2).

    With no contact the markers stay on their initial grid.
    ``sample_scale`` maps marker coordinates onto the depth-map grid.
    """
    h, w = depth_map.shape[-2:]
    lamb = cfg.lamb

    d = depth_map - depth_map.amin(dim=(-2, -1), keepdim=True)
    d = d / 10.0

    my, mx = marker_sample_index(init_markers, (h, w), sample_scale)
    contact_at_m = contact_mask[:, my, mx]  # (N, M)
    height_at_m = d[:, my, mx]  # (N, M)
    any_contact = contact_at_m.any(dim=-1)  # (N,)

    markers = init_markers[None]  # (1, M, 2): the grid is the same for every env

    # Dilation: each contact marker pushes its neighbours radially outward.
    diff = init_markers[:, None, :] - init_markers[None, :, :]  # (M, M, 2)
    g = torch.exp(-lamb[0] * (diff * diff).sum(-1))  # (M, M)
    wgt = torch.where(contact_at_m[:, None, :], height_at_m[:, None, :] * g, 0.0)  # (N, M, M)
    dil = (wgt[..., None] * diff).sum(dim=2)

    img_c = (cfg.tactile_img_width / 2.0, cfg.tactile_img_height / 2.0)

    # Shear: centre at the trajectory start, magnitude = displacement.
    shear_center = torch.stack(
        [torch.floor(traj_start[:, i] * cfg.mm_to_pixel + img_c[i]) for i in range(2)], -1
    )  # (N, 2)
    shear_px = torch.trunc((traj_curr[:, :2] - traj_start[:, :2]) * cfg.mm_to_pixel)
    off = markers - shear_center[:, None, :]
    gs = torch.exp(-lamb[1] * (off * off).sum(-1))  # (N, M)
    shear = torch.clamp(shear_px, -cfg.shear_max_px, cfg.shear_max_px)[:, None, :] * gs[..., None]

    # Twist about the current contact centre; cos(theta - 1) is the reference's.
    twist_center = torch.stack(
        [torch.floor(traj_curr[:, i] * cfg.mm_to_pixel + img_c[i]) for i in range(2)], -1
    )
    theta_max = cfg.twist_max_deg / 180.0 * math.pi
    th = torch.clamp(traj_curr[:, 2] - traj_start[:, 2], -theta_max, theta_max)[:, None]
    off = markers - twist_center[:, None, :]
    gt = torch.exp(-lamb[2] * (off * off).sum(-1))
    ox, oy = off[..., 0], off[..., 1]
    rotx = ox * torch.cos(th - 1.0) - oy * torch.sin(th)
    roty = ox * torch.sin(th) + oy * torch.cos(th - 1.0)
    twist = torch.stack([rotx * gt, roty * gt], dim=-1)

    moved = markers + dil + torch.where(traj_valid[:, None, None], shear + twist, 0.0)
    return torch.where(any_contact[:, None, None], moved, markers)


def draw_marker_image(
    cfg: FOTSMarkerCfg,
    markers: torch.Tensor,  # (N, M, 2) x,y pixel positions
    hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Rasterize markers as anti-aliased dark dots, (N, h, w) in [0, 1].

    The dot intensity ``max(1 - d2 / support, 0) ** 2`` falls as the squared
    distance ``d2`` grows, so its maximum over markers is its value at the
    nearest marker. Taking the minimum of ``d2`` first gives the same numbers
    and keeps one (N, h, w, M) tensor alive, built from separate x and y terms.
    """
    h, w = hw if hw is not None else (cfg.tactile_img_height, cfg.tactile_img_width)
    ys = torch.arange(h, dtype=torch.float32, device=markers.device)
    xs = torch.arange(w, dtype=torch.float32, device=markers.device)
    dy = ys[None, :, None] - markers[:, None, :, 1]  # (N, h, M)
    dx = xs[None, :, None] - markers[:, None, :, 0]  # (N, w, M)
    d2 = (dx * dx)[:, None, :, :] + (dy * dy)[:, :, None, :]  # (N, h, w, M)
    d2min = d2.amin(dim=-1)
    r = cfg.marker_dot_radius_px
    support = 2.5 * r * r
    t = torch.clamp(1.0 - d2min / support, min=0.0)
    return 1.0 - t * t


def marker_flow(init_markers: torch.Tensor, markers: torch.Tensor) -> torch.Tensor:
    """Stack (initial, current) marker positions: (N, 2, M, 2)."""
    return torch.stack([init_markers.expand_as(markers), markers], dim=1)
