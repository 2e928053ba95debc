"""Taxim calibration data loading (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/taxim/calib.py``: the polynomial
gradient LUT is stacked back in RGB order and scaled to [0, 1]; the gel rest
height map is blurred, scaled by ``pixmm`` and shifted to a maximum of zero;
the background frame is synthesized (the shipped calibration has no
``dataPack.npz``: three LEDs over a gray gel) and denoised; the ragged
per-(direction, height) shadow attenuation lists are padded with +inf into a
dense table whose extra height row is all-inf (the out-of-range sentinel),
and each direction is fanned into its ray angles. The files are read from
the JAX package's asset folder by path; nothing of that package is
imported.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ....ops.blur import gaussian_blur
from ....ops.resize import resize_linear
from .params import SensorParams, SimParams, load_params

DEFAULT_CALIB_GELSIGHT_MINI = (
    Path(__file__).resolve().parents[4] / "tacex_tpu" / "assets" / "gelsight_mini" / "calibs" / "640x480"
)
SHADOW_DEPTH_0 = 0.4  # mm; shadow table depth origin
SHADOW_HEIGHT_IDX_OFFSET = 6


def default_calib_folder() -> Path:
    if not DEFAULT_CALIB_GELSIGHT_MINI.is_dir():
        raise FileNotFoundError(f"calibration folder {DEFAULT_CALIB_GELSIGHT_MINI} is missing")
    return DEFAULT_CALIB_GELSIGHT_MINI


def _features(sensor_params: SensorParams, shape: tuple[int, int]) -> np.ndarray:
    """Quadratic pixel-coordinate features (h, w, 6) in full-res units."""
    h, w = shape
    full_h, full_w = sensor_params.height, sensor_params.width
    yy, xx = np.meshgrid(
        np.linspace(0, full_h, h, endpoint=False, dtype=np.float32),
        np.linspace(0, full_w, w, endpoint=False, dtype=np.float32),
        indexing="ij",
    )
    return np.stack([xx * xx, yy * yy, xx * yy, xx, yy, np.ones_like(xx)], axis=-1)


@dataclasses.dataclass(frozen=True)
class TaximCalib:
    """Calibration tensors at a fixed working resolution ``(h, w)``."""

    poly_lut: torch.Tensor  # (num_bins*num_bins, 6, 3) float32, RGB
    gel_map: torch.Tensor  # (h, w) float32, mm, max-normalized to 0
    background: torch.Tensor  # (h, w, 3) float32 in [0, 1]
    features: torch.Tensor  # (6, h*w) float32: _features at (h, w), transposed
    shadow_fan_angles: torch.Tensor  # (num_dirs, num_fan_rays) float32, radians
    shadow_table: torch.Tensor  # (num_dirs, num_heights+1, max_len, 3) float32
    gel_map_shift: float
    sim_params: SimParams
    sensor_params: SensorParams

    @property
    def resolution(self) -> tuple[int, int]:
        return tuple(self.gel_map.shape)  # (h, w)

    def at_resolution(self, hw: tuple[int, int]) -> "TaximCalib":
        """Gel map and background resized to ``(h, w)`` the way
        ``jax.image.resize(method="linear")`` does (antialiased when it
        downsamples)."""
        h, w = int(hw[0]), int(hw[1])
        if (h, w) == self.resolution:
            return self
        feats = torch.from_numpy(_features(self.sensor_params, (h, w)).reshape(h * w, 6).T.copy())
        return dataclasses.replace(
            self,
            gel_map=resize_linear(self.gel_map, (h, w)),
            background=resize_linear(self.background, (h, w, 3)),
            features=feats.to(self.gel_map.device),
        )

    def to(self, device) -> "TaximCalib":
        return dataclasses.replace(
            self,
            poly_lut=self.poly_lut.to(device),
            gel_map=self.gel_map.to(device),
            background=self.background.to(device),
            features=self.features.to(device),
            shadow_fan_angles=self.shadow_fan_angles.to(device),
            shadow_table=self.shadow_table.to(device),
        )


def _synthesize_background(h: int, w: int) -> np.ndarray:
    """Plausible GelSight Mini resting frame: three LEDs (R, G, B) from three
    sides over a gray gel, with gentle vignetting."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = 0.42
    r = base + 0.10 * (1.0 - xx) - 0.03 * yy
    g = base + 0.10 * xx - 0.03 * yy
    b = base + 0.10 * yy
    img = np.stack([r, g, b], axis=-1)
    d2 = (yy - 0.5) ** 2 + (xx - 0.5) ** 2
    img *= (1.0 - 0.25 * d2 / d2.max())[..., None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _process_initial_frame(f0: torch.Tensor, sim_params: SimParams) -> torch.Tensor:
    """Blend the blurred frame in wherever it differs little from the frame."""
    f0_blur = gaussian_blur(f0, sim_params.initial_frame_sigma(tuple(f0.shape[:2])))
    diff = (f0_blur - f0).abs().mean(dim=-1, keepdim=True)
    fmp = sim_params.frame_mixing_percentage
    mixed = fmp * f0_blur + (1.0 - fmp) * f0
    return torch.where(diff < sim_params.diff_threshold / 255.0, mixed, f0)


def _load_shadow_table(folder: Path, sim_params: SimParams) -> tuple[np.ndarray, np.ndarray]:
    """(fan angles (dirs, rays), dense table (dirs, heights+1, max_len, 3))
    from ``shadowTable.npz``, RGB order, scaled to [0, 1]."""
    # the table is an object array of ragged lists written by this project
    shadow = np.load(folder / "shadowTable.npz", allow_pickle=True)
    directions = np.asarray(shadow["shadowDirections"], np.float32)  # (num_dirs,)
    fan_angle = sim_params.fan_angle
    num_fan_rays = int(fan_angle * 2 / sim_params.fan_precision)
    fan = directions[:, None] + np.linspace(-fan_angle, fan_angle, num_fan_rays, dtype=np.float32)

    table = np.flip(shadow["shadowTable"], axis=0)  # (3, dirs, heights) ragged lists, BGR -> RGB
    n_ch, n_dir, n_h = table.shape
    max_len = max(max((len(e) for e in table.reshape(-1)), default=1), 1)
    dense = np.full((n_ch, n_dir, n_h + 1, max_len), np.inf, dtype=np.float32)
    for c in range(n_ch):
        for d in range(n_dir):
            for hh in range(n_h):
                e = table[c, d, hh]
                if len(e):
                    dense[c, d, hh, : len(e)] = np.asarray(e, np.float32)
    dense /= 255.0
    return fan.astype(np.float32), np.ascontiguousarray(np.moveaxis(dense, 0, -1))


def load_calib(
    calib_folder: Path | str | None = None,
    param_overrides: dict[str, dict[str, Any]] | None = None,
) -> TaximCalib:
    """Load a calibration folder at its native resolution, on the CPU.

    Chain ``.at_resolution(hw).to(device)`` to get the working calibration.
    """
    folder = Path(calib_folder) if calib_folder is not None else default_calib_folder()
    sim_params, sensor_params = load_params(folder, param_overrides)

    # polynomial LUT: grad_b / grad_r are swapped on disk
    data = np.load(folder / "polycalib.npz")
    poly = np.stack([data["grad_b"], data["grad_g"], data["grad_r"]], axis=-1) / 255.0
    nb = sensor_params.num_bins
    if poly.shape != (nb, nb, 6, 3):
        raise ValueError(f"polycalib.npz holds a {poly.shape} LUT, expected {(nb, nb, 6, 3)}")
    poly_lut = torch.from_numpy(poly.reshape(nb * nb, 6, 3).astype(np.float32))

    # gel rest height map: blur, scale to mm, normalize max -> 0
    gel = np.load(folder / "gelmap.npy").astype(np.float32)
    gel_t = gaussian_blur(torch.from_numpy(gel), sim_params.deform_final_sigma(gel.shape)) * sensor_params.pixmm
    gel_map_shift = float(gel_t.max())
    gel_map = gel_t - gel_map_shift

    h, w = gel.shape
    background = _process_initial_frame(torch.from_numpy(_synthesize_background(h, w)), sim_params)

    feats = torch.from_numpy(_features(sensor_params, (h, w)).reshape(h * w, 6).T.copy())
    fan, shadow_table = _load_shadow_table(folder, sim_params)
    return TaximCalib(
        poly_lut=poly_lut,
        gel_map=gel_map,
        background=background,
        features=feats,
        shadow_fan_angles=torch.from_numpy(fan),
        shadow_table=torch.from_numpy(shadow_table),
        gel_map_shift=gel_map_shift,
        sim_params=sim_params,
        sensor_params=sensor_params,
    )

