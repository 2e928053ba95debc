"""Taxim calibration parameters.

Loads ``params.json`` from a calibration folder into typed, frozen parameter
objects. Parameter semantics follow the reference exactly (reference
source/tacex/.../gpu_taxim/sim/taxim_impl.py:17-63): every ``*_rel`` entry is
stored as a pair ``(w_rel, h_rel)`` and scales with the working image shape —
``value(shape) = (w_rel * shape[1], h_rel * shape[0])`` — so the simulation is
resolution independent.

Here the scaling is explicit methods (no ``__getattr__`` magic): each returns
concrete static Python floats, so downstream jit traces see constants.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from ....core.config import update_recursive


@dataclass(frozen=True)
class SensorParams:
    w: int
    h: int
    pixmm: float
    num_bins: int

    @property
    def width(self) -> int:
        return self.w

    @property
    def height(self) -> int:
        return self.h


def _scale(value, shape: tuple[int, int]) -> tuple:
    """(w_rel, h_rel) -> (w_rel * W, h_rel * H); supports nested tuples."""
    w_val, h_val = value[0], value[1]
    w_out = tuple(e * shape[1] for e in w_val) if isinstance(w_val, (tuple, list)) else w_val * shape[1]
    h_out = tuple(e * shape[0] for e in h_val) if isinstance(h_val, (tuple, list)) else h_val * shape[0]
    return w_out, h_out


@dataclass(frozen=True)
class SimParams:
    initial_frame_sigma_rel: tuple
    frame_mixing_percentage: float
    diff_threshold: float
    contact_scale: float
    deform_pyramid_sigma_rel: tuple
    shadow_blur_sigma_rel: tuple
    deform_final_sigma_rel: tuple
    shadow_step_rel: tuple
    height_precision: float
    discretize_precision: float
    fan_angle: float
    fan_precision: float
    shadow_attachment_kernel_size_rel: tuple

    def initial_frame_sigma(self, shape: tuple[int, int]) -> tuple[float, float]:
        return _scale(self.initial_frame_sigma_rel, shape)

    def deform_pyramid_sigma(self, shape: tuple[int, int]) -> list[tuple[float, float]]:
        sx, sy = _scale(self.deform_pyramid_sigma_rel, shape)
        return list(zip(sx, sy))

    def deform_final_sigma(self, shape: tuple[int, int]) -> tuple[float, float]:
        return _scale(self.deform_final_sigma_rel, shape)

    def shadow_blur_sigma(self, shape: tuple[int, int]) -> tuple[float, float]:
        return _scale(self.shadow_blur_sigma_rel, shape)

    def shadow_step(self, shape: tuple[int, int]) -> tuple[float, float]:
        return _scale(self.shadow_step_rel, shape)

    def shadow_attachment_kernel_size(self, shape: tuple[int, int]) -> tuple[float, float]:
        return _scale(self.shadow_attachment_kernel_size_rel, shape)


def _tuplify(obj: Any) -> Any:
    if isinstance(obj, list):
        return tuple(_tuplify(i) for i in obj)
    if isinstance(obj, dict):
        return {k: _tuplify(v) for k, v in obj.items()}
    return obj


def load_params(
    calib_folder: Path | str, overrides: dict[str, dict[str, Any]] | None = None
) -> tuple[SimParams, SensorParams]:
    """Load (and optionally override) ``params.json`` from ``calib_folder``."""
    calib_folder = Path(calib_folder)
    with (calib_folder / "params.json").open() as f:
        raw = json.load(f)
    raw = update_recursive(raw, overrides)
    sim = SimParams(**_tuplify(raw["simulator"]))
    sensor = SensorParams(**_tuplify(raw["sensor"]))
    return sim, sensor
