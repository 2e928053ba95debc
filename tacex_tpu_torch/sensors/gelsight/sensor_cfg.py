"""GelSight sensor configuration classes.

Field names and semantics preserve the reference's public API surface
(reference source/tacex/tacex/gelsight_sensor_cfg.py:13-64,
gpu_taxim/taxim_sim_cfg.py, fots/fots_marker_sim_cfg.py:15-76, and the
GelSight Mini preset tacex_assets/sensors/gelsight_mini/gsmini_cfg.py:15-76)
so reference task configs translate 1:1. Backend selection is by config
*presence* (optical_sim_cfg / marker_motion_sim_cfg), mirroring the
class-as-config plugin pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from ...core.config import configclass
from .fots.marker_motion import FOTSMarkerCfg


@configclass
class Dimensions:
    """Dimensions in meters (world units)."""

    width: float = 0.0
    length: float = 0.0
    height: float = 0.0


@configclass
class SensorCameraCfg:
    """The gel-facing depth camera (reference gelsight_sensor_cfg.py:27-36)."""

    resolution: tuple = (320, 240)  # (width, height)
    data_types: list = dataclasses.field(default_factory=lambda: ["depth"])
    clipping_range: tuple = (0.024, 0.029)  # meters (near, far)
    update_period: float = 0.0


@configclass
class TaximSimulatorCfg:
    """Optical (tactile RGB) simulation config (reference taxim_sim_cfg.py)."""

    calib_folder_path: str = ""  # empty -> bundled GelSight Mini calibration
    with_shadow: bool = False
    tactile_img_res: tuple = (320, 240)  # (width, height)
    gelpad_height: float = 0.0045  # meters
    gelpad_to_camera_min_distance: float = 0.024  # meters
    device: str = "tpu"  # kept for API parity; placement is managed by JAX


@configclass
class FOTSMarkerSimulatorCfg:
    """Marker-motion simulation config (reference fots_marker_sim_cfg.py)."""

    lamb: list = dataclasses.field(default_factory=lambda: [0.00125, 0.00021, 0.00038])
    mm_to_pixel: float = 19.58
    tactile_img_res: tuple = (320, 240)

    @configclass
    class MarkerParams:
        num_markers_col: int = 11
        num_markers_row: int = 9
        x0: float = 15.0
        y0: float = 26.0
        dx: float = 26.0
        dy: float = 29.0

        @property
        def num_markers(self) -> int:
            return self.num_markers_col * self.num_markers_row

    marker_params: "FOTSMarkerSimulatorCfg.MarkerParams" = None
    device: str = "tpu"

    def __post_init__(self):
        if self.marker_params is None:
            self.marker_params = FOTSMarkerSimulatorCfg.MarkerParams()

    def to_marker_cfg(self) -> FOTSMarkerCfg:
        return FOTSMarkerCfg(
            lamb=list(self.lamb),
            num_markers_row=self.marker_params.num_markers_row,
            num_markers_col=self.marker_params.num_markers_col,
            x0=self.marker_params.x0,
            y0=self.marker_params.y0,
            tactile_img_width=self.tactile_img_res[0],
            tactile_img_height=self.tactile_img_res[1],
            mm_to_pixel=self.mm_to_pixel,
        )


@configclass
class GelSightSensorCfg:
    """Top-level GelSight sensor config (reference gelsight_sensor_cfg.py)."""

    case_dimensions: Dimensions = None
    gelpad_dimensions: Dimensions = None
    sensor_camera_cfg: SensorCameraCfg = None
    data_types: list = dataclasses.field(
        default_factory=lambda: ["tactile_rgb", "marker_motion", "height_map", "camera_depth"]
    )
    optical_sim_cfg: TaximSimulatorCfg | None = None
    marker_motion_sim_cfg: FOTSMarkerSimulatorCfg | None = None
    compute_indentation_depth_class: Literal["optical_sim", "marker_motion_sim"] = "optical_sim"
    device: str = "tpu"

    def __post_init__(self):
        if self.case_dimensions is None:
            self.case_dimensions = Dimensions()
        if self.gelpad_dimensions is None:
            self.gelpad_dimensions = Dimensions()
        if self.sensor_camera_cfg is None:
            self.sensor_camera_cfg = SensorCameraCfg()


def gelsight_mini_cfg(
    with_markers: bool = True,
    with_shadow: bool = False,
    camera_resolution: tuple = (320, 240),
    tactile_img_res: tuple = (320, 240),
) -> GelSightSensorCfg:
    """GelSight Mini preset (reference gsmini_cfg.py:15-76): case 32x28x24 mm,
    gelpad 20.75x25.25x4.5 mm, camera clipping (0.024, 0.029) m."""
    cfg = GelSightSensorCfg(
        case_dimensions=Dimensions(width=32 / 1000, length=28 / 1000, height=24 / 1000),
        gelpad_dimensions=Dimensions(width=20.75 / 1000, length=25.25 / 1000, height=4.5 / 1000),
        sensor_camera_cfg=SensorCameraCfg(
            resolution=camera_resolution,
            data_types=["depth"],
            clipping_range=(0.024, 0.029),
        ),
        data_types=["tactile_rgb", "height_map", "camera_depth"] + (["marker_motion"] if with_markers else []),
        optical_sim_cfg=TaximSimulatorCfg(
            gelpad_height=4.5 / 1000,
            gelpad_to_camera_min_distance=0.024,
            with_shadow=with_shadow,
            tactile_img_res=tactile_img_res,
        ),
        # FOTS marker coordinates stay at their calibration resolution
        # (320x240: x0/y0/mm_to_pixel are tuned for it — reference
        # gsmini_cfg.py:61-76 keeps (320,240) even with a 32x24 camera);
        # the sensor maps them onto whatever the optical path runs at.
        marker_motion_sim_cfg=(
            FOTSMarkerSimulatorCfg(tactile_img_res=(320, 240)) if with_markers else None
        ),
    )
    return cfg
