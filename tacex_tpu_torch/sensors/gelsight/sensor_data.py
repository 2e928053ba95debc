"""GelSightSensorData: a typed view over one sensor frame.

Port of ``tacex_tpu/sensors/gelsight/sensor_data.py``: the sensor pose, its
intrinsics and the ``output`` dict of a frame, for consumers that expect
the reference's data container.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GelSightSensorData:
    pos_w: torch.Tensor | None = None  # (N, 3) sensor (camera) world position
    quat_w: torch.Tensor | None = None  # (N, 4)
    intrinsic_matrices: torch.Tensor | None = None  # (N, 3, 3)
    output: dict = dataclasses.field(default_factory=dict)
    """Output buffers; keys follow the reference contract: height_map
    (N,h,w) mm, camera_depth (N,h,w,1) m, tactile_rgb (N,H,W,3) [0,1],
    marker_motion (N,2,M,2), indentation_depth (N,) mm."""
