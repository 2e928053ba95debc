"""Soft-body <-> rigid coupling: the UipcIsaacAttachments equivalent.

Port of ``tacex_tpu/uipc/attachments.py``: select the soft-body vertices
on a rigid mount (within ``attachment_points_radius`` of the mount's plane
along its z axis, or by a selector), store their offsets in the body
frame, and map those through the batched body pose each step to give the
attachment targets; the solver holds them with a soft position constraint
of strength ``constraint_strength_ratio`` x the vertex mass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import maths
from ..core.config import configclass


def _rotation(quat) -> np.ndarray:
    """(3, 3) float32 rotation of a (w, x, y, z) quaternion, on the host."""
    return maths.matrix_from_quat(torch.as_tensor(np.asarray(quat, np.float32))).numpy()


@configclass
class UipcIsaacAttachmentsCfg:
    """The reference's field names."""

    constraint_strength_ratio: float = 100.0
    body_name: str = ""
    compute_attachment_data: bool = True
    attachment_points_radius: float = 5e-4


class UipcIsaacAttachments:
    """Binds selected soft-body vertices to a rigid pose."""

    def __init__(self, cfg: UipcIsaacAttachmentsCfg, uipc_object, body_pose0=None):
        self.cfg = cfg
        self.obj = uipc_object
        self.vertex_ids: np.ndarray | None = None
        self.offsets: np.ndarray | None = None  # (Va, 3) in the body frame
        if body_pose0 is not None:
            self.compute_attachment_data(*body_pose0)

    def compute_attachment_data(self, body_pos: np.ndarray, body_quat: np.ndarray, selector=None) -> None:
        """Select the attachment vertices (``selector(points) -> bool mask``,
        by default those within ``attachment_points_radius`` of the mount
        origin's plane along the body z axis) and record their body-frame
        offsets from the single rest pose (body_pos (3,), body_quat (4,))."""
        pts = self.obj.mesh.points
        rot = _rotation(body_quat)
        if selector is None:
            local = (pts - np.asarray(body_pos)) @ rot
            mask = np.abs(local[:, 2]) <= self.cfg.attachment_points_radius
        else:
            mask = selector(pts)
        self.vertex_ids = np.where(mask)[0].astype(np.int32)
        self.offsets = ((pts[self.vertex_ids] - np.asarray(body_pos)) @ rot).astype(np.float32)
        self._offsets_t = None
        self.obj.set_attachments(self.vertex_ids, aim_provider=None,
                                 strength_ratio=self.cfg.constraint_strength_ratio)

    def aim_positions(self, body_pos: torch.Tensor, body_quat: torch.Tensor) -> torch.Tensor:
        """(N, Va, 3) world targets from batched rigid poses (N, 3), (N, 4)."""
        if self._offsets_t is None or self._offsets_t.device != body_pos.device:
            self._offsets_t = torch.as_tensor(self.offsets, device=body_pos.device)
        return maths.transform_points(self._offsets_t, body_pos, body_quat)
