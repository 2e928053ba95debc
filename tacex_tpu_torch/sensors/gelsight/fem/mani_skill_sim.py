"""ManiSkillSimulator: the FEM marker-flow sensor approach facade (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/fem/mani_skill_sim.py``, the counterpart
of the reference's ``ManiSkillSimulator``: it binds a :class:`FemMarkerFlow`
to a batched soft-body gel and produces the ``marker_flow`` sensor output,
batched over envs. Where the JAX version takes a ``key``, this one takes a
``torch.Generator`` or the draws themselves (``FemMarkerFlow.draws``).
"""

from __future__ import annotations

import numpy as np
import torch

from ....core import maths
from ....core.device import DEFAULT_DEVICE
from .marker_flow import FemMarkerFlow, ManiSkillSimulatorCfg


class ManiSkillSimulator:
    """Marker-flow simulation from a FEM gel surface."""

    def __init__(
        self,
        cfg: ManiSkillSimulatorCfg,
        gel_mesh,  # physics.soft.mesh.TetMesh (tool frame, contact face at max z)
        cam_to_contact: float = 0.0285,
        seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = cfg
        self.mesh = gel_mesh
        remap = -np.ones(gel_mesh.num_vertices, np.int64)
        remap[gel_mesh.surface_verts] = np.arange(len(gel_mesh.surface_verts))
        tris = remap[gel_mesh.surface_tris].astype(np.int32)
        rest_cam = gel_mesh.points[gel_mesh.surface_verts].copy()
        rest_cam[:, 2] += cam_to_contact - gel_mesh.points[:, 2].max()
        self.flow_gen = FemMarkerFlow(cfg, rest_cam.astype(np.float32), tris, seed=seed, device=device)

    @property
    def device(self) -> torch.device:
        return self.flow_gen.device

    def marker_motion_simulation(
        self,
        gel_state,  # SoftBodyState (world frame)
        surface_verts: torch.Tensor,  # indices of surface verts in the state
        cam_pos: torch.Tensor,  # (N, 3)
        cam_quat: torch.Tensor,  # (N, 4)
        generator: torch.Generator | None = None,
        draws: dict | None = None,
    ) -> torch.Tensor:
        """(N, 2, marker_flow_size, 2) marker flow (init_uv, curr_uv); the
        random draws come from ``generator`` unless ``draws`` is given."""
        surf_world = gel_state.x[:, surface_verts]
        surf_cam = maths.quat_apply_inverse(cam_quat[:, None], surf_world - cam_pos[:, None])
        return self.flow_gen.flow(surf_cam, generator, draws=draws)
