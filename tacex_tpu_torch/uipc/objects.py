"""UIPC-compatible object wrappers: constitutions, meshes, soft-body state.

Port of ``tacex_tpu/uipc/objects.py``. The cfgs mirror the reference's
``UipcObjectCfg`` (constitution, tet-mesh provisioning, mass density,
attachments); a ``UipcObject`` registers with a ``UipcSim``, which
finalises it in ``setup_sim`` (its own FEM model or, for a cloth, its own
``ShellModel``; a view into the sim's union model; or an affine body of
the sim's ABD model). Every object is batched over the sim's envs: its
state is (N, V, 3) on the sim's device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import configclass
from ..physics.soft.abd import inverse3
from ..physics.soft.ipc import RigidSdfScene, SoftBodyModel, SoftBodyState
from ..physics.soft.mesh import TetMesh, box_tet_mesh, extract_surface
from ..physics.soft.shell import ShellModel


@configclass
class StableNeoHookeanCfg:
    """FEM soft-body constitution."""

    youngs_modulus: float = 0.145  # MPa (reference unit convention)
    poisson_rate: float = 0.45


@configclass
class AffineBodyConstitutionCfg:
    """Affine (rigid-ish) constitution. ``kinematic=True`` bodies are held at
    their pose by a strong soft constraint and baked into the FEM solvers'
    static triangle soup at their construction pose."""

    m_kappa: float = 100.0  # MPa
    kinematic: bool = False


@configclass
class NeoHookeanShellCfg:
    """Shell/cloth constitution (NeoHookeanShell + DiscreteShellBending)."""

    youngs_modulus: float = 0.01  # MPa
    poisson_rate: float = 0.3
    thickness: float = 0.001  # m
    bending_E: float = 10.0


@configclass
class TetMeshCfg:
    """Structured tet-mesh generation: box size, cells and center."""

    size: tuple = (0.02, 0.025, 0.0045)
    resolution: tuple = (8, 10, 3)
    center: tuple = (0.0, 0.0, 0.0)


@configclass
class UipcObjectCfg:
    mesh_cfg: TetMeshCfg = None
    mass_density: float = 1000.0
    constitution: Any = None  # StableNeoHookeanCfg | AffineBodyConstitutionCfg | NeoHookeanShellCfg
    attachment_cfg: Any = None  # UipcIsaacAttachmentsCfg

    def __post_init__(self):
        if self.mesh_cfg is None:
            self.mesh_cfg = TetMeshCfg()
        if self.constitution is None:
            self.constitution = StableNeoHookeanCfg()


def _fit_affine_pose(rest: np.ndarray, pos: torch.Tensor) -> torch.Tensor:
    """Least-squares affine fit: rest (V, 3), pos (..., V, 3) -> q (..., 12)
    with x = A p + t (the rows of A after t, ``abd.q_to_affine``)."""
    rest = torch.as_tensor(np.asarray(rest, np.float32), device=pos.device)
    rc = rest.mean(0)
    Pc = rest - rc
    xc = pos.mean(-2)
    Xc = pos - xc[..., None, :]
    M = torch.einsum("...vi,vj->...ij", Xc, Pc)
    C = Pc.T @ Pc + 1e-12 * torch.eye(3, device=pos.device)
    A = M @ inverse3(C)
    t = xc - torch.einsum("...ij,j->...i", A, rc)
    return torch.cat([t, A.flatten(-2)], -1)


class UipcObject:
    """A soft body (or affine body) of a ``UipcSim``, batched over its envs.

    Lifecycle: construct against a sim, ``sim.setup_sim()`` finalises, each
    ``sim.step()`` advances; ``write_vertex_positions_to_sim`` resets the
    vertex state. The mesh comes from ``mesh``, from ``(points, tets)``
    (surface extracted), from ``(points, triangles)`` (affine bodies and
    shells: a surface mesh without tets), or else from ``cfg.mesh_cfg``.
    """

    def __init__(
        self,
        cfg: UipcObjectCfg,
        uipc_sim,
        mesh: TetMesh | None = None,
        points: np.ndarray | None = None,
        tets: np.ndarray | None = None,
        triangles: np.ndarray | None = None,
    ):
        self.cfg = cfg
        self.sim = uipc_sim
        if (mesh is None and tets is None and points is not None and triangles is not None
                and isinstance(cfg.constitution, (AffineBodyConstitutionCfg, NeoHookeanShellCfg))):
            tris = np.asarray(triangles, np.int32)
            mesh = TetMesh(
                points=np.asarray(points, np.float32),
                tets=np.zeros((0, 4), np.int32),
                surface_tris=tris,
                surface_verts=np.unique(tris).astype(np.int32),
            )
        if mesh is None:
            if points is not None and tets is not None:
                tris = extract_surface(np.asarray(tets, np.int32), np.asarray(points, np.float32))
                mesh = TetMesh(
                    points=np.asarray(points, np.float32),
                    tets=np.asarray(tets, np.int32),
                    surface_tris=tris,
                    surface_verts=np.unique(tris).astype(np.int32),
                )
            else:
                mc = cfg.mesh_cfg
                mesh = box_tet_mesh(tuple(mc.size), tuple(mc.resolution), tuple(mc.center))
        self.mesh = mesh
        self.device = uipc_sim.device
        self.model: SoftBodyModel | None = None
        self.state: SoftBodyState | None = None
        self.init_vertex_pos = np.asarray(mesh.points, np.float32)
        self._surface_verts = torch.as_tensor(np.asarray(mesh.surface_verts, np.int64), device=self.device)
        self._attachment_verts: np.ndarray | None = None
        self._attachment_strength = 100.0
        self._aim_provider = None
        self._aim_prev = None
        self._rest_aim_t = None
        self._union_range: tuple[int, int] | None = None
        # affine-body bookkeeping (filled by UipcSim._setup_abd)
        self._abd_index: int | None = None
        self._abd_aim_provider = None
        self._abd_aim_strength: float = 0.0
        self._abd_motor: tuple[np.ndarray, float] | None = None
        uipc_sim.register_object(self)

    @property
    def is_affine_body(self) -> bool:
        return isinstance(self.cfg.constitution, AffineBodyConstitutionCfg)

    @property
    def is_shell(self) -> bool:
        return isinstance(self.cfg.constitution, NeoHookeanShellCfg)

    # ------------------------------------------------- ABD constraint surface
    def set_transform_target(self, provider=None, strength: float = 100.0) -> None:
        """SoftTransformConstraint: pull this affine body's 12-DOF state toward
        a target; ``provider() -> (N, 12)``, or None to hold the initial pose."""
        assert self.is_affine_body, "transform targets are for affine bodies"
        self._abd_aim_provider = provider
        self._abd_aim_strength = float(strength)

    def set_rotating_motor(self, axis, rot_vel: float, strength: float = 100.0) -> None:
        """RotatingMotor: the target is advanced by ``rot_vel * dt`` about
        ``axis`` every step."""
        assert self.is_affine_body, "motors are for affine bodies"
        self._abd_motor = (np.asarray(axis, np.float32), float(rot_vel))
        self._abd_aim_strength = float(strength)

    # ------------------------------------------------------------ finalization
    def set_attachments(self, vertex_ids: np.ndarray, aim_provider=None, strength_ratio: float = 100.0):
        """Soft position constraints on ``vertex_ids``; ``aim_provider() ->
        (N, Va, 3)`` gives their targets each step, or None to hold them at
        their initial positions."""
        self._attachment_verts = np.asarray(vertex_ids, np.int32)
        self._aim_provider = aim_provider
        self._attachment_strength = strength_ratio

    def _rest_aim(self) -> torch.Tensor:
        """(N, Va, 3) initial positions of the attachment vertices, on the device."""
        if self._rest_aim_t is None:
            rest = np.asarray(self.init_vertex_pos[self._attachment_verts], np.float32)
            self._rest_aim_t = torch.as_tensor(rest, device=self.device).expand(
                (self.sim.cfg.num_envs,) + rest.shape).contiguous()
        return self._rest_aim_t

    def _finalize(self, sim, static_tris=None) -> None:
        con = self.cfg.constitution
        if self.is_shell:
            self.model = ShellModel(
                self.mesh.points,
                self.mesh.surface_tris,
                youngs_modulus=con.youngs_modulus * 1e6,  # MPa -> Pa
                poisson_ratio=con.poisson_rate,
                thickness=con.thickness,
                mass_density=self.cfg.mass_density,
                bending_stiffness=con.bending_E,
                cfg=sim.cfg.to_shell_cfg(),
                static_tris=static_tris,
                attachment_verts=self._attachment_verts,
                attachment_strength_ratio=self._attachment_strength,
                device=self.device,
            )
            self.state = SoftBodyState.init(sim.cfg.num_envs, self.mesh.points, device=self.device)
            return
        assert isinstance(self.cfg.constitution, StableNeoHookeanCfg), (
            "affine bodies are finalized by UipcSim._setup_abd"
        )
        self.model = SoftBodyModel(
            self.mesh,
            youngs_modulus=con.youngs_modulus * 1e6,  # MPa -> Pa
            poisson_ratio=con.poisson_rate,
            mass_density=self.cfg.mass_density,
            cfg=sim.cfg.to_solver_cfg(),
            attachment_verts=self._attachment_verts,
            attachment_strength_ratio=self._attachment_strength,
            static_tris=static_tris,
            device=self.device,
        )
        self.state = SoftBodyState.init(sim.cfg.num_envs, self.mesh.points, device=self.device)

    def _set_union_view(self, sim, lo: int, hi: int) -> None:
        """This object's vertices live in the sim's union model at [lo:hi);
        its state is a slice of the union state."""
        self._union_range = (lo, hi)
        self.model = None
        self._refresh_union_slice()

    def _refresh_union_slice(self) -> None:
        lo, hi = self._union_range
        u = self.sim._union_state
        self.state = SoftBodyState(x=u.x[:, lo:hi], v=u.v[:, lo:hi])

    # ------------------------------------------------------------------- step
    def _aim(self) -> torch.Tensor | None:
        """This step's attachment targets: the provider's, else the initial
        positions (a None target would pull the anchors to the origin)."""
        if self._aim_provider is not None:
            return self._aim_provider()
        if self._attachment_verts is not None and len(self._attachment_verts) > 0:
            return self._rest_aim()
        return None

    def _advance(self, scene: RigidSdfScene, scene_prev: RigidSdfScene | None = None) -> None:
        """One step of this object's own model; with ``scene_prev`` a FEM
        body's colliders (and attachment targets) are swept from the previous
        frame when the solver substeps (a shell's solve does not substep)."""
        aim = self._aim()
        if scene_prev is not None and not self.is_shell:
            self.state = self.model.step(self.state, scene, aim, scene_prev, self._aim_prev)
        else:
            self.state = self.model.step(self.state, scene, aim)
        self._aim_prev = aim

    # ------------------------------------------------------------------ views
    def surface_positions(self) -> torch.Tensor:
        if self.is_affine_body:
            return self.sim.abd_vertex_positions(self)
        if self.is_shell and self._union_range is None:
            return self.model.surface_positions(self.state)
        return self.state.x.index_select(1, self._surface_verts)

    @property
    def nodal_pos_w(self) -> torch.Tensor:
        """(N, V, 3) vertex positions."""
        if self.is_affine_body:
            return self.sim.abd_vertex_positions(self)
        return self.state.x

    @property
    def root_pos_w(self) -> torch.Tensor:
        """(N, 3) mean of the surface vertices."""
        return self.surface_positions().mean(1)

    def write_vertex_positions_to_sim(self, positions, env_mask=None) -> None:
        """Reset the vertex state to ``positions`` ((V, 3) or (N, V, 3)) with
        zero velocity, in every env or where ``env_mask`` (N,) is true. An
        affine body takes the best-fit affine pose of the positions."""
        positions = torch.as_tensor(positions, dtype=torch.float32, device=self.device)
        if env_mask is not None:
            env_mask = torch.as_tensor(env_mask, device=self.device)
        if self.is_affine_body:
            self.sim.write_abd_pose(self, _fit_affine_pose(self.mesh.points, positions), env_mask)
            return
        if env_mask is None:
            x = positions.expand(self.state.x.shape).clone()
            new = SoftBodyState(x=x, v=torch.zeros_like(x))
        else:
            m = env_mask[:, None, None]
            new = SoftBodyState(x=torch.where(m, positions, self.state.x), v=torch.where(m, 0.0, self.state.v))
        if self._union_range is not None:
            lo, hi = self._union_range
            u = self.sim._union_state
            self.sim._union_state = SoftBodyState(
                x=torch.cat([u.x[:, :lo], new.x, u.x[:, hi:]], 1), v=torch.cat([u.v[:, :lo], new.v, u.v[:, hi:]], 1)
            )
            self._refresh_union_slice()
        else:
            self.state = new
