"""UIPC-compatible simulation facade over the port's batched IPC solvers.

Port of ``tacex_tpu/uipc/sim.py``: ``UipcSimCfg`` (the reference's solver
knobs) and ``UipcSim`` (register objects, ``setup_sim``, ``step``,
``step_n``, render sync, save/replay, health checks), simulating N envs at
once on one device. ``setup_sim`` builds one of three worlds for the
nodal objects (FEM bodies and shells, one vertex array with tet and shell
elements):

  * each object with its own model (no object-object contact): a
    ``SoftBodyModel`` for a FEM body, a ``ShellModel`` for a cloth;
  * one union model of every nodal object, with self contact, when
    ``contact.self_contact_k > 0`` and there are two or more, or any shell
    (a lone cloth folding onto itself): gel against gel, cloth against gel
    and cloth against itself through the vertex-triangle (and edge-edge)
    families;
  * the coupled FEM+ABD world (``CoupledModel``) when the scene has nodal
    objects and affine bodies, ``contact.coupling_k > 0``, and a FEM body
    or a dynamic affine body: one Newton solve over the union of the nodal
    objects and every affine body. A lone cloth over kinematic bodies keeps
    its standalone solve.

Outside the coupled world every affine body joins one ABD model stepped by
its own solve (``AbdModel.step``), with body-body contact when there are
two or more (``contact.abd_contact_k``) and kinematic bodies held by strong
soft-transform constraints (and seen by the FEM models as static trimesh
colliders). Shells outside the union see them the same way.

Device work and host reads: ``step`` reads nothing back inside its solves;
it synchronises once at its end, for its timing report, as the JAX
package's ``block_until_ready``. ``step_n`` runs a fixed-count loop of the
same per-frame calls and synchronises once at its end. ``check_health``,
``broad_phase_overflow`` and the CCD motion guard read back only when they
run (the health-check interval, the caller, ``ccd_motion_limit > 0``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from ..core.config import configclass
from ..core.device import DEFAULT_DEVICE, resolve
from ..physics.soft.abd import AbdModel, AbdSolverCfg, AbdState, _mesh_moments, rotate_target, rotation_about
from ..physics.soft.codim import build_shell_elements, merge_shell_elements
from ..physics.soft.coupled import CoupledModel
from ..physics.soft.ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState, scene_motion
from ..physics.soft.mesh import union_meshes
from ..physics.soft.shell import ShellSolverCfg


@configclass
class UipcSimCfg:
    """Solver config mirroring the reference's UipcSimCfg."""

    dt: float = 0.01
    gravity: tuple = (0.0, 0.0, -9.81)
    ground_height: float = 0.0
    ground_normal: tuple = (0.0, 0.0, 1.0)
    enable_ground: bool = False
    logger_level: str = "Warn"

    @configclass
    class Newton:
        max_iter: int = 8
        velocity_tol: float = 0.05
        ccd_tol: float = 1.0
        transrate_tol: float = 0.1
        # kinematic-collider CCD fallback: k > 1 runs each nodal solve as k
        # substeps at dt/k against scene poses swept previous -> current frame
        ccd_substeps: int = 1
        # warn (or raise with strict_ccd) when a collider moved more than this
        # per substep between two step() calls; 0 disables the guard
        ccd_motion_limit: float = 0.0
        strict_ccd: bool = False

    @configclass
    class LinearSystem:
        solver: str = "linear_pcg"
        tol_rate: float = 1e-3
        max_iter: int = 24

    @configclass
    class LineSearch:
        max_iter: int = 8
        report_energy: bool = False

    @configclass
    class Contact:
        enable: bool = True
        friction: bool = True
        default_friction_ratio: float = 0.5
        resistance: float = 1e4  # barrier stiffness kappa
        constitution: str = "ipc"
        d_hat: float = 0.001
        eps_velocity: float = 0.01
        # vertex-triangle candidates per surface vertex for FEM-FEM and self contact (0 = off)
        self_contact_k: int = 0
        # affine-body-vs-affine-body candidates (the ABD system)
        abd_contact_k: int = 8
        # edge-edge candidates per surface edge of the nodal system (0 = off)
        ee_contact_k: int = 0
        # FEM <-> ABD candidates per vertex for the coupled world (0: split solves)
        coupling_k: int = 4
        # check_health() warns on a dropped within-reach pair; True raises
        overflow_errors: bool = False

    newton: "UipcSimCfg.Newton" = None
    linear_system: "UipcSimCfg.LinearSystem" = None
    line_search: "UipcSimCfg.LineSearch" = None
    contact: "UipcSimCfg.Contact" = None
    collision_detection_method: str = "analytic_sdf"
    sanity_check: bool = True
    # request gradients through the solve (the reference's meaning); it runs no diagnostics
    diff_sim: bool = False
    # run check_health() every N frames (0 = off)
    health_check_interval: int = 0
    num_envs: int = 1

    def __post_init__(self):
        if self.newton is None:
            self.newton = UipcSimCfg.Newton()
        if self.linear_system is None:
            self.linear_system = UipcSimCfg.LinearSystem()
        if self.line_search is None:
            self.line_search = UipcSimCfg.LineSearch()
        if self.contact is None:
            self.contact = UipcSimCfg.Contact()

    def to_shell_cfg(self) -> ShellSolverCfg:
        return ShellSolverCfg(
            dt=self.dt,
            gravity=tuple(self.gravity),
            newton_max_iter=self.newton.max_iter,
            velocity_tol=self.newton.velocity_tol,
            cg_iters=self.linear_system.max_iter,
            line_search_iters=self.line_search.max_iter,
            d_hat=self.contact.d_hat,
            kappa=self.contact.resistance,
            friction_mu=(self.contact.default_friction_ratio if self.contact.friction else 0.0),
            eps_velocity=self.contact.eps_velocity,
        )

    def to_solver_cfg(self) -> IpcSolverCfg:
        return IpcSolverCfg(
            dt=self.dt,
            gravity=tuple(self.gravity),
            newton_max_iter=self.newton.max_iter,
            velocity_tol=self.newton.velocity_tol,
            cg_iters=self.linear_system.max_iter,
            line_search_iters=self.line_search.max_iter,
            d_hat=self.contact.d_hat,
            kappa=self.contact.resistance,
            friction_mu=(self.contact.default_friction_ratio if self.contact.friction else 0.0),
            eps_velocity=self.contact.eps_velocity,
            self_contact_k=(self.contact.self_contact_k if self.contact.enable else 0),
            ee_contact_k=(self.contact.ee_contact_k if self.contact.enable else 0),
            ccd_substeps=self.newton.ccd_substeps,
        )


class UipcSim:
    """Scene manager: owns the objects and steps them together on ``device``
    (the card unless the caller passes ``device="cpu"``)."""

    #: retention cap of save_frame's snapshots (the oldest are evicted)
    max_saved_frames: int = 64

    def __init__(self, cfg: UipcSimCfg | None = None, device=DEFAULT_DEVICE):
        self.cfg = cfg or UipcSimCfg()
        self.device = resolve(device)
        self.objects: list[Any] = []
        self._union_model = None
        self._union_state = None
        self._union_aim_objs: list[Any] = []
        self._union_objs: list[Any] = []
        self._abd_model = None
        self._abd_state = None
        self._abd_aim_q = None
        self._abd_objs: list[Any] = []
        self._coupled = None
        self._scene_prev: RigidSdfScene | None = None
        self._union_aim_prev = None
        self._frames: dict[int, tuple] = {}
        self._frame_counter = 0
        self._timings: dict[str, float] = {}
        self._setup = False

    # -------------------------------------------------------------- scene mgmt
    def register_object(self, obj) -> int:
        assert not self._setup, "scene is finalized after setup_sim()"
        self.objects.append(obj)
        return len(self.objects) - 1

    def setup_sim(self) -> None:
        """Finalise the scene: build the world's solver models (see the
        module docstring for the three worlds). Kinematic affine bodies
        become static trimesh colliders of the nodal models outside the
        coupled world."""
        self._union_model = self._union_state = self._coupled = None
        self._scene_prev = self._union_aim_prev = None
        fem_objs = [o for o in self.objects if not (o.is_affine_body or o.is_shell)]
        abd_objs = [o for o in self.objects if o.is_affine_body]
        shell_objs = [o for o in self.objects if o.is_shell]
        nodal_objs = fem_objs + shell_objs  # one vertex array, tet and shell elements
        static = [np.asarray(o.mesh.points, np.float32)[np.asarray(o.mesh.surface_tris)]
                  for o in abd_objs if o.cfg.constitution.kinematic]
        static_tris = np.concatenate(static) if static else None
        c = self.cfg.contact
        any_dynamic_abd = any(not o.cfg.constitution.kinematic for o in abd_objs)
        couple = bool(c.enable and c.coupling_k > 0 and nodal_objs and abd_objs and (fem_objs or any_dynamic_abd))
        in_union: list[Any] = []
        if couple:
            self._setup_union(nodal_objs, static_tris=None)
            self._setup_abd(abd_objs)
            self._coupled = CoupledModel(self._union_model, self._abd_model, cross_k=c.coupling_k)
            in_union = nodal_objs
        elif c.self_contact_k > 0 and (len(nodal_objs) >= 2 or shell_objs):
            self._setup_union(nodal_objs, static_tris=static_tris)
            in_union = nodal_objs
        else:
            for obj in fem_objs:
                obj._finalize(self, static_tris=static_tris)
        for obj in shell_objs:
            if obj not in in_union:
                obj._finalize(self, static_tris=static_tris)
        if abd_objs and not couple:
            self._setup_abd(abd_objs)
        # ccd_substeps is honoured only on the nodal path; the coupled world
        # and the ABD solve step once a frame, and the motion guard divides by
        # the substeps actually applied
        k_req = int(self.cfg.newton.ccd_substeps)
        honored = self._coupled is None and (self._union_model is not None or bool(fem_objs))
        self._effective_ccd_substeps = k_req if honored else 1
        if k_req > 1 and not honored:
            warnings.warn(
                f"newton.ccd_substeps={k_req} has no effect on this scene: the coupled FEM+ABD world and "
                "standalone ABD solves do not substep; the CCD motion guard will use 1 substep",
                stacklevel=2,
            )
        if self.cfg.enable_ground:
            plane = np.concatenate([np.asarray(self.cfg.ground_normal, np.float32), [self.cfg.ground_height]])
            self._ground = torch.as_tensor(plane.astype(np.float32), device=self.device).view(1, 1, 4)
        if self.cfg.sanity_check:
            self._sanity_check()
        self._setup = True

    def _setup_abd(self, abd_objs) -> None:
        n = self.cfg.num_envs
        c = self.cfg.contact
        pts, tris, dens, kappas = [], [], [], []
        for i, obj in enumerate(abd_objs):
            obj._abd_index = i
            pts.append(np.asarray(obj.mesh.points, np.float64))
            tris.append(np.asarray(obj.mesh.surface_tris, np.int64))
            dens.append(obj.cfg.mass_density)
            kappas.append(obj.cfg.constitution.m_kappa * 1e6)  # MPa -> Pa
        contact_k = c.abd_contact_k if (c.enable and len(abd_objs) >= 2) else 0
        cfg = AbdSolverCfg(
            dt=self.cfg.dt,
            gravity=tuple(self.cfg.gravity),
            newton_max_iter=self.cfg.newton.max_iter,
            line_search_iters=self.cfg.line_search.max_iter,
            velocity_tol=self.cfg.newton.velocity_tol,
            d_hat=c.d_hat,
            kappa_contact=c.resistance,
            friction_mu=(c.default_friction_ratio if c.friction else 0.0),
            eps_velocity=c.eps_velocity,
            contact_k=contact_k,
            # body-body edge-edge pairs exist only beside body-body contact
            ee_contact_k=AbdSolverCfg.ee_contact_k if contact_k > 0 else 0,
        )
        self._abd_objs = abd_objs
        self._abd_model = AbdModel(pts, tris, mass_density=dens, kappa_ortho=kappas, cfg=cfg, device=self.device)
        self._abd_state = AbdState.identity(n, len(abd_objs), device=self.device)
        self._abd_init_state = AbdState(q=self._abd_state.q.clone(), qd=self._abd_state.qd.clone())
        offs = np.cumsum([0] + [len(p) for p in pts])
        for i, obj in enumerate(abd_objs):
            obj._abd_vrange = (int(offs[i]), int(offs[i + 1]))
        # constraint strengths: kinematic bodies held at their initial pose,
        # a RotatingMotor on the rotational DOFs only, else the transform target's
        strengths = np.zeros((len(abd_objs), 12), np.float32)
        self._abd_motor_rot = {}
        for i, obj in enumerate(abd_objs):
            if obj.cfg.constitution.kinematic:
                strengths[i, :] = 1e4
            elif obj._abd_motor is not None:
                strengths[i, 3:] = obj._abd_aim_strength
                axis, vel = obj._abd_motor
                self._abd_motor_rot[i] = rotation_about(axis, vel * self.cfg.dt, device=self.device)
            elif obj._abd_aim_strength > 0:
                strengths[i, :] = obj._abd_aim_strength
        self._abd_strength = torch.as_tensor(strengths, device=self.device).expand(n, len(abd_objs), 12)
        self._abd_aim_q = self._abd_state.q

    def abd_vertex_positions(self, obj) -> torch.Tensor:
        """(N, V_obj, 3) world vertices of one affine body."""
        lo, hi = obj._abd_vrange
        return self._abd_model.world_points(self._abd_state.q)[:, lo:hi]

    def abd_body_pose(self, obj) -> torch.Tensor:
        """(N, 12) pose [t | rows of A] of one affine body."""
        return self._abd_state.q[:, obj._abd_index]

    def _set_body(self, q_all, i, value, env_mask):
        """q_all (N, B, 12) with body i set to value (N, 12) where env_mask."""
        if env_mask is not None:
            value = torch.where(env_mask[:, None], value, q_all[:, i])
        out = q_all.clone()
        out[:, i] = value
        return out

    def write_abd_pose(self, obj, q, env_mask=None) -> None:
        """Set one affine body's pose (zeroing its velocity and moving its
        constraint target along) in every env or where env_mask (N,)."""
        i = obj._abd_index
        st = self._abd_state
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device).expand(st.q[:, i].shape)
        self._abd_state = AbdState(q=self._set_body(st.q, i, q, env_mask),
                                   qd=self._set_body(st.qd, i, torch.zeros_like(q), env_mask))
        self._abd_aim_q = self._set_body(self._abd_aim_q, i, q, env_mask)

    def reset_abd_object(self, obj, env_mask=None) -> None:
        """Put one affine body back at its initial pose, at rest."""
        self.write_abd_pose(obj, self._abd_init_state.q[:, obj._abd_index], env_mask)

    def _setup_union(self, objects, static_tris=None) -> None:
        mesh, offsets = union_meshes([o.mesh for o in objects])
        youngs, poisson, density, att_verts, att_ratio, shell_parts = [], [], [], [], [], []
        self._union_aim_objs = []
        for i, obj in enumerate(objects):
            con = obj.cfg.constitution
            if obj.is_shell:
                # membrane and bending elements with the union's vertex ids (a
                # shell's mesh has no tets; its triangles are the union's surface)
                shell_parts.append(build_shell_elements(
                    obj.mesh.points, obj.mesh.surface_tris, youngs_modulus=con.youngs_modulus * 1e6,  # MPa -> Pa
                    poisson_ratio=con.poisson_rate, thickness=con.thickness, mass_density=obj.cfg.mass_density,
                    bending_stiffness=con.bending_E, num_vertices=mesh.num_vertices, vertex_offset=int(offsets[i]),
                ))
            nt = obj.mesh.tets.shape[0]
            youngs.append(np.full(nt, getattr(con, "youngs_modulus", 0.1) * 1e6, np.float32))
            poisson.append(np.full(nt, getattr(con, "poisson_rate", 0.45), np.float32))
            density.append(np.full(nt, obj.cfg.mass_density, np.float32))
            if obj._attachment_verts is not None and len(obj._attachment_verts) > 0:
                att_verts.append(np.asarray(obj._attachment_verts, np.int64) + offsets[i])
                att_ratio.append(np.full(len(obj._attachment_verts), obj._attachment_strength, np.float32))
                self._union_aim_objs.append(obj)
        self._union_model = SoftBodyModel(
            mesh,
            youngs_modulus=np.concatenate(youngs),
            poisson_ratio=np.concatenate(poisson),
            mass_density=np.concatenate(density),
            cfg=self.cfg.to_solver_cfg(),
            attachment_verts=np.concatenate(att_verts).astype(np.int32) if att_verts else None,
            attachment_strength_ratio=np.concatenate(att_ratio) if att_ratio else 100.0,
            static_tris=static_tris,
            shell_elems=merge_shell_elements(shell_parts, mesh.num_vertices) if shell_parts else None,
            device=self.device,
        )
        self._union_state = SoftBodyState.init(self.cfg.num_envs, mesh.points, device=self.device)
        self._union_objs = objects
        for i, obj in enumerate(objects):
            obj._set_union_view(self, int(offsets[i]), int(offsets[i + 1]))

    def _sanity_check(self) -> None:
        """Validate the scene before solving: positive tet volumes and masses,
        d_hat at most twice the smallest edge, attachment ids in range, a
        positive volume for each affine body's closed surface, and positive
        shell vertex masses (``build_shell_elements`` rejects a degenerate
        rest triangle)."""
        problems: list[str] = []
        for i, obj in enumerate(self.objects):
            mesh = obj.mesh
            if obj.is_shell:
                if obj.model is not None and float(obj.model.masses.min()) <= 0:
                    problems.append(f"object {i}: non-positive shell vertex mass")
                continue
            if obj.is_affine_body:
                vol, _, _ = _mesh_moments(np.asarray(mesh.points, np.float64), np.asarray(mesh.surface_tris, np.int64))
                if vol <= 0:
                    problems.append(f"object {i}: non-positive affine-body volume {vol:g} "
                                    "(surface mesh not closed/outward-oriented?)")
                continue
            vols = mesh.rest_volumes()
            if (vols <= 0).any():
                problems.append(f"object {i}: {(vols <= 0).sum()} non-positive tet volumes")
            edge_min = float(np.linalg.norm(mesh.points[mesh.tets[:, 1]] - mesh.points[mesh.tets[:, 0]], axis=-1).min())
            if self.cfg.contact.d_hat > 2 * edge_min:
                problems.append(
                    f"object {i}: contact.d_hat ({self.cfg.contact.d_hat:g}) exceeds 2x the "
                    f"minimum edge length ({edge_min:g}) — barriers will act through elements"
                )
            if obj.model is not None and float(obj.model.masses.min()) <= 0:
                problems.append(f"object {i}: non-positive lumped vertex mass")
            if obj.model is not None and obj.model.attachment_verts.shape[0] > 0:
                ids = obj.model.attachment_verts.cpu().numpy()
                if ids.min() < 0 or ids.max() >= mesh.num_vertices:
                    problems.append(f"object {i}: attachment vertex ids out of range")
        if problems:
            raise ValueError("scene sanity check failed:\n  " + "\n  ".join(problems))

    # ------------------------------------------------------------------ step
    def _scene(self, scene: RigidSdfScene | None) -> RigidSdfScene:
        """The step's colliders: ``scene`` (empty if None) and the ground plane."""
        n = self.cfg.num_envs
        if scene is None:
            scene = RigidSdfScene.empty(n, device=self.device)
        if self.cfg.enable_ground:
            scene = dataclasses.replace(scene, planes=torch.cat([scene.planes, self._ground.expand(n, 1, 4)], 1))
        return scene

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, scene: RigidSdfScene | None = None) -> None:
        """Advance every object one dt against ``scene`` (N envs of analytic
        colliders; its previous frame sweeps the colliders when the nodal
        solve substeps)."""
        assert self._setup, "call setup_sim() first"
        t0 = time.perf_counter()
        scene = self._scene(scene)
        scene_prev = self._scene_prev if self._scene_prev is not None else scene
        self._ccd_motion_guard(scene_prev, scene)
        if self._coupled is not None:
            # one Newton solve over the FEM union and the affine bodies
            aim, abd_aim = self._union_aim(), self._advance_abd_aims()
            self._union_state, self._abd_state = self._coupled.step(
                self._union_state, self._abd_state, scene, aim, abd_aim, self._abd_strength
            )
            self._refresh_union_slices()
            self._advance_standalone_shells(scene)
        elif self._union_model is not None:
            aim = self._union_aim()
            self._union_state = self._union_model.step(self._union_state, scene, aim, scene_prev, self._union_aim_prev)
            self._union_aim_prev = aim
            self._refresh_union_slices()
            self._advance_standalone_shells(scene)
        else:
            for obj in self.objects:
                if not obj.is_affine_body:
                    obj._advance(scene, scene_prev)
        self._scene_prev = scene
        if self._abd_model is not None and self._coupled is None:
            self._advance_abd(scene)
        self._synchronize()
        hci = self.cfg.health_check_interval
        if hci and self._frame_counter % hci == 0:
            self.check_health()
        self._timings["step"] = time.perf_counter() - t0
        self._frame_counter += 1

    def step_n(self, n_steps: int, scene: RigidSdfScene | None = None) -> None:
        """Advance ``n_steps`` frames in one fixed-count loop of the per-frame
        solves, with no host read between frames, against a held ``scene``.
        Attachment and ABD aim providers are host callbacks, so every
        attachment must be provider-less (holding its initial positions) and
        every affine body free, kinematic or driven by a RotatingMotor
        (asserted); for live providers call ``step`` per frame."""
        assert self._setup, "call setup_sim() first"
        for o in self.objects:
            assert o._aim_provider is None, "step_n cannot run host aim providers; use step()"
            assert o._abd_aim_provider is None, "step_n cannot run host ABD aim providers; use step()"
        t0 = time.perf_counter()
        sc = self._scene(scene)
        union_aim = self._union_aim()
        sep_objs = [o for o in self.objects if not o.is_affine_body and o._union_range is None and o.model is not None]
        sep_aims = [o._aim() for o in sep_objs]
        u_state, a_state, a_aim = self._union_state, self._abd_state, self._abd_aim_q
        seps = [o.state for o in sep_objs]
        for _ in range(n_steps):
            if self._abd_model is not None:
                for i, R in self._abd_motor_rot.items():
                    a_aim = self._set_body(a_aim, i, rotate_target(a_aim[:, i], R), None)
            if self._coupled is not None:
                u_state, a_state = self._coupled.step(u_state, a_state, sc, union_aim, a_aim, self._abd_strength)
            else:
                if self._union_model is not None:
                    u_state = self._union_model.step(u_state, sc, union_aim)
                if self._abd_model is not None:
                    a_state = self._abd_model.step(a_state, sc, a_aim, self._abd_strength)
            seps = [o.model.step(s, sc, am) for o, s, am in zip(sep_objs, seps, sep_aims)]
        self._union_state, self._abd_state, self._abd_aim_q = u_state, a_state, a_aim
        for o, s in zip(sep_objs, seps):
            o.state = s
        self._refresh_union_slices()
        self._synchronize()
        self._timings["step_n"] = time.perf_counter() - t0
        self._frame_counter += n_steps

    def _advance_standalone_shells(self, scene: RigidSdfScene) -> None:
        """One step of each shell outside the union (beside a coupled or union world)."""
        for obj in self.objects:
            if obj.is_shell and obj._union_range is None:
                obj._advance(scene)

    def _refresh_union_slices(self) -> None:
        for obj in self._union_objs:
            obj._refresh_union_slice()

    def _union_aim(self) -> torch.Tensor | None:
        """(N, Va, 3) targets of the union model's attachment vertices: every
        attached object's, its provider's or its initial positions."""
        if not self._union_aim_objs:
            return None
        return torch.cat([o._aim() for o in self._union_aim_objs], 1)

    def _advance_abd_aims(self) -> torch.Tensor:
        """Advance the motors' targets and query the transform providers."""
        aim = self._abd_aim_q
        for obj in self._abd_objs:
            i = obj._abd_index
            if obj._abd_motor is not None:
                aim = self._set_body(aim, i, rotate_target(aim[:, i], self._abd_motor_rot[i]), None)
            elif obj._abd_aim_provider is not None:
                aim = self._set_body(aim, i, obj._abd_aim_provider(), None)
        self._abd_aim_q = aim
        return aim

    def _advance_abd(self, scene: RigidSdfScene) -> None:
        """The split ABD solve: the affine bodies outside the coupled world,
        one ``AbdModel.step`` against the frame's scene."""
        aim = self._advance_abd_aims()
        self._abd_state = self._abd_model.step(self._abd_state, scene, aim, self._abd_strength)

    def _ccd_motion_guard(self, scene_prev, scene) -> None:
        """Warn (raise with ``strict_ccd``) when a collider moved more than
        ``newton.ccd_motion_limit`` per applied substep this frame: past that
        it can cross a thin soft feature unseen. Reads the motion back to the
        host, so it runs only with a limit set."""
        limit = self.cfg.newton.ccd_motion_limit
        if limit <= 0 or scene_prev is scene:
            return
        per_sub = scene_motion(scene_prev, scene).cpu().numpy() / max(self._effective_ccd_substeps, 1)
        if (per_sub > limit).any():
            msg = (
                f"CCD envelope exceeded: collider moved {per_sub.max() * 1e3:.2f} mm "
                f"per substep (> limit {limit * 1e3:.2f} mm) in {int((per_sub > limit).sum())} env(s) — "
                "raise newton.ccd_substeps or shrink dt"
            )
            if self.cfg.newton.strict_ccd:
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=3)

    def broad_phase_overflow(self) -> dict[str, np.ndarray]:
        """Per family and env, the within-reach contact candidates the
        fixed-capacity broad phase dropped this frame -> {key: (N,) int}:
        ``vt_self``, ``vt_static``, ``ee`` of the union model (of a
        standalone object, prefixed ``obj{i}_``), ``abd_vt_body`` /
        ``abd_ee`` of the affine bodies, and ``vt_cross_a`` /
        ``vt_cross_b`` of the coupled world. Nonzero means a pair within
        reach got no barrier: raise the matching ``*_k``."""
        if self._coupled is not None:
            parts = [("", self._coupled.broad_phase_overflow(self._union_state.x, self._abd_state.q))]
        else:
            parts = []
            if self._union_model is not None:
                parts.append(("", self._union_model.broad_phase_overflow(self._union_state.x)))
            if self._abd_model is not None:
                m = self._abd_model
                parts.append(("abd_", m.broad_phase_overflow(m.world_points(self._abd_state.q))))
            for i, obj in enumerate(self.objects):
                if obj.model is not None and obj._union_range is None and hasattr(obj.model, "broad_phase_overflow"):
                    parts.append((f"obj{i}_", obj.model.broad_phase_overflow(obj.state.x)))
        return {prefix + k: v.cpu().numpy() for prefix, counts in parts for k, v in counts.items()}

    def check_health(self) -> dict[str, np.ndarray]:
        """Raise ``FloatingPointError`` naming the envs where an object's state
        went non-finite; count the broad phase's dropped pairs and warn (or
        raise, with ``contact.overflow_errors``) on any. Returns the counts."""
        for i, obj in enumerate(self.objects):
            x = self._abd_state.q if obj.is_affine_body else obj.state.x
            finite = torch.isfinite(x).flatten(1).all(-1).cpu().numpy()
            if not finite.all():
                bad = np.where(~finite)[0].tolist()
                raise FloatingPointError(
                    f"soft body {i} diverged (non-finite vertices) in envs {bad} at frame {self._frame_counter}; "
                    f"last good snapshot: {max(self._frames) if self._frames else 'none'}"
                )
        overflow = self.broad_phase_overflow()
        saturated = {k: v for k, v in overflow.items() if v.any()}
        if saturated:
            msg = (
                f"broad-phase overflow at frame {self._frame_counter}: "
                + ", ".join(f"{k}: {v.sum()} dropped pairs (envs {np.where(v > 0)[0].tolist()})"
                            for k, v in saturated.items())
                + " — pairs within barrier reach got no barrier; raise the matching contact *_k capacity"
            )
            if self.cfg.contact.overflow_errors:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return overflow

    # ------------------------------------------------------------- rendering
    def update_render_meshes(self) -> dict[int, torch.Tensor]:
        """(N, Vs, 3) surface vertex positions of each object."""
        return {i: obj.surface_positions() for i, obj in enumerate(self.objects)}

    # ----------------------------------------------------- checkpoint / replay
    @staticmethod
    def _clone(state):
        if state is None:
            return None
        return type(state)(*(getattr(state, f.name).clone() for f in dataclasses.fields(state)))

    def save_frame(self) -> int:
        """Snapshot every object's state (copies: a later write into the live
        state leaves the snapshot as it was)."""
        self._frames[self._frame_counter] = (
            [self._clone(obj.state) for obj in self.objects if not obj.is_affine_body],
            self._clone(self._abd_state),
            None if self._abd_aim_q is None else self._abd_aim_q.clone(),
        )
        while len(self._frames) > self.max_saved_frames:
            del self._frames[min(self._frames)]
        return self._frame_counter

    def replay_frame(self, frame: int) -> None:
        """Restore a snapshot (itself kept, so it can be replayed again)."""
        if frame not in self._frames:
            raise KeyError(f"no saved frame {frame}; saved: {sorted(self._frames)}")
        fem_states, abd_state, abd_aim = self._frames[frame]
        for obj, st in zip([o for o in self.objects if not o.is_affine_body], fem_states):
            obj.state = self._clone(st)
        self._abd_state = self._clone(abd_state)
        self._abd_aim_q = None if abd_aim is None else abd_aim.clone()
        if self._union_model is not None:
            self._union_state = SoftBodyState(
                x=torch.cat([o.state.x for o in self._union_objs], 1),
                v=torch.cat([o.state.v for o in self._union_objs], 1),
            )
            self._refresh_union_slices()
        self._frame_counter = frame

    # ------------------------------------------------------------- profiling
    def get_sim_time_report(self, as_json: bool = False):
        """Seconds of the last step / step_n (as a dict with ``as_json``)."""
        report = dict(self._timings)
        if as_json:
            return report
        return "\n".join(f"{k}: {v * 1e3:.2f} ms" for k, v in report.items())
