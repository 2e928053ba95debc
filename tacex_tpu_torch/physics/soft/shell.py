"""Batched implicit shell (cloth) solver with IPC barrier contact.

Port of ``tacex_tpu/physics/soft/shell.py``: one cloth shared by all envs,
state (N, V, 3), its membrane and bending elements from ``codim.py``
(libuipc's NeoHookeanShell and DiscreteShellBending). A step minimises

    E(x) = 1/(2 dt^2) ||x - x_tilde||^2_M + membrane(x) + bending(x)
           + barrier(sdf(x)) + barrier(static triangles) + attachments(x)
           + lagged friction(x)

as ``ipc.SoftBodyModel`` does: a fixed number of Newton iterations, each a
CG solve on Hessian-vector products preconditioned by the lumped mass, a
descent fallback to the preconditioned gradient, and a backtracking line
search that keeps every vertex above the scene colliders (no worse than at
the step's start), above a no-worsening floor of its distance to the static
triangle soup, and crossing none of its candidate static triangles. One
batched energy gives every env's gradient and, through one backward each,
every env's Hessian-vector product; per-env ``done``, ``accepted`` and
``alpha`` are (N,) tensors, so nothing in a step reads a value back to the
host.

The static triangles (fixed bodies: the bunny of the bunny-cloth sample)
enter through each vertex's K nearest triangle centroids at the step's
start, chosen by a stable sort (a tie goes to the lower index, as
``jax.lax.top_k``). Friction is lagged on the detached Newton iterate, the
primal of the JAX package's straight-through lag; the port has no gradient
through ``step`` (it raises for inputs that require grad).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE, resolve
from .codim import ShellElementsTorch, bending_energy, build_shell_elements, membrane_energy
from .ipc import (
    RigidSdfScene,
    SoftBodyState,
    _nearest,
    _point_triangle_distance,
    _segment_crosses_triangle,
    _sq_dist,
    barrier_extended,
    derivatives,
    friction_mollifier,
    scene_friction_basis,
)


@configclass
class ShellSolverCfg:
    dt: float = 0.01
    gravity: tuple = (0.0, 0.0, -9.81)
    newton_max_iter: int = 8
    velocity_tol: float = 0.05
    cg_iters: int = 24
    line_search_iters: int = 8
    d_hat: float = 0.002
    kappa: float = 1e4
    friction_mu: float = 0.5
    eps_velocity: float = 0.01
    damping: float = 0.0
    static_contact_k: int = 4  # candidate static triangles per cloth vertex


class ShellModel:
    """One cloth's constants on ``device`` and the batched step.

    Args:
      points: (V, 3) rest vertex positions; triangles: (T, 3) indices.
      youngs_modulus / poisson_ratio / thickness / mass_density: membrane
        parameters (NeoHookeanShell); bending_stiffness: DiscreteShellBending's E.
      static_tris: optional (Ts, 3, 3) world-frame triangle soup of fixed bodies.
      attachment_verts: pinned or aimed vertices (soft position constraints
        of strength ratio x m_i / dt^2).
    """

    def __init__(
        self,
        points: np.ndarray,
        triangles: np.ndarray,
        youngs_modulus: float = 1e4,
        poisson_ratio: float = 0.3,
        thickness: float = 0.001,
        mass_density: float = 200.0,
        bending_stiffness: float = 10.0,
        cfg: ShellSolverCfg | None = None,
        static_tris: np.ndarray | None = None,
        attachment_verts: np.ndarray | None = None,
        attachment_strength_ratio: float = 100.0,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = c = cfg or ShellSolverCfg()
        self.device = dev = resolve(device)
        f32 = dict(dtype=torch.float32, device=dev)
        P = np.asarray(points, np.float64)
        T = np.asarray(triangles, np.int64)
        self.num_vertices = len(P)
        self.tris = torch.as_tensor(T, device=dev)
        elems = build_shell_elements(
            P, T, youngs_modulus=youngs_modulus, poisson_ratio=poisson_ratio, thickness=thickness,
            mass_density=mass_density, bending_stiffness=bending_stiffness,
        )
        self.elems = ShellElementsTorch(elems, dev)
        self.masses = torch.as_tensor(elems.masses, **f32)
        self.hinges = self.elems.hinges
        self._gravity = torch.tensor(c.gravity, **f32)

        self.static_tris = self.static_cent = None
        if static_tris is not None and len(static_tris) > 0:
            self.static_tris = torch.as_tensor(np.asarray(static_tris, np.float32), **f32)  # (Ts, 3, 3)
            self.static_cent = (self.static_tris[:, 0] + self.static_tris[:, 1] + self.static_tris[:, 2]) / 3.0

        if attachment_verts is None:
            attachment_verts = np.zeros((0,), np.int64)
        attachment_verts = np.asarray(attachment_verts, np.int64)
        self.attachment_verts = torch.as_tensor(attachment_verts, device=dev)
        k = np.broadcast_to(np.asarray(attachment_strength_ratio, np.float64), (len(attachment_verts),))
        k = k * np.maximum(elems.masses[attachment_verts], 1e-9) / c.dt**2
        self.attachment_k = torch.as_tensor(np.asarray(k, np.float32), **f32)[:, None]
        self.surface_verts = torch.arange(self.num_vertices, device=dev)

    # ------------------------------------------------------------- energies
    def _static_distances(self, x, tri):
        """(N, V, K) distances of the vertices to their candidate static
        triangles, whose corners are tri (N, V, K, 3, 3)."""
        return _point_triangle_distance(x[:, :, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])

    def _energy(self, x, x_tilde, scene, aim_pos, x_prev, friction_basis, static_tri):
        """(E (N,), scene distances (N, V), static distances (N, V, K) or
        None) of each env at x (N, V, 3)."""
        c = self.cfg
        dx = x - x_tilde
        e = (0.5 / c.dt**2) * (self.masses[:, None] * dx * dx).sum((-2, -1))
        e = e + membrane_energy(x, self.elems) + bending_energy(x, self.elems)
        d = scene.sdf(x)
        e = e + barrier_extended(d, c.kappa, c.d_hat).sum(-1)
        ds = None
        if static_tri is not None:
            ds = self._static_distances(x, static_tri)
            e = e + barrier_extended(ds, c.kappa, c.d_hat).sum((-2, -1))
        if self.attachment_verts.shape[0] > 0:
            e = e + 0.5 * (self.attachment_k * (x.index_select(1, self.attachment_verts) - aim_pos) ** 2).sum((-2, -1))
        if friction_basis is not None:
            lam_n, n_dir = friction_basis  # (N, V), (N, V, 3): lagged
            du = x - x_prev
            du_t = du - (du * n_dir).sum(-1, keepdim=True) * n_dir
            e = e + c.friction_mu * (lam_n * friction_mollifier((du_t**2).sum(-1), c.eps_velocity * c.dt)).sum(-1)
        return e, d, ds

    # --------------------------------------------------------------- a solve
    def _solve(self, x, v, scene, aim_pos):
        """One implicit step of every env -> (x, v)."""
        c = self.cfg
        n = x.shape[0]
        x_tilde = x + c.dt * v + c.dt**2 * self._gravity
        static_tri = None
        if self.static_tris is not None:
            cand = _nearest(_sq_dist(x, self.static_cent[None]), c.static_contact_k)[1]
            static_tri = self.static_tris[cand]  # (N, V, K, 3, 3)
            # no-worsening floor of the static distances
            s_floor = torch.clamp(0.999 * self._static_distances(x, static_tri).amin((-2, -1)), max=1e-7)
        d_floor = torch.clamp(scene.sdf(x).amin(-1), max=0.0)
        precond = 1.0 / (self.masses[:, None] / c.dt**2)

        def energy(xx, basis):
            return self._energy(xx, x_tilde, scene, aim_pos, x, basis, static_tri)

        x_k = x
        done = torch.zeros((n,), dtype=torch.bool, device=x.device)
        for _ in range(c.newton_max_iter):
            basis = scene_friction_basis(x_k, scene, c.kappa, c.d_hat) if c.friction_mu > 0 else None
            e0, g, hvp = derivatives(lambda xx: energy(xx, basis)[0], x_k)

            r = -g
            z0 = precond * r
            z, p_dir, sol = z0, z0, torch.zeros_like(x_k)
            for _ in range(c.cg_iters):
                hp = hvp(p_dir)
                denom = (p_dir * hp).sum((-2, -1))
                rz = (r * z).sum((-2, -1))
                alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)[:, None, None]
                sol = sol + alpha * p_dir
                r = r - alpha * hp
                z_new = precond * r
                beta = torch.where(rz > 1e-20, (r * z_new).sum((-2, -1)) / rz, 0.0)[:, None, None]
                p_dir, z = z_new + beta * p_dir, z_new
            del hvp
            descent = (sol * g).sum((-2, -1)) < 0
            p = torch.where(descent[:, None, None], sol, -z0)

            alpha = torch.ones((n,), device=x.device)
            accepted = torch.zeros((n,), dtype=torch.bool, device=x.device)
            for _ in range(c.line_search_iters):
                x_try = x_k + alpha[:, None, None] * p
                e_try, d_try, ds_try = energy(x_try, basis)
                ok = (e_try < e0) & (d_try.amin(-1) > d_floor)
                if static_tri is not None:
                    crossed = _segment_crosses_triangle(
                        x_k[:, :, None, :], x_try[:, :, None, :],
                        static_tri[..., 0, :], static_tri[..., 1, :], static_tri[..., 2, :],
                    )
                    ok = ok & (ds_try.amin((-2, -1)) > s_floor) & ~crossed.flatten(1).any(-1)
                alpha = torch.where(ok | accepted, alpha, alpha * 0.5)
                accepted = ok | accepted
            alpha = torch.where(accepted, alpha, 0.0)

            step_vec = alpha[:, None, None] * p
            x_k = torch.where(done[:, None, None], x_k, x_k + step_vec)
            done = done | (step_vec.abs().amax((-2, -1)) / c.dt < c.velocity_tol)
        return x_k, (x_k - x) / c.dt * (1.0 - c.damping)

    # ---------------------------------------------------------------- public
    def step(self, state: SoftBodyState, scene: RigidSdfScene, aim_pos: torch.Tensor | None = None) -> SoftBodyState:
        """Advance all envs one dt; ``aim_pos``: (N, Va, 3) attachment targets."""
        if torch.is_grad_enabled() and (
            any(t is not None and t.requires_grad for t in (state.x, state.v, aim_pos)) or scene.requires_grad()
        ):
            raise RuntimeError(
                "ShellModel.step has no gradient in its inputs yet (ROADMAP Queue 1 item 3c); "
                "detach them or run under torch.no_grad()"
            )
        if aim_pos is None:
            aim_pos = state.x.new_zeros((state.x.shape[0], int(self.attachment_verts.shape[0]), 3))
        x, v = self._solve(state.x, state.v, scene, aim_pos)
        return SoftBodyState(x=x, v=v)

    def surface_positions(self, state: SoftBodyState) -> torch.Tensor:
        return state.x


def grid_cloth(nx: int = 20, ny: int = 20, size: float = 2.0, z: float = 1.0):
    """(points, triangles) of an nx-by-ny cloth grid (the bunny-cloth
    sample's grid20x20.obj scaled by 2)."""
    xs = np.linspace(-size / 2, size / 2, nx)
    ys = np.linspace(-size / 2, size / 2, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    P = np.stack([gx, gy, np.full_like(gx, z)], -1).reshape(-1, 3).astype(np.float32)
    T = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            v00 = i * ny + j
            v01 = v00 + 1
            v10 = v00 + ny
            v11 = v10 + 1
            T.append([v00, v10, v11])
            T.append([v00, v11, v01])
    return P, np.asarray(T, np.int32)
