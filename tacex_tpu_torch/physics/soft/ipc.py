"""Batched implicit FEM soft-body solver with barrier contact (IPC-style).

Port of ``tacex_tpu/physics/soft/ipc.py`` for a soft body against analytic
rigid colliders, the gel pad of the UIPC ball-rolling envs. One tet mesh is
shared by all envs; the state is ``(N, V, 3)``. A step minimises the
incremental potential

    E(x) = 1/(2 dt^2) ||x - x_tilde||^2_M + elastic(x) + barrier(sdf(x))
           + attachments(x) + lagged friction(x)

with a fixed number of Newton iterations, each a matrix-free preconditioned
CG solve on Hessian-vector products and a backtracking line search that
keeps every surface vertex outside the colliders. Converged envs take
zero-length steps (``torch.where``), so nothing in a step reads a value back
to the host.

The energy is one batched function of all envs with no cross-env term, so
its Hessian is block-diagonal: autograd of the summed energy gives every
env's gradient, and one backward of that gradient (built with
``create_graph=True`` once per Newton iteration) gives every env's
Hessian-vector product. Per-env scalars (``alpha``, ``beta``, the line
search's ``accepted``, ``done``) are (N,) tensors.

Friction is lagged: the normal force and direction are recomputed from each
Newton iterate, detached. The JAX package keeps the same values with a
straight-through tangent anchored at the step start, which only matters to
a gradient through ``step``; the port has none (``step`` raises for inputs
that require grad).

The vertex-triangle primitives (closest point, distance, and the
segment-crosses-triangle tests of the line search's feasibility check) are
here too: the coupled FEM+ABD world (``coupled.py``) builds its cross
barriers on them.

Not ported (they raise ``NotImplementedError``): self contact, static
trimesh colliders, edge-edge contact (and its primitives), shell elements
and the broad-phase overflow counters, none of which the UIPC, Grasp-Lift
or Factory-UIPC envs use.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE, resolve
from ...ops import sdf as sdf_ops
from .fem import lame_params, lumped_masses, precompute_rest, stable_neo_hookean_energy
from .mesh import TetMesh

UNPORTED = "is not ported yet (ROADMAP Queue 1 item 8: self, static-trimesh and edge-edge contact, shells)"


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a value on a bound takes half the gradient, as a tie of
    ``maximum``/``minimum`` splits it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(-1)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, with den replaced by 1e-30 where |den| <= 1e-30."""
    return num / torch.where(den.abs() > 1e-30, den, 1e-30)


def _point_triangle_closest(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, broadcast over leading dims
    (Ericson, Real-Time Collision Detection 5.1.5, as a ``where`` cascade)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_f = torch.clamp(va + vb + vc, min=1e-30)
    v_f = (vb / denom_f)[..., None]
    w_f = (vc / denom_f)[..., None]

    # edge parameters (guarded divisions)
    t_ab = _clip(_safe_div(d1, d1 - d3), 0.0, 1.0)[..., None]
    t_ac = _clip(_safe_div(d2, d2 - d6), 0.0, 1.0)[..., None]
    t_bc = _clip(_safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)[..., None]

    q = a + v_f * ab + w_f * ac  # the face region
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    at_a = (d1 <= 0) & (d2 <= 0)
    at_b = (d3 >= 0) & (d4 <= d3)
    at_c = (d6 >= 0) & (d5 <= d6)
    # later writes win: edges, then vertices
    q = torch.where(on_bc[..., None], b + t_bc * (c - b), q)
    q = torch.where(on_ac[..., None], a + t_ac * ac, q)
    q = torch.where(on_ab[..., None], a + t_ab * ab, q)
    q = torch.where(at_c[..., None], c, q)
    q = torch.where(at_b[..., None], b, q)
    return torch.where(at_a[..., None], a, q)


def _point_triangle_distance(p, a, b, c):
    """Unsigned point-triangle distance; the eps under the sqrt keeps the
    derivatives finite at zero distance."""
    q = _point_triangle_closest(p, a, b, c)
    return torch.sqrt(((p - q) ** 2).sum(-1) + 1e-18)


def _segment_crosses_triangle(p0, p1, a, b, c, eps: float = 1e-4):
    """True where the segment p0 -> p1 pierces triangle (a, b, c)
    (Moeller-Trumbore over broadcast leading dims): the line search rejects
    a step that carries a vertex through a triangle, which an unsigned
    distance barrier cannot see."""
    d = p1 - p0
    e1, e2 = b - a, c - a
    h = torch.linalg.cross(d, e2, dim=-1)
    det = _dot(e1, h)
    safe = det.abs() > 1e-14
    f = 1.0 / torch.where(safe, det, 1.0)
    s = p0 - a
    u = f * _dot(s, h)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    return safe & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps) & (t > -eps) & (t < 1.0 + eps)


def _segment_crosses_moving_triangle(p0, p1, a0, b0, c0, a1, b1, c1, eps: float = 1e-4):
    """The crossing test against a moving triangle, in its co-moving frame:
    the triangle's mean displacement is taken off the vertex's motion, and
    the segment tested against the end pose."""
    shift = ((a1 - a0) + (b1 - b0) + (c1 - c0)) / 3.0
    return _segment_crosses_triangle(p0 + shift, p1, a1, b1, c1, eps)


def barrier_extended(d, kappa: float, d_hat: float):
    """Per-distance IPC log-barrier with a C^2 quadratic extension below
    d0 = 0.1 d_hat (value, slope and curvature matched at d0), for vertices
    that start a step already penetrated. The log's argument is clamped to
    [d0, d_hat], so neither branch of the ``where`` is NaN under the double
    differentiation of the Hessian-vector products."""
    d0 = 0.1 * d_hat
    d_c = _clip(d, d0, d_hat)
    active = d < d_hat
    b_core = -kappa * (d_c - d_hat) ** 2 * torch.log(d_c / d_hat)
    lg = math.log(d0 / d_hat)
    b_d0 = -kappa * (d0 - d_hat) ** 2 * lg
    db_d0 = -kappa * (2.0 * (d0 - d_hat) * lg + (d0 - d_hat) ** 2 / d0)
    d2b_d0 = -kappa * (2.0 * lg + 4.0 * (d0 - d_hat) / d0 - (d0 - d_hat) ** 2 / d0**2)
    dd = d - d0
    b = torch.where(d < d0, b_d0 + db_d0 * dd + 0.5 * d2b_d0 * dd * dd, b_core)
    return torch.where(active, b, 0.0)


def barrier_force_mag(d, kappa: float, d_hat: float):
    """|d/dd barrier_extended(d)|: the normal force magnitude used as the
    lagged friction coefficient. Below d0 it is the derivative of the
    quadratic extension, as in ``barrier_extended``."""
    d0 = 0.1 * d_hat
    d_c = _clip(d, d0, d_hat)
    g_core = 2.0 * (d_c - d_hat) * torch.log(d_c / d_hat) + (d_c - d_hat) ** 2 / d_c
    lg = math.log(d0 / d_hat)
    db_d0 = 2.0 * (d0 - d_hat) * lg + (d0 - d_hat) ** 2 / d0
    d2b_d0 = 2.0 * lg + 4.0 * (d0 - d_hat) / d0 - (d0 - d_hat) ** 2 / d0**2
    g = torch.where(d < d0, db_d0 + d2b_d0 * (d - d0), g_core)
    return torch.where(d < d_hat, kappa * g.abs(), 0.0)


def scene_friction_basis(p: torch.Tensor, scene, kappa: float, d_hat: float):
    """(lambda_n, normal) of (N, P, 3) points against the scene, detached:
    the barrier's force magnitude and the SDF's normalised gradient."""
    with torch.enable_grad():
        pv = p.detach().requires_grad_(True)
        d = scene.sdf(pv)
        (n,) = torch.autograd.grad(d.sum(), pv)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    return barrier_force_mag(d.detach(), kappa, d_hat), n


def friction_mollifier(s: torch.Tensor, eps: float) -> torch.Tensor:
    """IPC's smooth |u_t| in s = |u_t|^2: quadratic below eps, linear beyond,
    with a clamped sqrt argument so that both branches keep finite first and
    second derivatives at u_t = 0."""
    return torch.where(s < eps * eps, s / (2 * eps) + eps / 2, torch.sqrt(torch.maximum(s, s.new_full((), eps * eps))))


def derivatives(energy, x: torch.Tensor):
    """(E, grad, hvp) of a batched energy ``energy(x) -> (N,)`` at x
    (N, V, 3): its values, its gradient, and a function p -> H p of every
    env's Hessian. The gradient's graph is built once; each product is one
    backward through it (the envs' Hessians are independent blocks, so the
    gradient of the summed energy carries each env's own)."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        e = energy(xv)
        (grad,) = torch.autograd.grad(e.sum(), xv, create_graph=True)

    def hvp(p: torch.Tensor) -> torch.Tensor:
        return torch.autograd.grad(grad, xv, grad_outputs=p, retain_graph=True)[0]

    return e.detach(), grad.detach(), hvp


@configclass
class IpcSolverCfg:
    """Solver configuration (a copy of the JAX package's; the knob names
    follow the reference's UipcSimCfg)."""

    dt: float = 0.01
    gravity: tuple = (0.0, 0.0, -9.81)
    newton_max_iter: int = 8
    velocity_tol: float = 0.05  # m/s — per-vertex |dx|/dt convergence norm
    cg_iters: int = 24
    line_search_iters: int = 8
    d_hat: float = 0.001  # barrier activation distance (m)
    kappa: float = 1e4  # barrier stiffness
    friction_mu: float = 0.5  # default_friction_ratio
    eps_velocity: float = 0.01  # friction smoothing velocity (m/s)
    damping: float = 0.0
    # the contact families below are not ported: nonzero k raises
    self_contact_k: int = 0
    static_contact_k: int = 4
    ee_contact_k: int = 0
    # kinematic-collider CCD fallback: k equal substeps a step, against scene
    # poses interpolated from the previous frame's to the current one's
    ccd_substeps: int = 1


@dataclasses.dataclass(frozen=True)
class SoftBodyState:
    x: torch.Tensor  # (N, V, 3)
    v: torch.Tensor  # (N, V, 3)

    @staticmethod
    def init(num_envs: int, points: np.ndarray, device=DEFAULT_DEVICE) -> "SoftBodyState":
        x = torch.as_tensor(np.asarray(points, np.float32), device=resolve(device))
        x = x.expand((num_envs,) + x.shape).clone()
        return SoftBodyState(x=x, v=torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class RigidSdfScene:
    """Per-env analytic rigid colliders (the same capacities in every env)."""

    spheres: torch.Tensor  # (N, S, 4)
    boxes: torch.Tensor  # (N, B, 10)
    capsules: torch.Tensor  # (N, C, 8)
    planes: torch.Tensor  # (N, P, 4)
    threads: torch.Tensor | None = None  # (N, T, 12)

    @staticmethod
    def empty(num_envs: int, s=1, b=1, c=1, p=1, device=DEFAULT_DEVICE) -> "RigidSdfScene":
        n = num_envs
        dev = resolve(device)
        return RigidSdfScene(
            spheres=torch.zeros((n, s, 4), device=dev),
            boxes=torch.zeros((n, b, 10), device=dev),
            capsules=torch.zeros((n, c, 8), device=dev),
            planes=torch.zeros((n, p, 4), device=dev),
        )

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        """(N, P, 3) points -> (N, P) scene signed distance, each env's
        points against its own colliders."""
        if self.threads is not None:
            raise NotImplementedError(
                "thread colliders in the soft-body scene are not ported yet "
                "(ROADMAP Queue 1 item 9: the UIPC API and screw_and_nut)"
            )
        return sdf_ops.scene_sdf(p, self.spheres, self.boxes, self.capsules, self.planes)

    def requires_grad(self) -> bool:
        return any(getattr(self, f.name) is not None and getattr(self, f.name).requires_grad
                   for f in dataclasses.fields(self))


def _lerp_scene(prev: RigidSdfScene, curr: RigidSdfScene, tau: float) -> RigidSdfScene:
    """Scene poses at ``tau`` in [0, 1] between two frames; box quaternions
    are renormalised after the lerp (``prev``'s already share ``curr``'s
    hemisphere)."""
    sc = RigidSdfScene(
        *(None if b is None else a + tau * (b - a)
          for a, b in ((getattr(prev, f.name), getattr(curr, f.name)) for f in dataclasses.fields(curr)))
    )
    q = sc.boxes[..., 3:7]
    q = q / torch.sqrt((q**2).sum(-1, keepdim=True) + 1e-30)
    return dataclasses.replace(sc, boxes=torch.cat([sc.boxes[..., :3], q, sc.boxes[..., 7:]], -1))


class SoftBodyModel:
    """Static per-topology data on the device and the batched step."""

    def __init__(
        self,
        mesh: TetMesh,
        youngs_modulus=1.45e5,  # Pa, scalar or (T,) per-tet
        poisson_ratio=0.45,  # scalar or (T,)
        mass_density=1000.0,  # scalar or (T,)
        cfg: IpcSolverCfg | None = None,
        attachment_verts: np.ndarray | None = None,
        attachment_strength_ratio=100.0,  # scalar or (Va,)
        static_tris: np.ndarray | None = None,
        shell_elems=None,
        device=DEFAULT_DEVICE,
    ):
        self.mesh = mesh
        self.cfg = cfg or IpcSolverCfg()
        self.device = dev = resolve(device)
        c = self.cfg
        if c.self_contact_k > 0:
            raise NotImplementedError(f"self contact (self_contact_k={c.self_contact_k}) {UNPORTED}")
        if c.ee_contact_k > 0:
            raise NotImplementedError(f"edge-edge contact (ee_contact_k={c.ee_contact_k}) {UNPORTED}")
        if static_tris is not None and len(static_tris) > 0:
            raise NotImplementedError(f"static trimesh colliders (static_tris) {UNPORTED}")
        if shell_elems is not None and shell_elems.num_tris > 0:
            raise NotImplementedError(f"shell elements (shell_elems) {UNPORTED}")

        f32 = dict(dtype=torch.float32, device=dev)
        mu, lam = lame_params(youngs_modulus, poisson_ratio)
        self.mu = float(mu) if np.ndim(mu) == 0 else torch.as_tensor(np.asarray(mu), **f32)
        self.lam = float(lam) if np.ndim(lam) == 0 else torch.as_tensor(np.asarray(lam), **f32)
        dm_inv, vol = precompute_rest(mesh.points, mesh.tets)
        self.tets = torch.as_tensor(np.asarray(mesh.tets, np.int64), device=dev)
        self.dm_inv = torch.as_tensor(dm_inv, **f32)
        self.rest_vol = torch.as_tensor(vol, **f32)
        masses = np.asarray(lumped_masses(mesh.points, mesh.tets, mass_density))
        assert (masses > 0).all(), "zero-mass vertex: every vertex must belong to a tet"
        self.masses = torch.as_tensor(masses, **f32)  # (V,)
        self.surface_verts = torch.as_tensor(np.asarray(mesh.surface_verts, np.int64), device=dev)
        st = np.asarray(mesh.surface_tris, np.int64)
        self.surface_tris = torch.as_tensor(st, device=dev)  # (Ts, 3) vertex ids
        tri_pts = np.asarray(mesh.points)[st]
        self._tri_radius_max = float(np.linalg.norm(tri_pts - tri_pts.mean(1, keepdims=True), axis=-1).max())
        self._gravity = torch.tensor(c.gravity, **f32)

        # attachments: soft position constraints of strength ratio x m_i / dt^2
        if attachment_verts is None:
            attachment_verts = np.zeros((0,), np.int64)
        attachment_verts = np.asarray(attachment_verts, np.int64)
        self.attachment_verts = torch.as_tensor(attachment_verts, device=dev)
        k = attachment_strength_ratio * masses[attachment_verts] / c.dt**2
        self.attachment_k = torch.as_tensor(np.asarray(k, np.float32), **f32)[:, None]

    # ------------------------------------------------------------- unported
    def broad_phase_overflow(self, x):
        raise NotImplementedError(f"broad_phase_overflow (the candidate-set counters) {UNPORTED}")

    # ----------------------------------------------------------------- energy
    def _energy(self, x, x_tilde, scene, aim_pos, x_prev, friction_basis, dt, with_sdf=False):
        """(N,) incremental potential of each env at x (N, V, 3); with
        ``with_sdf`` also the (N, Vs) surface signed distances it used."""
        c = self.cfg
        inertia = (0.5 / dt**2) * (self.masses[:, None] * (x - x_tilde) ** 2).sum((-2, -1))
        elastic = stable_neo_hookean_energy(x, self.tets, self.dm_inv, self.rest_vol, self.mu, self.lam)
        xs = x.index_select(1, self.surface_verts)
        d = scene.sdf(xs)
        e = inertia + elastic + barrier_extended(d, c.kappa, c.d_hat).sum(-1)
        if self.attachment_verts.shape[0] > 0:
            dx = x.index_select(1, self.attachment_verts) - aim_pos
            e = e + 0.5 * (self.attachment_k * dx**2).sum((-2, -1))
        if friction_basis is not None:
            lam_n, n_dir = friction_basis  # (N, Vs), (N, Vs, 3): lagged
            du = xs - x_prev.index_select(1, self.surface_verts)
            du_t = du - (du * n_dir).sum(-1, keepdim=True) * n_dir
            f0 = friction_mollifier((du_t**2).sum(-1), c.eps_velocity * dt)
            e = e + c.friction_mu * (lam_n * f0).sum(-1)
        return (e, d) if with_sdf else e

    def _friction_lag(self, x_k, scene):
        """(lambda_n, normal) of each surface vertex at the detached iterate
        ``x_k``: the normal is the scene SDF's gradient, normalised."""
        if self.cfg.friction_mu <= 0:
            return None
        return scene_friction_basis(x_k.index_select(1, self.surface_verts), scene, self.cfg.kappa, self.cfg.d_hat)

    # -------------------------------------------------------------- one solve
    def _solve(self, x, v, scene, aim_pos, dt):
        """One implicit step of every env at time step ``dt`` -> (x, v)."""
        c = self.cfg
        n = x.shape[0]
        x_tilde = x + dt * v + dt * dt * self._gravity
        # feasibility floor: penetration-free (d > 0) when the step starts
        # feasible, no-worsening when a collider moved into the gel
        d_floor = torch.clamp(scene.sdf(x.index_select(1, self.surface_verts)).amin(-1), max=0.0)
        precond = 1.0 / (self.masses[:, None] / dt**2)

        def energy(xx, basis, with_sdf=False):
            return self._energy(xx, x_tilde, scene, aim_pos, x, basis, dt, with_sdf)

        x_k = x
        done = torch.zeros((n,), dtype=torch.bool, device=x.device)
        for _ in range(c.newton_max_iter):
            basis = self._friction_lag(x_k, scene)
            e0, g, hvp = derivatives(lambda xx: energy(xx, basis), x_k)

            # matrix-free CG, Jacobi-like preconditioned by the lumped mass
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

            # preconditioned gradient descent where CG's direction does not descend
            descent = (sol * g).sum((-2, -1)) < 0
            p = torch.where(descent[:, None, None], sol, -z0)

            # backtracking line search: lower energy and feasible
            alpha = torch.ones((n,), device=x.device)
            accepted = torch.zeros((n,), dtype=torch.bool, device=x.device)
            for _ in range(c.line_search_iters):
                e_try, d_try = energy(x_k + alpha[:, None, None] * p, basis, with_sdf=True)
                ok = (e_try < e0) & (d_try.amin(-1) > d_floor)
                alpha = torch.where(ok | accepted, alpha, alpha * 0.5)
                accepted = ok | accepted
            alpha = torch.where(accepted, alpha, 0.0)

            step_vec = alpha[:, None, None] * p
            x_k = torch.where(done[:, None, None], x_k, x_k + step_vec)
            # converged: the largest vertex displacement rate below tolerance
            max_rate = step_vec.abs().amax((-2, -1)) / c.dt
            done = done | (max_rate < c.velocity_tol)
        return x_k, (x_k - x) / c.dt * (1.0 - c.damping)

    # ----------------------------------------------------------------- public
    def step(
        self,
        state: SoftBodyState,
        scene: RigidSdfScene,
        aim_pos: torch.Tensor | None = None,
        scene_prev: RigidSdfScene | None = None,
        aim_prev: torch.Tensor | None = None,
    ) -> SoftBodyState:
        """Advance all envs one dt. ``aim_pos``: (N, Va, 3) attachment targets.

        With ``cfg.ccd_substeps = k > 1`` the step runs k solves at dt/k
        against scene poses linearly interpolated ``scene_prev`` -> ``scene``
        (and attachment targets ``aim_prev`` -> ``aim_pos``); either defaults
        to the end-of-step value held for every substep."""
        inputs = (state.x, state.v, aim_pos, aim_prev)
        if torch.is_grad_enabled() and (
            any(t is not None and t.requires_grad for t in inputs)
            or scene.requires_grad() or (scene_prev is not None and scene_prev.requires_grad())
        ):
            raise RuntimeError(
                "SoftBodyModel.step has no gradient in its inputs yet (ROADMAP Queue 1 item 3b); "
                "detach them or run under torch.no_grad()"
            )
        n = state.x.shape[0]
        if aim_pos is None:
            aim_pos = torch.zeros((n, max(int(self.attachment_verts.shape[0]), 1), 3), device=state.x.device)

        k = int(self.cfg.ccd_substeps)
        if k <= 1:
            x, v = self._solve(state.x, state.v, scene, aim_pos, self.cfg.dt)
            return SoftBodyState(x=x, v=v)

        if scene_prev is None:
            scene_prev = scene
        # flip the previous box quaternions into the current ones' hemisphere
        qp, qc = scene_prev.boxes[..., 3:7], scene.boxes[..., 3:7]
        qp = torch.where((qp * qc).sum(-1, keepdim=True) < 0, -qp, qp)
        scene_prev = dataclasses.replace(
            scene_prev, boxes=torch.cat([scene_prev.boxes[..., :3], qp, scene_prev.boxes[..., 7:]], -1)
        )
        a_prev = aim_pos if aim_prev is None else aim_prev
        dt_sub = self.cfg.dt / k
        x, v = state.x, state.v
        for i in range(1, k + 1):
            tau = float(np.float32(i) / np.float32(k))
            aim = a_prev + tau * (aim_pos - a_prev)
            x, v = self._solve(x, v, _lerp_scene(scene_prev, scene, tau), aim, dt_sub)
        return SoftBodyState(x=x, v=v)

    def surface_positions(self, state: SoftBodyState) -> torch.Tensor:
        return state.x.index_select(1, self.surface_verts)

    def sphere_contact_force(self, state: SoftBodyState, scene: RigidSdfScene) -> torch.Tensor:
        """Reaction force the gel exerts on each sphere collider -> (N, S, 3):
        -dE_barrier/d(center) at the solved gel configuration. Gradients reach
        a sphere only through the surface vertices whose nearest primitive it
        is (the scene SDF's minimum)."""
        c = self.cfg
        with torch.enable_grad():
            sph = scene.spheres.detach().requires_grad_(True)
            d = dataclasses.replace(scene, spheres=sph).sdf(self.surface_positions(state).detach())
            (g,) = torch.autograd.grad(barrier_extended(d, c.kappa, c.d_hat).sum(), sph)
        return -g[..., :3]
