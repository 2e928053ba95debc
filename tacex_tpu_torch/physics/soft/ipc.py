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
Newton iterate, detached. When a gradient is asked for (some input of
``step`` requires grad), ``step`` is differentiable as the JAX solve is,
unrolled: the gradient and each Hessian-vector product keep their graphs
(``create_graph=True``), so CG's solution and every Newton step carry the
inputs' tangents, and the lag takes the straight-through tangent of the
lag at the step's start (JAX ``ipc.py:810-826``) with its primal
unchanged. The candidates, the floors, the line search's step lengths and
the convergence flags carry no gradient, as in JAX. Without a gradient the
solve runs as before: no graph outlives a Newton iteration.

The contact families of a nodal model (a union of several soft bodies is
one model) are here with their primitives: self contact (each surface
vertex against its K nearest non-adjacent surface triangles), edge-edge
contact (each surface edge against its K nearest higher-index non-adjacent
edges, weighted by the parallel-edge mollifier) and static trimesh
colliders (each surface vertex against its K nearest fixed triangles). Each
family's candidates are chosen at the step's start by centroid (or
midpoint) distance with a stable sort, so that a tie goes to the lower
index, as ``jax.lax.top_k``; the line search rejects a trial that brings a
pair under its distance floor or carries a vertex through a triangle or an
edge through an edge. ``broad_phase_overflow`` counts the pairs within
reach that the fixed-capacity candidate sets dropped. The coupled FEM+ABD
world (``coupled.py``) builds on the same pieces.

Shell (cloth) elements join a model through ``shell_elems`` (``codim.py``):
their membrane and bending energies over the same vertex array, their
masses added to the tets' lumped masses, so that cloth takes part in every
contact family as the union's and the coupled world's nodal system.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE, resolve
from ...ops import sdf as sdf_ops
from .codim import ShellElements, ShellElementsTorch, bending_energy, membrane_energy
from .fem import lame_params, lumped_masses, precompute_rest, stable_neo_hookean_energy
from .mesh import TetMesh


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


def _segment_segment_closest(p1, p2, q1, q2):
    """Closest points (cp, cq) between segments [p1, p2] and [q1, q2],
    broadcast over leading dims (Ericson 5.1.9 as a branch-free ``where``
    cascade). The parallel guard is scale-free: sin^2 of the angle between
    the segments, with the s = 0 endpoint solve below 1e-4."""
    d1, d2 = p2 - p1, q2 - q1
    r = p1 - q1
    a, e = _dot(d1, d1), _dot(d2, d2)
    f, c, b = _dot(d2, r), _dot(d1, r), _dot(d1, d2)
    ae = torch.clamp(a * e, min=1e-30)
    sin2 = torch.clamp(1.0 - (b * b) / ae, min=0.0)
    num_n = (b * f - c * e) / ae
    s_gen = _clip(num_n / torch.clamp(sin2, min=1e-4), 0.0, 1.0)
    s = torch.where(sin2 > 1e-4, s_gen, 0.0)
    # t for that s, then clamp it and recompute s (the two-pass fix-up)
    e_ok, a_ok = e > 1e-20, a > 1e-20
    t = torch.where(e_ok, (b * s + f) / torch.where(e_ok, e, 1.0), 0.0)
    t_cl = _clip(t, 0.0, 1.0)
    s2 = torch.where(a_ok, (b * t_cl - c) / torch.where(a_ok, a, 1.0), 0.0)
    s_fin = torch.where(t != t_cl, _clip(s2, 0.0, 1.0), s)
    return p1 + s_fin[..., None] * d1, q1 + t_cl[..., None] * d2


def _edge_edge_distance(p1, p2, q1, q2):
    """Unsigned segment-segment distance (eps under the sqrt, as the
    point-triangle one)."""
    cp, cq = _segment_segment_closest(p1, p2, q1, q2)
    return torch.sqrt(((cp - cq) ** 2).sum(-1) + 1e-18)


def _edge_pair_crossed(p1a, p2a, q1a, q2a, p1b, p2b, q1b, q2b, eps: float = 1e-3):
    """True where the edge pair (p, q) crossed between state a and state b:
    the signed line-line gap flips sign while the mutual closest points lie
    within both segments. Near-parallel pairs (sin^2 < 1e-4) are left out;
    their gap's sign is noise and the mollifier fades their barrier."""

    def gap_params(p1, p2, q1, q2):
        d1, d2 = p2 - p1, q2 - q1
        n = torch.linalg.cross(d1, d2, dim=-1)
        nn = torch.sqrt((n * n).sum(-1) + 1e-30)
        g = ((q1 - p1) * n).sum(-1) / nn
        r = p1 - q1
        a, e, b = _dot(d1, d1), _dot(d2, d2), _dot(d1, d2)
        c, f = _dot(d1, r), _dot(d2, r)
        ae = torch.clamp(a * e, min=1e-30)
        sin2 = torch.clamp(1.0 - (b * b) / ae, min=0.0)
        s = ((b * f - c * e) / ae) / torch.clamp(sin2, min=1e-4)
        e_ok = e > 1e-20
        t = torch.where(e_ok, (b * s + f) / torch.where(e_ok, e, 1.0), 0.0)
        return g, s, t, sin2

    ga = gap_params(p1a, p2a, q1a, q2a)[0]
    gb, sb, tb, sin2b = gap_params(p1b, p2b, q1b, q2b)
    interior = (sb > -eps) & (sb < 1.0 + eps) & (tb > -eps) & (tb < 1.0 + eps)
    return interior & (sin2b > 1e-4) & (ga * gb < 0)


def edge_edge_mollifier(p1, p2, q1, q2, eps_x):
    """IPC's parallel-edge mollifier (Li et al. 2020, 4.2): the edge-edge
    barrier is weighted by m(c) = (2 - c/eps_x)(c/eps_x), capped at 1, with
    c = |d1 x d2|^2, so that near-parallel pairs fade out smoothly."""
    cr = torch.linalg.cross(p2 - p1, q2 - q1, dim=-1)
    x = (cr * cr).sum(-1) / torch.clamp(eps_x, min=1e-30)
    return torch.where(x < 1.0, x * (2.0 - x), 1.0)


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


def scene_friction_basis(p: torch.Tensor, scene, kappa: float, d_hat: float, create_graph: bool = False):
    """(lambda_n, normal) of (N, P, 3) points against the scene: the
    barrier's force magnitude and the SDF's normalised gradient, detached;
    with ``create_graph`` differentiable in ``p`` and the scene (the normal
    through the SDF's second derivative)."""
    with torch.enable_grad():
        pv = p if create_graph and p.requires_grad else p.detach().requires_grad_(True)
        d = scene.sdf(pv)
        (n,) = torch.autograd.grad(d.sum(), pv, create_graph=create_graph)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    return barrier_force_mag(d if create_graph else d.detach(), kappa, d_hat), n


def friction_mollifier(s: torch.Tensor, eps: float) -> torch.Tensor:
    """IPC's smooth |u_t| in s = |u_t|^2: quadratic below eps, linear beyond,
    with a clamped sqrt argument so that both branches keep finite first and
    second derivatives at u_t = 0."""
    return torch.where(s < eps * eps, s / (2 * eps) + eps / 2, torch.sqrt(torch.maximum(s, s.new_full((), eps * eps))))


def derivatives(energy, x: torch.Tensor, graph: bool = False):
    """(E, grad, hvp) of a batched energy ``energy(x) -> (N,)`` at x
    (N, V, 3): its values, its gradient, and a function p -> H p of every
    env's Hessian. The gradient's graph is built once; each product is one
    backward through it (the envs' Hessians are independent blocks, so the
    gradient of the summed energy carries each env's own).

    With ``graph`` the gradient and the products keep their graphs, so they
    differentiate in ``x``, in ``p`` and in whatever the energy closes over
    (the counterpart of reverse mode through JAX's ``grad`` and
    ``jvp(grad)``). ``x`` enters as a view of itself, so the derivatives are
    the partial ones in the iterate even where the energy also reads ``x``
    through its step-start terms."""
    with torch.enable_grad():
        xv = x.view_as(x) if graph and x.requires_grad else x.detach().requires_grad_(True)
        e = energy(xv)
        (grad,) = torch.autograd.grad(e.sum(), xv, create_graph=True)

    def hvp(p: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            return torch.autograd.grad(grad, xv, grad_outputs=p, retain_graph=True, create_graph=graph)[0]

    return e.detach(), grad if graph else grad.detach(), hvp


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
    # candidates a surface vertex (edge) keeps of each contact family; 0 is off
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
    def empty(num_envs: int, s=1, b=1, c=1, p=1, t=0, device=DEFAULT_DEVICE) -> "RigidSdfScene":
        n = num_envs
        dev = resolve(device)
        return RigidSdfScene(
            spheres=torch.zeros((n, s, 4), device=dev),
            boxes=torch.zeros((n, b, 10), device=dev),
            capsules=torch.zeros((n, c, 8), device=dev),
            planes=torch.zeros((n, p, 4), device=dev),
            threads=torch.zeros((n, t, 12), device=dev) if t else None,
        )

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        """(N, P, 3) points -> (N, P) scene signed distance, each env's
        points against its own colliders (threads included)."""
        return sdf_ops.scene_sdf(p, self.spheres, self.boxes, self.capsules, self.planes, self.threads)

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


def scene_motion(prev: RigidSdfScene, curr: RigidSdfScene) -> torch.Tensor:
    """(N,) upper bound on how far any collider surface point moved between
    two frames, the quantity of the kinematic-collider CCD envelope: spheres
    |dc|; boxes |dc| + |dq| |half-diagonal|; capsules max(|da|, |db|);
    planes |d offset| + |dn| (a 1 m lever); threads |d base|. Disabled
    primitives count 0."""

    def mag(a, b, lo, hi):
        return torch.sqrt(((b[..., lo:hi] - a[..., lo:hi]) ** 2).sum(-1) + 1e-30)

    cb = curr.boxes
    moves = [
        torch.where(curr.spheres[..., 3] > 0, mag(prev.spheres, curr.spheres, 0, 3), 0.0),
        torch.where(
            cb[..., 7] > 0,
            mag(prev.boxes, cb, 0, 3) + mag(prev.boxes, cb, 3, 7) * torch.sqrt((cb[..., 7:10] ** 2).sum(-1) + 1e-30),
            0.0,
        ),
        torch.where(
            curr.capsules[..., 7] > 0,
            torch.maximum(mag(prev.capsules, curr.capsules, 0, 3), mag(prev.capsules, curr.capsules, 3, 6)),
            0.0,
        ),
        torch.where(
            (curr.planes[..., :3] ** 2).sum(-1) > 0.5,
            (curr.planes[..., 3] - prev.planes[..., 3]).abs() + mag(prev.planes, curr.planes, 0, 3),
            0.0,
        ),
    ]
    if curr.threads is not None:
        moves.append(mag(prev.threads, curr.threads, 0, 3))
    return torch.stack([m.amax(-1) for m in moves], -1).amax(-1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of x (N, V, d) at per-env indices idx (N, ...) -> (N, ..., d)."""
    n, d = x.shape[0], x.shape[-1]
    flat = idx.reshape(n, -1, 1).expand(-1, -1, d)
    return torch.gather(x, 1, flat).reshape(idx.shape + (d,))


def _centroids(x: torch.Tensor, elems: torch.Tensor) -> torch.Tensor:
    """(N, T, 3) element centroids of x (N, V, 3) for elements (T, k) of k
    vertex ids, summed corner by corner as JAX's mean."""
    k = elems.shape[1]
    return sum(x.index_select(1, elems[:, i]) for i in range(k)) / float(k)


def _sq_dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(N, P, Q) squared distances between the points p (N, P, 3) and q (N|1, Q, 3)."""
    diff = p[:, :, None, :] - q[:, None, :, :]
    return diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2


def _nearest(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of d2 (..., Q) and their indices;
    a tie goes to the lower index, as ``jax.lax.top_k``."""
    d2s, order = torch.sort(d2, dim=-1, stable=True)
    k = min(k, d2.shape[-1])
    return d2s[..., :k], order[..., :k]


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
        shell_elems: ShellElements | None = None,  # membrane and bending elements over the same vertices
        device=DEFAULT_DEVICE,
    ):
        self.mesh = mesh
        self.cfg = cfg or IpcSolverCfg()
        self.device = dev = resolve(device)
        c = self.cfg

        f32 = dict(dtype=torch.float32, device=dev)
        mu, lam = lame_params(youngs_modulus, poisson_ratio)
        self.mu = float(mu) if np.ndim(mu) == 0 else torch.as_tensor(np.asarray(mu), **f32)
        self.lam = float(lam) if np.ndim(lam) == 0 else torch.as_tensor(np.asarray(lam), **f32)
        dm_inv, vol = precompute_rest(mesh.points, mesh.tets)
        self.tets = torch.as_tensor(np.asarray(mesh.tets, np.int64), device=dev)
        self.dm_inv = torch.as_tensor(dm_inv, **f32)
        self.rest_vol = torch.as_tensor(vol, **f32)
        masses = np.asarray(lumped_masses(mesh.points, mesh.tets, mass_density))
        self.shell = None
        if shell_elems is not None and shell_elems.num_tris > 0:
            self.shell = ShellElementsTorch(shell_elems, dev)
            masses = masses + np.asarray(shell_elems.masses)
        assert (masses > 0).all(), "zero-mass vertex: every vertex must belong to a tet or a shell element"
        self.masses = torch.as_tensor(masses, **f32)  # (V,)
        sv = np.asarray(mesh.surface_verts, np.int64)
        self.surface_verts = torch.as_tensor(sv, device=dev)
        st = np.asarray(mesh.surface_tris, np.int64)
        self.surface_tris = torch.as_tensor(st, device=dev)  # (Ts, 3) vertex ids
        tri_pts = np.asarray(mesh.points)[st]
        self._tri_radius_max = float(np.linalg.norm(tri_pts - tri_pts.mean(1, keepdims=True), axis=-1).max())
        self._gravity = torch.tensor(c.gravity, **f32)
        # self contact: a vertex never meets a triangle it belongs to
        self._vt_exclude = torch.as_tensor((sv[:, None, None] == st[None, :, :]).any(-1), device=dev)  # (Vs, Ts)

        # the unique surface edges of edge-edge contact (only when it is on)
        self.edges = None
        if c.ee_contact_k > 0:
            e_all = np.concatenate([st[:, [0, 1]], st[:, [1, 2]], st[:, [2, 0]]])
            e_all.sort(axis=1)
            edges = np.unique(e_all, axis=0)
            self.edges = torch.as_tensor(edges, device=dev)  # (E, 2)
            # pairs sharing a vertex are excluded, and each unordered pair is kept once (i < j)
            share = (edges[:, None, :, None] == edges[None, :, None, :]).any(-1).any(-1)
            upper = np.arange(len(edges))[:, None] >= np.arange(len(edges))[None, :]
            self._ee_mask = torch.as_tensor(share | upper, device=dev)
            pts = np.asarray(mesh.points)
            elen2 = ((pts[edges[:, 1]] - pts[edges[:, 0]]) ** 2).sum(-1)
            self._edge_len2 = torch.as_tensor(np.asarray(elen2, np.float32), **f32)
            self._edge_halflen = torch.as_tensor(np.asarray(0.5 * np.sqrt(elen2), np.float32), **f32)

        # fixed triangle-soup colliders
        self.static_tris = self.static_cent = None
        if static_tris is not None and len(static_tris) > 0:
            self.static_tris = torch.as_tensor(np.asarray(static_tris, np.float32), **f32)  # (Tc, 3, 3)
            self.static_cent = (self.static_tris[:, 0] + self.static_tris[:, 1] + self.static_tris[:, 2]) / 3.0
            st64 = np.asarray(static_tris, np.float64)
            self._static_radius_max = float(np.linalg.norm(st64 - st64.mean(1, keepdims=True), axis=-1).max())

        # attachments: soft position constraints of strength ratio x m_i / dt^2 (shell masses included)
        if attachment_verts is None:
            attachment_verts = np.zeros((0,), np.int64)
        attachment_verts = np.asarray(attachment_verts, np.int64)
        self.attachment_verts = torch.as_tensor(attachment_verts, device=dev)
        k = attachment_strength_ratio * masses[attachment_verts] / c.dt**2
        self.attachment_k = torch.as_tensor(np.asarray(k, np.float32), **f32)[:, None]

    # ------------------------------------------------------ candidate sets
    def _self_d2(self, x):
        """(N, Vs, Ts) squared distances of the surface vertices to the
        surface-triangle centroids, inf at a vertex's own triangles."""
        d2 = _sq_dist(x.index_select(1, self.surface_verts), _centroids(x, self.surface_tris))
        return torch.where(self._vt_exclude, math.inf, d2)

    def _ee_d2(self, x):
        """(N, E, E) squared distances of the edge midpoints, inf at pairs
        that share a vertex and at j <= i."""
        mid = _centroids(x, self.edges)
        return torch.where(self._ee_mask, math.inf, _sq_dist(mid, mid))

    def _select_candidates(self, x):
        """Self contact: each surface vertex's K nearest non-adjacent surface
        triangles by centroid distance -> (cand, valid) (N, Vs, K); a
        candidate beyond barrier reach (3 d_hat + the largest triangle
        radius) is not valid."""
        d2k, cand = _nearest(self._self_d2(x), self.cfg.self_contact_k)
        cut = 3.0 * self.cfg.d_hat + self._tri_radius_max
        return cand, d2k < cut * cut

    def _select_ee_candidates(self, x):
        """Edge-edge: each surface edge's K nearest higher-index non-adjacent
        edges by midpoint distance -> (cand, valid) (N, E, K)."""
        d2k, cand = _nearest(self._ee_d2(x), self.cfg.ee_contact_k)
        cut = 3.0 * self.cfg.d_hat + self._edge_halflen[:, None] + self._edge_halflen[cand]
        return cand, d2k < cut * cut

    def _static_candidates(self, xs):
        """Static colliders: each surface vertex's K nearest fixed triangles by
        centroid distance -> (N, Vs, K) triangle ids."""
        return _nearest(_sq_dist(xs, self.static_cent[None]), self.cfg.static_contact_k)[1]

    def broad_phase_overflow(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per family, the candidates within barrier reach (the cut the
        candidate sets use) that fell outside the K nearest, summed over
        the vertices (edges) of each env -> {key: (N,) int64}; keys
        ``vt_self``, ``vt_static``, ``ee`` for the families that are on.
        The K nearest are kept, so a row drops exactly max(#within - K, 0).
        Nonzero means a pair within reach got no barrier this step: raise
        ``self_contact_k`` / ``static_contact_k`` / ``ee_contact_k``."""
        c = self.cfg
        out: dict[str, torch.Tensor] = {}

        def dropped(d2, cut, k):
            within = (d2 < cut * cut).sum(-1)
            return torch.clamp(within - k, min=0).sum(-1)

        if c.self_contact_k > 0:
            out["vt_self"] = dropped(self._self_d2(x), 3.0 * c.d_hat + self._tri_radius_max, c.self_contact_k)
        if self.static_tris is not None:
            d2 = _sq_dist(x.index_select(1, self.surface_verts), self.static_cent[None])
            k = min(c.static_contact_k, self.static_cent.shape[0])
            out["vt_static"] = dropped(d2, 3.0 * c.d_hat + self._static_radius_max, k)
        if self.edges is not None:
            cut = 3.0 * c.d_hat + self._edge_halflen[:, None] + self._edge_halflen[None, :]
            out["ee"] = dropped(self._ee_d2(x), cut, min(c.ee_contact_k, self.edges.shape[0]))
        return out

    def _families(self, x):
        """The step's contact families at its start x (N, V, 3), or None when
        every family is off: the candidate corners' vertex ids and validity
        of self contact and edge-edge contact (with each pair's mollifier
        scale), the static triangles' corners, and the no-worsening floors
        of the static and edge-edge distances."""
        c = self.cfg
        if c.self_contact_k <= 0 and self.static_tris is None and self.edges is None:
            return None
        fam = SimpleNamespace(self_idx=None, static_tri=None, ee_idx=None)
        xs = x.index_select(1, self.surface_verts)
        if c.self_contact_k > 0:
            cand, fam.self_valid = self._select_candidates(x)
            fam.self_idx = self.surface_tris[cand]  # (N, Vs, K, 3)
        if self.static_tris is not None:
            fam.static_tri = self.static_tris[self._static_candidates(xs)]  # (N, Vs, K, 3, 3)
            d = self._static_distances(xs, fam.static_tri)
            fam.s_floor = torch.clamp(0.999 * d.amin((-2, -1)), max=1e-7)
        if self.edges is not None:
            cand, fam.ee_valid = self._select_ee_candidates(x)
            fam.ee_idx = self.edges[cand]  # (N, E, K, 2)
            fam.ee_eps = 1e-3 * self._edge_len2[:, None] * self._edge_len2[cand]
            d = self._ee_distances(x, fam.ee_idx)
            fam.ee_floor = torch.clamp(0.999 * torch.where(fam.ee_valid, d, 1.0).amin((-2, -1)), max=1e-7)
        return fam

    # ----------------------------------------------------------- distances
    def _pair_distances(self, x, xs, idx):
        """(N, Vs, K) distances of the surface vertices xs to their candidate
        triangles, whose corners are the vertices idx (N, Vs, K, 3) of x."""
        tri = _gather(x, idx)
        return _point_triangle_distance(xs[:, :, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])

    @staticmethod
    def _static_distances(xs, tri):
        return _point_triangle_distance(xs[:, :, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])

    def _edge_rows(self, x):
        """(N, E, 2, 3) endpoints of every surface edge."""
        return x.index_select(1, self.edges.flatten()).unflatten(1, tuple(self.edges.shape))

    def _ee_distances(self, x, idx):
        """(N, E, K) distances of each surface edge to its candidate edges,
        whose endpoints are the vertices idx (N, E, K, 2) of x."""
        pi, pj = self._edge_rows(x), _gather(x, idx)
        return _edge_edge_distance(pi[:, :, None, 0], pi[:, :, None, 1], pj[..., 0, :], pj[..., 1, :])

    def _family_energy(self, x, xs, fam):
        """(N,) barrier energy of the self, static and edge-edge families; an
        invalid candidate sits at 10 d_hat, beyond the barrier's reach."""
        c = self.cfg
        e = x.new_zeros(x.shape[0])
        if fam.self_idx is not None:
            d = torch.where(fam.self_valid, self._pair_distances(x, xs, fam.self_idx), 10.0 * c.d_hat)
            e = e + barrier_extended(d, c.kappa, c.d_hat).sum((-2, -1))
        if fam.static_tri is not None:
            e = e + barrier_extended(self._static_distances(xs, fam.static_tri), c.kappa, c.d_hat).sum((-2, -1))
        if fam.ee_idx is not None:
            pi, pj = self._edge_rows(x), _gather(x, fam.ee_idx)
            a, b, p, q = pi[:, :, None, 0], pi[:, :, None, 1], pj[..., 0, :], pj[..., 1, :]
            d = torch.where(fam.ee_valid, _edge_edge_distance(a, b, p, q), 10.0 * c.d_hat)
            m = edge_edge_mollifier(a, b, p, q, fam.ee_eps)
            e = e + (m * barrier_extended(d, c.kappa, c.d_hat)).sum((-2, -1))
        return e

    def _family_feasible(self, fam, xx, xs_t, x_from, xs_f):
        """(N,) whether the trial xx (from x_from) keeps every family's pairs
        above their floors and crosses no candidate triangle or edge: self
        pairs in the triangles' co-moving frame, static ones against the
        fixed triangles, edge pairs by their signed gap."""
        ok = torch.ones(xx.shape[0], dtype=torch.bool, device=xx.device)
        if fam.self_idx is not None:
            valid = fam.self_valid
            ok = ok & (torch.where(valid, self._pair_distances(xx, xs_t, fam.self_idx), 1.0).amin((-2, -1)) > 1e-6)
            tri, tri0 = _gather(xx, fam.self_idx), _gather(x_from, fam.self_idx)
            crossed = _segment_crosses_moving_triangle(
                xs_f[:, :, None, :], xs_t[:, :, None, :], tri0[..., 0, :], tri0[..., 1, :], tri0[..., 2, :],
                tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
            )
            ok = ok & ~(crossed & valid).flatten(1).any(-1)
        if fam.static_tri is not None:
            tri = fam.static_tri
            ok = ok & (self._static_distances(xs_t, tri).amin((-2, -1)) > fam.s_floor)
            crossed = _segment_crosses_triangle(
                xs_f[:, :, None, :], xs_t[:, :, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
            )
            ok = ok & ~crossed.flatten(1).any(-1)
        if fam.ee_idx is not None:
            valid = fam.ee_valid
            ok = ok & (torch.where(valid, self._ee_distances(xx, fam.ee_idx), 1.0).amin((-2, -1)) > fam.ee_floor)
            pa, pja = self._edge_rows(x_from), _gather(x_from, fam.ee_idx)
            pb, pjb = self._edge_rows(xx), _gather(xx, fam.ee_idx)
            crossed = _edge_pair_crossed(
                pa[:, :, None, 0], pa[:, :, None, 1], pja[..., 0, :], pja[..., 1, :],
                pb[:, :, None, 0], pb[:, :, None, 1], pjb[..., 0, :], pjb[..., 1, :],
            )
            ok = ok & ~(crossed & valid).flatten(1).any(-1)
        return ok

    # ----------------------------------------------------------------- energy
    def _energy(self, x, x_tilde, scene, aim_pos, x_prev, friction_basis, dt, fam=None, with_sdf=False):
        """(N,) incremental potential of each env at x (N, V, 3), with the
        contact families ``fam`` (``_families``) when given; with
        ``with_sdf`` also the (N, Vs) surface signed distances it used."""
        c = self.cfg
        inertia = (0.5 / dt**2) * (self.masses[:, None] * (x - x_tilde) ** 2).sum((-2, -1))
        elastic = stable_neo_hookean_energy(x, self.tets, self.dm_inv, self.rest_vol, self.mu, self.lam)
        if self.shell is not None:
            elastic = elastic + membrane_energy(x, self.shell) + bending_energy(x, self.shell)
        xs = x.index_select(1, self.surface_verts)
        d = scene.sdf(xs)
        e = inertia + elastic + barrier_extended(d, c.kappa, c.d_hat).sum(-1)
        if fam is not None:
            e = e + self._family_energy(x, xs, fam)
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

    def _friction_lag(self, x_k, scene, create_graph=False):
        """(lambda_n, normal) of each surface vertex at the detached iterate
        ``x_k`` (with ``create_graph`` at ``x_k`` itself, differentiable):
        the normal is the scene SDF's gradient, normalised."""
        if self.cfg.friction_mu <= 0:
            return None
        xs = x_k.index_select(1, self.surface_verts)
        return scene_friction_basis(xs, scene, self.cfg.kappa, self.cfg.d_hat, create_graph)

    # -------------------------------------------------------------- one solve
    def _solve(self, x, v, scene, aim_pos, dt, graph=False):
        """One implicit step of every env at time step ``dt`` -> (x, v);
        with ``graph`` differentiable in every input (the module's
        docstring says how)."""
        c = self.cfg
        n = x.shape[0]
        x_tilde = x + dt * v + dt * dt * self._gravity
        # feasibility floor: penetration-free (d > 0) when the step starts
        # feasible, no-worsening when a collider moved into the gel
        d_floor = torch.clamp(scene.sdf(x.index_select(1, self.surface_verts)).amin(-1), max=0.0)
        precond = 1.0 / (self.masses[:, None] / dt**2)
        fam = self._families(x)

        def energy(xx, basis, with_sdf=False):
            return self._energy(xx, x_tilde, scene, aim_pos, x, basis, dt, fam, with_sdf)

        # the straight-through lag: the primal of the iterate's lag, the
        # tangent of the lag at the step's start (exact: it + 0)
        lag0 = self._friction_lag(x, scene, create_graph=True) if graph else None

        x_k = x
        done = torch.zeros((n,), dtype=torch.bool, device=x.device)
        for _ in range(c.newton_max_iter):
            basis = self._friction_lag(x_k, scene)
            if lag0 is not None:
                basis = tuple(it + (s0 - s0.detach()) for it, s0 in zip(basis, lag0))
            e0, g, hvp = derivatives(lambda xx: energy(xx, basis), x_k, graph)

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

            # backtracking line search: lower energy and feasible (its step
            # lengths carry no gradient, so it keeps no graph)
            alpha = torch.ones((n,), device=x.device)
            accepted = torch.zeros((n,), dtype=torch.bool, device=x.device)
            with torch.no_grad():
                for _ in range(c.line_search_iters):
                    x_try = x_k + alpha[:, None, None] * p
                    e_try, d_try = energy(x_try, basis, with_sdf=True)
                    ok = (e_try < e0) & (d_try.amin(-1) > d_floor)
                    if fam is not None:
                        sv = self.surface_verts
                        ok = ok & self._family_feasible(fam, x_try, x_try.index_select(1, sv), x_k,
                                                        x_k.index_select(1, sv))
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
        to the end-of-step value held for every substep.

        When grad is enabled and ``state``, an aim or a scene tensor requires
        grad, the returned state is differentiable in all of them (the
        unrolled gradient of the JAX solve), with the same primal."""
        inputs = (state.x, state.v, aim_pos, aim_prev)
        graph = torch.is_grad_enabled() and (
            any(t is not None and t.requires_grad for t in inputs)
            or scene.requires_grad() or (scene_prev is not None and scene_prev.requires_grad())
        )
        n = state.x.shape[0]
        if aim_pos is None:
            aim_pos = torch.zeros((n, max(int(self.attachment_verts.shape[0]), 1), 3), device=state.x.device)

        k = int(self.cfg.ccd_substeps)
        if k <= 1:
            x, v = self._solve(state.x, state.v, scene, aim_pos, self.cfg.dt, graph)
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
            x, v = self._solve(x, v, _lerp_scene(scene_prev, scene, tau), aim, dt_sub, graph)
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
