"""Affine body dynamics (ABD): bodies of 12 generalized DOFs with IPC contact.

Port of ``tacex_tpu/physics/soft/abd.py``. Each body has
``q = [t | a1 | a2 | a3]`` (translation, then the rows of the affine matrix
A); a body vertex sits at ``x = A p + t``. The incremental potential of a
step is

    E(q) = 1/(2 dt^2) (q - q_tilde)^T M (q - q_tilde) + kappa V ||A^T A - I||^2
           + barrier(sdf(x)) + body-body barriers + soft-transform constraint
           + lagged friction (against the scene and between bodies),

batched over a leading env axis. The body's constants (its 12x12
generalized mass from the surface mesh's moments, its inverse, the
generalized gravity force) are computed in float64 numpy and sent to the
device once.

Body-body contact: each vertex against the K nearest triangle centroids of
the other bodies (``contact_k``) and each surface edge against the K
nearest edge midpoints of higher-index bodies (``ee_contact_k``, weighted
by the parallel-edge mollifier), chosen at the step's start with a stable
sort (ties to the lower index, as ``jax.lax.top_k``). Pair friction
anchors the other body's closest material point in its body frame.

``AbdModel.step`` is the standalone solve: a fixed number of Newton
iterations, each a dense solve of every env's full (12B, 12B) Hessian
(``linear_solver="dense"``: the gradient's graph built once, then one
batched backward over the 12B unit vectors) or matrix-free CG with a
per-body block preconditioner (``"cg"``), then a backtracking line search
that keeps each trial above the scene, vertex-triangle and edge-edge
floors and crossing no candidate triangle or edge. ``analytic_hessian``
assembles the Hessian as J^T G J from small per-point Hessians instead.
Converged envs take zero-length steps (``torch.where``), so nothing in a
step reads a value back to the host. The coupled FEM+ABD world
(``coupled.py``) runs this energy inside its own solve.

``rotate_target`` advances a RotatingMotor's target, as the UIPC scene
API (``tacex_tpu_torch.uipc``) drives motors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE, resolve
from .ipc import (
    _centroids,
    _edge_edge_distance,
    _edge_pair_crossed,
    _gather,
    _nearest,
    _point_triangle_closest,
    _point_triangle_distance,
    _segment_crosses_moving_triangle,
    _sq_dist,
    barrier_extended,
    barrier_force_mag,
    derivatives,
    edge_edge_mollifier,
    friction_mollifier,
    scene_friction_basis,
)


@configclass
class AbdSolverCfg:
    """Solver configuration (a copy of the JAX package's)."""

    dt: float = 0.01
    gravity: tuple = (0.0, 0.0, -9.81)
    newton_max_iter: int = 8
    line_search_iters: int = 10
    velocity_tol: float = 0.01  # m/s — generalized step rate convergence
    d_hat: float = 0.001
    kappa_contact: float = 1e4
    friction_mu: float = 0.5
    eps_velocity: float = 0.01
    contact_k: int = 8  # body-body candidate triangles per surface vertex (0 = off)
    ee_contact_k: int = 4  # body-body edge-edge candidate edges per surface edge (0 = off)
    hessian_reg: float = 1e-6  # per-DOF Tikhonov shift of the dense Newton solve
    linear_solver: str = "dense"  # the standalone solve's: "dense" (full Hessian, LU) or "cg"
    cg_iters: int = 32
    analytic_hessian: bool = False  # the dense Hessian as J^T G J instead of autograd


@dataclasses.dataclass(frozen=True)
class AbdState:
    q: torch.Tensor  # (N, B, 12): [t(3), a1(3), a2(3), a3(3)] per body
    qd: torch.Tensor  # (N, B, 12)

    @staticmethod
    def identity(num_envs: int, num_bodies: int, offsets: np.ndarray | None = None,
                 device=DEFAULT_DEVICE) -> "AbdState":
        q0 = np.zeros((num_bodies, 12), np.float32)
        q0[:, 3] = q0[:, 7] = q0[:, 11] = 1.0  # A = I
        if offsets is not None:
            q0[:, :3] = offsets
        q = torch.as_tensor(q0, device=resolve(device)).expand(num_envs, num_bodies, 12).clone()
        return AbdState(q=q, qd=torch.zeros_like(q))


def q_to_affine(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q (..., 12) -> (A (..., 3, 3), t (..., 3))."""
    return q[..., 3:].unflatten(-1, (3, 3)), q[..., :3]


def embed_points(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """x = A p + t. q: (..., 12); pts: (V, 3) -> (..., V, 3)."""
    A, t = q_to_affine(q)
    return torch.einsum("...ij,vj->...vi", A, pts) + t[..., None, :]


def rotation_about(axis, angle: float, device=DEFAULT_DEVICE) -> torch.Tensor:
    """(3, 3) rotation by ``angle`` about ``axis`` (Rodrigues), built on the
    host in float32 as the JAX package's and sent to the device once."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    c, s = np.float32(np.cos(angle)), np.float32(np.sin(angle))
    K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]], np.float32)
    R = np.eye(3, dtype=np.float32) + s * K + (np.float32(1) - c) * (K @ K)
    return torch.as_tensor(R, device=resolve(device))


def rotate_target(q_star: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """RotatingMotor: advance a target pose q_star (..., 12) by the rotation
    R (3, 3) (``rotation_about``) about the body's own origin, A -> R A."""
    A, t = q_to_affine(q_star)
    return torch.cat([t, (R @ A).flatten(-2)], -1)


def inverse3(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices as the adjugate over the cofactor
    determinant (``torch.linalg.inv`` checks its result on the host)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def ortho_hessian(q: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """The (..., 9, 9) Hessian of kappa ||A^T A - I||_F^2 in the rows of A
    (``a[3p + q] = A[p, q]``), in closed form:
    H[(p,q),(r,s)] = 4 kappa (delta_pr M_qs + A_ps A_rq + delta_qs (A A^T)_pr),
    M = A^T A - I. ``kappa``: broadcast against the leading dims."""
    A, _ = q_to_affine(q)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A.transpose(-1, -2) @ A - eye
    AAt = A @ A.transpose(-1, -2)
    h = (
        torch.einsum("pr,...qs->...pqrs", eye, M)
        + torch.einsum("...ps,...rq->...pqrs", A, A)
        + torch.einsum("qs,...pr->...pqrs", eye, AAt)
    )
    return 4.0 * kappa[..., None, None] * h.reshape(h.shape[:-4] + (9, 9))


def _mesh_moments(P: np.ndarray, T: np.ndarray):
    """Volume, centroid and second moment of a closed triangle mesh
    (divergence theorem over the surface; triangles consistently oriented)."""
    a, b, c = P[T[:, 0]], P[T[:, 1]], P[T[:, 2]]
    det = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 x the signed tet volume
    vol = det.sum() / 6.0
    if vol < 0:
        vol, det = -vol, -det
    com = ((a + b + c) / 4.0 * (det[:, None] / 6.0)).sum(0) / max(vol, 1e-12)
    # the second moment of tet (0, a, b, c): vol_t / 20 (V^T (1 + I) V)
    Sig = np.zeros((3, 3))
    for i in range(len(T)):
        V = np.stack([a[i], b[i], c[i]])
        Sig += det[i] / 6.0 * (V.T @ (np.ones((3, 3)) + np.eye(3)) @ V / 20.0)
    return float(vol), com, Sig


class AbdModel:
    """B affine bodies with fixed surface meshes, their constants on the device.

    Args:
      points: list of (V_b, 3) rest vertices per body (local frame).
      triangles: list of (T_b, 3) surface triangles per body.
      mass_density: scalar or per body (kg/m^3; the volume comes from the
        surface mesh).
      kappa_ortho: scalar or per body, the orthogonality stiffness.
    """

    def __init__(
        self,
        points: list[np.ndarray],
        triangles: list[np.ndarray],
        mass_density=1000.0,
        kappa_ortho=1e7,
        cfg: AbdSolverCfg | None = None,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = c = cfg or AbdSolverCfg()
        self.device = dev = resolve(device)
        B = len(points)
        self.num_bodies = B
        dens = np.broadcast_to(np.asarray(mass_density, np.float64), (B,))
        kap = np.broadcast_to(np.asarray(kappa_ortho, np.float64), (B,))

        all_pts, all_tris, body_of_vert, body_of_tri = [], [], [], []
        M_blocks, grav_force, volumes = [], [], []
        g_vec = np.asarray(c.gravity, np.float64)
        off = 0
        for b, (P, T) in enumerate(zip(points, triangles)):
            P = np.asarray(P, np.float64)
            T = np.asarray(T, np.int64)
            vol, com, C = _mesh_moments(P, T)
            vol = max(vol, 1e-12)
            m = dens[b] * vol
            volumes.append(vol)
            # x_k = t_k + a_k . p: M[t_k, t_k] = m, M[t_k, a_k] = (m c)^T,
            # M[a_k, a_k] = Sigma = dens * (second moment)
            M = np.zeros((12, 12))
            M[:3, :3] = m * np.eye(3)
            for k in range(3):
                rows = slice(3 + 3 * k, 6 + 3 * k)
                M[k, rows] = m * com
                M[rows, k] = m * com
                M[rows, rows] = dens[b] * C
            M_blocks.append(M)
            # generalized gravity force: f_t = m g, f_{a_k} = m g_k c
            f = np.zeros(12)
            f[:3] = m * g_vec
            for k in range(3):
                f[3 + 3 * k : 6 + 3 * k] = m * g_vec[k] * com
            grav_force.append(f)
            all_pts.append(P)
            all_tris.append(T + off)
            body_of_vert.append(np.full(len(P), b))
            body_of_tri.append(np.full(len(T), b))
            off += len(P)

        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        pts_cat, tris_cat = np.concatenate(all_pts), np.concatenate(all_tris)
        vert_body = np.concatenate(body_of_vert)
        self.volumes = torch.as_tensor(np.asarray(volumes), **f32)
        self.kappa_ortho = torch.as_tensor(kap * np.asarray(volumes), **f32)  # (B,)
        self.mass = torch.as_tensor(np.stack(M_blocks), **f32)  # (B, 12, 12)
        self.pts = torch.as_tensor(pts_cat, **f32)  # (Vt, 3)
        self.tris = torch.as_tensor(tris_cat, **i64)  # (Tt, 3)
        self.vert_body = torch.as_tensor(vert_body, **i64)  # (Vt,)
        self.tri_body = torch.as_tensor(np.concatenate(body_of_tri), **i64)  # (Tt,)
        tri_pts = pts_cat[tris_cat]
        self._tri_radius_max = float(np.linalg.norm(tri_pts - tri_pts.mean(1, keepdims=True), axis=-1).max())
        self.gravity_q = torch.as_tensor(np.stack(grav_force), **f32)  # (B, 12)
        self.mass_inv = torch.as_tensor(np.linalg.inv(np.stack(M_blocks) + 1e-9 * np.eye(12)), **f32)
        self._q_gravity = torch.einsum("bij,bj->bi", self.mass_inv, self.gravity_q)  # (B, 12): M^-1 f_g
        self._eye3 = torch.eye(3, **f32)
        self._eye12 = torch.eye(12, **f32)
        self._eye_q = torch.eye(12 * B, **f32)
        # a vertex never meets its own body's triangles
        self._same_body = self.vert_body[:, None] == self.tri_body[None, :] if c.contact_k > 0 else None  # (Vt, Tt)
        # the unique surface edges (global vertex ids) of edge-edge pairs;
        # an edge meets only the edges of higher-index bodies
        e_all = np.concatenate([tris_cat[:, [0, 1]], tris_cat[:, [1, 2]], tris_cat[:, [2, 0]]])
        e_all.sort(axis=1)
        edges = np.unique(e_all, axis=0)
        self.edges = torch.as_tensor(edges, **i64)  # (E, 2)
        self.edge_body = torch.as_tensor(vert_body[edges[:, 0]], **i64)  # (E,)
        self._ee_mask = self.edge_body[:, None] >= self.edge_body[None, :] if self._ee_on else None  # (E, E)
        elen2 = ((pts_cat[edges[:, 1]] - pts_cat[edges[:, 0]]) ** 2).sum(-1)
        self._edge_len2 = torch.as_tensor(elen2, **f32)
        self._edge_halflen = torch.as_tensor(0.5 * np.sqrt(elen2), **f32)
        # J_v = dx_v / dq_b = [I | p1 I | p2 I | p3 I], constant (x is linear in q)
        J = np.zeros((len(pts_cat), 3, 12), np.float32)
        for i in range(3):
            J[:, i, i] = 1.0
            J[:, i, 3 + 3 * i : 6 + 3 * i] = pts_cat
        self._J_pts = torch.as_tensor(J, **f32)  # (Vt, 3, 12)

    @property
    def _ee_on(self) -> bool:
        c = self.cfg
        return c.ee_contact_k > 0 and c.contact_k > 0 and self.num_bodies >= 2

    # --------------------------------------------------------------- energies
    def world_points(self, q: torch.Tensor) -> torch.Tensor:
        """q (..., B, 12) -> every body vertex (..., Vt, 3)."""
        A, t = q_to_affine(q)
        A_v = A.index_select(-3, self.vert_body)  # (..., Vt, 3, 3)
        return torch.einsum("...vij,vj->...vi", A_v, self.pts) + t.index_select(-2, self.vert_body)

    def _ortho_energy(self, q: torch.Tensor) -> torch.Tensor:
        """(..., B, 12) -> (...,) summed orthogonality energy."""
        A, _ = q_to_affine(q)
        R = torch.einsum("...bij,...bik->...bjk", A, A) - self._eye3
        return (self.kappa_ortho * (R * R).sum((-2, -1))).sum(-1)

    def _barrier(self, d: torch.Tensor) -> torch.Tensor:
        return barrier_extended(d, self.cfg.kappa_contact, self.cfg.d_hat)

    # ------------------------------------------------------------ candidates
    def _vt_d2(self, x):
        """(N, Vt, Tt) squared distances of every vertex to every triangle
        centroid, inf at its own body's triangles."""
        d2 = _sq_dist(x, _centroids(x, self.tris))
        return torch.where(self._same_body, torch.inf, d2)

    def _ee_d2(self, x):
        """(N, E, E) squared distances of the edge midpoints, inf unless the
        second edge's body has the higher index."""
        mid = _centroids(x, self.edges)
        return torch.where(self._ee_mask, torch.inf, _sq_dist(mid, mid))

    def _select_candidates(self, x):
        """Each vertex's K nearest other-body triangles by centroid distance
        -> (cand, valid) (N, Vt, K); a candidate beyond barrier reach
        (3 d_hat + the largest triangle radius) is not valid."""
        d2k, cand = _nearest(self._vt_d2(x), self.cfg.contact_k)
        cut = 3.0 * self.cfg.d_hat + self._tri_radius_max
        return cand, d2k < cut * cut

    def _select_ee_candidates(self, x):
        """Each surface edge's K nearest edges of higher-index bodies by
        midpoint distance -> (cand, valid) (N, E, K): each unordered body
        pair contributes its edge pairs once."""
        d2k, cand = _nearest(self._ee_d2(x), self.cfg.ee_contact_k)
        cut = 3.0 * self.cfg.d_hat + self._edge_halflen[:, None] + self._edge_halflen[cand]
        return cand, d2k < cut * cut

    def broad_phase_overflow(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Within-reach candidates dropped past the K nearest, per env
        (x = world_points(q), (N, Vt, 3)) -> {key: (N,) int64}: ``vt_body``
        and ``ee`` for the body-body families that are on (see
        ``SoftBodyModel.broad_phase_overflow``)."""
        c = self.cfg
        out: dict[str, torch.Tensor] = {}
        if c.contact_k > 0:
            cut = 3.0 * c.d_hat + self._tri_radius_max
            within = (self._vt_d2(x) < cut * cut).sum(-1)
            out["vt_body"] = torch.clamp(within - c.contact_k, min=0).sum(-1)
        if self._ee_on:
            cut = 3.0 * c.d_hat + self._edge_halflen[:, None] + self._edge_halflen[None, :]
            within = (self._ee_d2(x) < cut * cut).sum(-1)
            out["ee"] = torch.clamp(within - min(c.ee_contact_k, self.edges.shape[0]), min=0).sum(-1)
        return out

    # ------------------------------------------------------------- distances
    def _tri_rows(self, x, cand):
        """(N, Vt, K, 3, 3) corners of the candidate triangles."""
        return _gather(x, self.tris[cand])

    def _pair_distances(self, x, cand):
        """(N, Vt, K) distances of every vertex to its candidate triangles."""
        tri = self._tri_rows(x, cand)
        return _point_triangle_distance(x[:, :, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])

    def _pair_closest(self, x, cand):
        """(distances (N, Vt, K), closest points (N, Vt, K, 3)) of the candidates."""
        tri = self._tri_rows(x, cand)
        qp = _point_triangle_closest(x[:, :, None, :], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
        return torch.sqrt(((x[:, :, None, :] - qp) ** 2).sum(-1) + 1e-18), qp

    def _edge_rows(self, x):
        """(N, E, 2, 3) endpoints of every surface edge."""
        return x.index_select(1, self.edges.flatten()).unflatten(1, tuple(self.edges.shape))

    def _ee_distances(self, x, cand):
        """(N, E, K) distances of each surface edge to its candidate edges."""
        pi, pj = self._edge_rows(x), _gather(x, self.edges[cand])
        return _edge_edge_distance(pi[:, :, None, 0], pi[:, :, None, 1], pj[..., 0, :], pj[..., 1, :])

    def _ee_barrier(self, x, ee_cand):
        """(N,) mollified edge-edge barrier sum (``edge_edge_mollifier``)."""
        cand, valid = ee_cand
        c = self.cfg
        pi, pj = self._edge_rows(x), _gather(x, self.edges[cand])
        a, b, p, q = pi[:, :, None, 0], pi[:, :, None, 1], pj[..., 0, :], pj[..., 1, :]
        d = torch.where(valid, _edge_edge_distance(a, b, p, q), 10.0 * c.d_hat)
        m = edge_edge_mollifier(a, b, p, q, 1e-3 * self._edge_len2[:, None] * self._edge_len2[cand])
        return (m * self._barrier(d)).sum((-2, -1))

    # ----------------------------------------------------------------- energy
    def _energy(self, q, q_tilde, scene, aim_q, aim_strength, x_prev, friction_basis, cand=None,
                pair_friction=None, ee_cand=None):
        """(N,) incremental potential of each env's bodies at q (N, B, 12):
        with ``cand`` / ``ee_cand`` (the step-start candidate sets) the
        body-body barriers, with ``pair_friction`` (``_friction_lag``) their
        lagged friction."""
        c = self.cfg
        dq = q - q_tilde
        inertia = (0.5 / c.dt**2) * (dq * torch.einsum("bij,...bj->...bi", self.mass, dq)).sum((-2, -1))
        x = self.world_points(q)
        contact = self._barrier(scene.sdf(x)).sum(-1)
        if cand is not None:
            ci, valid = cand
            d_vt = torch.where(valid, self._pair_distances(x, ci), 10.0 * c.d_hat)
            contact = contact + self._barrier(d_vt).sum((-2, -1))
        if ee_cand is not None:
            contact = contact + self._ee_barrier(x, ee_cand)
        # soft transform / motor constraints: per-DOF strengths weighted by the body mass
        dqa = q - aim_q
        m_body = self.mass[:, 0, 0][:, None]  # (B, 1)
        constr = 0.5 * (aim_strength * m_body * dqa * dqa).sum((-2, -1)) / c.dt**2
        e = inertia + self._ortho_energy(q) + contact + constr
        eps = c.eps_velocity * c.dt
        friction = None
        if friction_basis is not None:
            lam_n, n_dir = friction_basis
            du = x - x_prev
            du_t = du - (du * n_dir).sum(-1, keepdim=True) * n_dir
            friction = c.friction_mu * (lam_n * friction_mollifier((du_t**2).sum(-1), eps)).sum(-1)
        if pair_friction is not None:
            # body-body friction, lagged: the slip is the vertex's displacement
            # relative to the other body's frozen closest material point
            lam_p, n_p, q_p0, p_local, tb, valid_p = pair_friction
            A, t = q_to_affine(q)
            A_tb = _gather(A.flatten(-2), tb).unflatten(-1, (3, 3))  # (N, Vt, K, 3, 3)
            moved = torch.einsum("nvkij,nvkj->nvki", A_tb, p_local) + _gather(t, tb)
            rel = (x - x_prev)[:, :, None, :] - (moved - q_p0)
            rel_t = rel - (rel * n_p).sum(-1, keepdim=True) * n_p
            f0p = friction_mollifier((rel_t**2).sum(-1), eps)
            fp = c.friction_mu * torch.where(valid_p, lam_p * f0p, 0.0).sum((-2, -1))
            friction = fp if friction is None else friction + fp
        return e if friction is None else e + friction

    def _friction_lag(self, q_k, scene, cand, A0, t0):
        """Friction quantities at the detached Newton iterate q_k (N, B, 12):
        the scene basis (lambda, normal) and, with body-body candidates,
        (lambda, normal, the other body's closest point in its body frame,
        that point's step-start world position, its body, validity). The
        anchor is picked at the iterate and mapped back through the
        step-start pose (A0, t0), so the slip spans the whole step."""
        c = self.cfg
        if c.friction_mu <= 0:
            return None, None
        q_k = q_k.detach()
        x_k = self.world_points(q_k)
        fb = scene_friction_basis(x_k, scene, c.kappa_contact, c.d_hat)
        pf = None
        if cand is not None:
            ci, valid = cand
            d_p, q_p = self._pair_closest(x_k, ci)
            lam_p = torch.where(valid, barrier_force_mag(d_p, c.kappa_contact, c.d_hat), 0.0)
            n_p = (x_k[:, :, None, :] - q_p) / torch.clamp(d_p, min=1e-9)[..., None]
            A_k, t_k = q_to_affine(q_k)
            tb = self.tri_body[ci]  # (N, Vt, K)

            def rows(M):
                return _gather(M.flatten(-2), tb).unflatten(-1, (3, 3))

            p_local = torch.einsum("nvkij,nvkj->nvki", rows(inverse3(A_k)), q_p - _gather(t_k, tb))
            q_p0 = torch.einsum("nvkij,nvkj->nvki", rows(A0), p_local) + _gather(t0, tb)
            pf = (lam_p, n_p, q_p0, p_local, tb, valid)
        return fb, pf

    # ------------------------------------------------------- Hessians
    def _smooth_blocks(self, q, aim_strength):
        """(N, B, 12, 12) per-body inertia + orthogonality + constraint
        Hessian blocks at q (N, B, 12)."""
        c = self.cfg
        n, B = q.shape[:2]
        Hd = (self.mass / c.dt**2).expand(n, B, 12, 12).clone()
        Hd[..., 3:, 3:] += ortho_hessian(q, self.kappa_ortho)
        m_body = self.mass[:, 0, 0][:, None]
        return Hd + torch.diag_embed(aim_strength * m_body / c.dt**2)

    @staticmethod
    def _dense_hessian(energy, qf):
        """(E (N,), grad (N, D), H (N, D, D)) of a batched energy at qf (N, D):
        the gradient's graph is built once, then one batched backward
        (``torch.func.vmap`` of its vjp) over the D unit vectors gives every
        env's Hessian rows: each env's energy depends only on its own q, so
        one batch of unit vectors, broadcast over the envs, yields every
        env's block."""
        n, D = qf.shape

        def grad_fn(z):
            def total(zz):
                e = energy(zz)
                return e.sum(), e

            return torch.func.grad(total, has_aux=True)(z)

        g, vjp_fn, e = torch.func.vjp(grad_fn, qf.detach(), has_aux=True)
        eye = torch.eye(D, dtype=qf.dtype, device=qf.device)[:, None, :].expand(D, n, D)
        (H,) = torch.func.vmap(vjp_fn)(eye)
        return e.detach(), g.detach(), H.transpose(0, 1)

    def _assemble_hessian(self, q, scene, aim_strength, x_prev, friction_basis, cand, pair_friction):
        """Analytic (N, 12B, 12B) Hessian of the incremental potential at q
        (N, B, 12). x = A p + t is linear in q, so each term's Hessian is
        J^T G J with the constant point Jacobians J and a small point-space
        Hessian G (3x3 a vertex for the scene terms, 12x12 a vertex-triangle
        pair, 15x15 a friction pair), each from ``torch.func.hessian``; the
        12x12 blocks are summed into a (B*B) grid by ``index_add_``."""
        c = self.cfg
        n, B = q.shape[:2]
        J = self._J_pts  # (Vt, 3, 12)
        Vt = J.shape[0]
        x = self.world_points(q).detach()
        q = q.detach()
        hess = torch.func.hessian
        vmap = torch.func.vmap

        # inertia, orthogonality and constraints (block diagonal), then the
        # scene barrier and friction of every vertex, summed per body
        fields = [scene.spheres, scene.boxes, scene.capsules, scene.planes]
        if scene.threads is not None:
            fields.append(scene.threads)

        def phi_scene(p, *f):
            return self._barrier(type(scene)(*f).sdf(p[None])[0])

        G = vmap(vmap(hess(phi_scene), in_dims=(0,) + (None,) * len(fields)))(x, *fields)  # (N, Vt, 3, 3)
        eps = c.eps_velocity * c.dt
        if friction_basis is not None:
            lam_n, n_dir = friction_basis

            def phi_fric(p, p0, nd, lam):
                du = p - p0
                du_t = du - (du * nd).sum() * nd
                return c.friction_mu * lam * friction_mollifier((du_t**2).sum(), eps)

            G = G + vmap(vmap(hess(phi_fric)))(x, x_prev, n_dir, lam_n)
        Hv = torch.einsum("vai,nvab,vbj->nvij", J, G, J)  # (N, Vt, 12, 12)
        Hd = self._smooth_blocks(q, aim_strength).index_add(1, self.vert_body, Hv)  # (N, B, 12, 12)
        blocks = [Hd.flatten(-2)]
        ids = [(torch.arange(B, device=q.device) * (B + 1)).expand(n, B)]

        if cand is not None:
            # vertex-triangle pairs: the 12 point coordinates of (vertex, triangle)
            ci, valid = cand
            K = ci.shape[-1]
            tri_ids = self.tris[ci]  # (N, Vt, K, 3)

            def psi(pts4):
                return self._barrier(_point_triangle_distance(pts4[0], pts4[1], pts4[2], pts4[3]))

            pts4 = torch.cat([x[:, :, None, None, :].expand(n, Vt, K, 1, 3), _gather(x, tri_ids)], 3)
            G12 = vmap(hess(psi))(pts4.reshape(-1, 4, 3)).reshape(n, Vt, K, 4, 3, 4, 3)
            G12 = torch.where(valid[..., None, None, None, None], G12, 0.0)
            J4 = torch.cat([J[None, :, None, None].expand(n, Vt, K, 1, 3, 12), J[tri_ids]], 3)  # (N, Vt, K, 4, 3, 12)
            H4 = torch.einsum("nvkmai,nvkmaob,nvkobj->nvkmoij", J4, G12, J4)
            tb = self.tri_body[ci]
            b4 = torch.stack([self.vert_body[None, :, None].expand_as(tb), tb, tb, tb], -1)  # (N, Vt, K, 4)
            blocks.append(H4.reshape(n, -1, 144))
            ids.append((b4[..., :, None] * B + b4[..., None, :]).reshape(n, -1))

        if pair_friction is not None:
            # pair friction is a function of (x_v, q of the other body): 15 inputs
            lam_p, n_p, q_p0, p_local, tb, valid_p = pair_friction
            K = tb.shape[-1]

            def chi(z, pv0, nd, lam, pl, qp0):
                pv, qB = z[:3], z[3:]
                moved = qB[3:].reshape(3, 3) @ pl + qB[:3]
                rel = (pv - pv0) - (moved - qp0)
                rel_t = rel - (rel * nd).sum() * nd
                return c.friction_mu * lam * friction_mollifier((rel_t**2).sum(), eps)

            z = torch.cat([x[:, :, None, :].expand(n, Vt, K, 3), _gather(q, tb)], -1)
            args = (z, x_prev[:, :, None, :].expand(n, Vt, K, 3), n_p, lam_p, p_local, q_p0)
            H15 = vmap(hess(chi))(*(a.reshape((-1,) + a.shape[3:]) for a in args)).reshape(n, Vt, K, 15, 15)
            H15 = torch.where(valid_p[..., None, None], H15, 0.0)
            Jv = J[None, :, None].expand(n, Vt, K, 3, 12)
            Hvv = torch.einsum("nvkai,nvkab,nvkbj->nvkij", Jv, H15[..., :3, :3], Jv)
            Hvq = torch.einsum("nvkai,nvkaj->nvkij", Jv, H15[..., :3, 3:])
            bv = self.vert_body[None, :, None].expand_as(tb)
            blocks.append(torch.stack([Hvv, Hvq, Hvq.transpose(-1, -2), H15[..., 3:, 3:]], 3).reshape(n, -1, 144))
            ids.append(torch.stack([bv * B + bv, bv * B + tb, tb * B + bv, tb * B + tb], -1).reshape(n, -1))

        contrib, seg = torch.cat(blocks, 1), torch.cat(ids, 1)  # (N, M, 144), (N, M)
        seg = seg + B * B * torch.arange(n, device=q.device)[:, None]
        grid = contrib.new_zeros(n * B * B, 144).index_add_(0, seg.flatten(), contrib.flatten(0, 1))
        return grid.reshape(n, B, B, 12, 12).permute(0, 1, 3, 2, 4).reshape(n, 12 * B, 12 * B)

    # -------------------------------------------------------------- the solve
    def _solve(self, q, qd, scene, aim_q, aim_strength):
        """One implicit step of every env -> (q, qd) (N, B, 12)."""
        c = self.cfg
        n, B = q.shape[:2]
        dev = q.device
        q_tilde = q + c.dt * qd + c.dt**2 * self._q_gravity
        x0 = self.world_points(q)
        cand = self._select_candidates(x0) if c.contact_k > 0 else None
        ee_cand = self._select_ee_candidates(x0) if self._ee_on else None
        A0, t0 = q_to_affine(q)  # the step-start pose: friction anchors map here

        def energy_with(lags):
            fb, pf = lags
            return lambda qf: self._energy(qf.unflatten(1, (B, 12)), q_tilde, scene, aim_q, aim_strength, x0,
                                           fb, cand, pf, ee_cand)

        # feasibility floors: the scene's (no worsening of a penetrated start)
        # and the edge-edge pairs' (0.999 of the step-start minimum, or 1e-7 m)
        d_floor = torch.clamp(scene.sdf(x0).amin(-1), max=0.0)
        if ee_cand is not None:
            eci, evalid = ee_cand
            ee_floor = torch.clamp(0.999 * torch.where(evalid, self._ee_distances(x0, eci), 1.0).amin((-2, -1)),
                                   max=1e-7)

        def feasible(qf, qf_from):
            x = self.world_points(qf.unflatten(1, (B, 12)))
            ok = scene.sdf(x).amin(-1) > d_floor
            if cand is None and ee_cand is None:
                return ok
            x_from = self.world_points(qf_from.unflatten(1, (B, 12)))
            if cand is not None:
                ci, valid = cand
                ok = ok & (torch.where(valid, self._pair_distances(x, ci), 1.0).amin((-2, -1)) > 1e-7)
                # a vertex must not pierce a candidate triangle; both bodies
                # move, so the test runs in the triangle's co-moving frame
                tri, tri0 = self._tri_rows(x, ci), self._tri_rows(x_from, ci)
                crossed = _segment_crosses_moving_triangle(
                    x_from[:, :, None, :], x[:, :, None, :], tri0[..., 0, :], tri0[..., 1, :], tri0[..., 2, :],
                    tri[..., 0, :], tri[..., 1, :], tri[..., 2, :],
                )
                ok = ok & ~(crossed & valid).flatten(1).any(-1)
            if ee_cand is not None:
                ok = ok & (torch.where(evalid, self._ee_distances(x, eci), 1.0).amin((-2, -1)) > ee_floor)
                pa, pja = self._edge_rows(x_from), _gather(x_from, self.edges[eci])
                pb, pjb = self._edge_rows(x), _gather(x, self.edges[eci])
                crossed = _edge_pair_crossed(
                    pa[:, :, None, 0], pa[:, :, None, 1], pja[..., 0, :], pja[..., 1, :],
                    pb[:, :, None, 0], pb[:, :, None, 1], pjb[..., 0, :], pjb[..., 1, :],
                )
                ok = ok & ~(crossed & evalid).flatten(1).any(-1)
            return ok

        cg = c.linear_solver == "cg"
        if cg:
            # per-body 12x12 smooth-part inverse, once a step
            Hd_inv = torch.linalg.inv_ex(self._smooth_blocks(q, aim_strength) + 1e-6 * self._eye12).inverse

            def precond(r):
                return torch.einsum("nbij,nbj->nbi", Hd_inv, r.unflatten(1, (B, 12))).flatten(1)

        qf = q.flatten(1)
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        for _ in range(c.newton_max_iter):
            lags = self._friction_lag(qf.unflatten(1, (B, 12)), scene, cand, A0, t0)
            energy = energy_with(lags)
            if cg:
                e0, g, hvp = derivatives(energy, qf)
                r = -g
                z0 = precond(r)
                p_dir, zv, sol = z0, z0, torch.zeros_like(qf)
                for _ in range(c.cg_iters):
                    hp = hvp(p_dir)
                    denom = (p_dir * hp).sum(-1)
                    rz = (r * zv).sum(-1)
                    alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)[:, None]
                    sol = sol + alpha * p_dir
                    r = r - alpha * hp
                    z_new = precond(r)
                    beta = torch.where(rz > 1e-20, (r * z_new).sum(-1) / rz, 0.0)[:, None]
                    p_dir, zv = z_new + beta * p_dir, z_new
                del hvp
                descent = (sol * g).sum(-1) < 0
                p = torch.where(descent[:, None], sol, -z0)
            else:
                if c.analytic_hessian and ee_cand is None:
                    # the J^T G J assembly predates edge-edge pairs: with them
                    # on, the autograd Hessian below is used, as in JAX
                    with torch.enable_grad():
                        qv = qf.detach().requires_grad_(True)
                        e0 = energy(qv)
                        (g,) = torch.autograd.grad(e0.sum(), qv)
                    e0 = e0.detach()
                    H = self._assemble_hessian(qf.unflatten(1, (B, 12)), scene, aim_strength, x0, lags[0], cand,
                                               lags[1])
                else:
                    e0, g, H = self._dense_hessian(energy, qf)
                # per-DOF relative Tikhonov shift: a uniform one would swamp
                # the soft directions when stiff barriers reach ~1e10
                diag = torch.diagonal(H, dim1=-2, dim2=-1).abs()
                Hr = H + torch.diag_embed(c.hessian_reg * (1.0 + diag)) + 1e-9 * self._eye_q
                p = -torch.linalg.solve_ex(Hr, g, check_errors=False).result
                descent = (p * g).sum(-1) < 0
                p = torch.where(descent[:, None], p, -g / (1.0 + torch.linalg.vector_norm(g, dim=-1, keepdim=True)))

            # backtracking line search: lower energy and feasible
            alpha = torch.ones((n,), device=dev)
            accepted = torch.zeros((n,), dtype=torch.bool, device=dev)
            for _ in range(c.line_search_iters):
                q_try = qf + alpha[:, None] * p
                ok = (energy(q_try) < e0) & feasible(q_try, qf)
                alpha = torch.where(ok | accepted, alpha, alpha * 0.5)
                accepted = ok | accepted
            alpha = torch.where(accepted, alpha, 0.0)
            step = alpha[:, None] * p
            qf = torch.where(done[:, None], qf, qf + step)
            done = done | (step.abs().amax(-1) / c.dt < c.velocity_tol)
        q_new = qf.unflatten(1, (B, 12))
        return q_new, (q_new - q) / c.dt

    # ----------------------------------------------------------------- public
    def step(
        self,
        state: AbdState,
        scene,
        aim_q: torch.Tensor | None = None,  # (N, B, 12) constraint targets
        aim_strength: torch.Tensor | None = None,  # (N, B) or (N, B, 12); 0 = free
    ) -> AbdState:
        """Advance every env one dt against ``scene`` (a ``RigidSdfScene``)."""
        inputs = (state.q, state.qd, aim_q, aim_strength)
        needs_grad = any(t is not None and t.requires_grad for t in inputs) or scene.requires_grad()
        if torch.is_grad_enabled() and needs_grad:
            raise RuntimeError(
                "AbdModel.step has no gradient in its inputs yet (ROADMAP Queue 1 item 3c); "
                "detach them or run under torch.no_grad()"
            )
        n, B = state.q.shape[:2]
        if aim_q is None:
            aim_q = state.q
        if aim_strength is None:
            aim_strength = torch.zeros((n, B, 12), device=state.q.device)
        elif aim_strength.ndim == 2:
            aim_strength = aim_strength[..., None].expand(n, B, 12)
        q, qd = self._solve(state.q, state.qd, scene, aim_q, aim_strength)
        return AbdState(q=q, qd=qd)

    def body_positions(self, state: AbdState) -> torch.Tensor:
        """Body origins (N, B, 3)."""
        return state.q[..., :3]

    def all_vertices(self, state: AbdState) -> torch.Tensor:
        """(N, Vt, 3) world vertices of every body."""
        return self.world_points(state.q)
