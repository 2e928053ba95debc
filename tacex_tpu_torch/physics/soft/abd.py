"""Affine body dynamics (ABD): a free rigid-ish body of 12 generalized DOFs.

Port of ``tacex_tpu/physics/soft/abd.py`` as the coupled FEM+ABD world
(``coupled.py``) uses it. Each body has ``q = [t | a1 | a2 | a3]``
(translation, then the rows of the affine matrix A); a body vertex sits at
``x = A p + t``. The incremental potential of a step is

    E(q) = 1/(2 dt^2) (q - q_tilde)^T M (q - q_tilde) + kappa V ||A^T A - I||^2
           + barrier(sdf(x)) + soft-transform constraint + lagged friction,

batched over a leading env axis. The body's constants (its 12x12
generalized mass from the surface mesh's moments, its inverse, the
generalized gravity force) are computed in float64 numpy and sent to the
device once.

``rotate_target`` advances a RotatingMotor's target, as the UIPC scene
API (``tacex_tpu_torch.uipc``) drives motors in the coupled world.

Not ported (they raise ``NotImplementedError``, ROADMAP Queue 1 item 8a):
body-body contact (``contact_k``, ``ee_contact_k``), its pair friction, and
the standalone ABD solve (``AbdModel.step``): the coupled world runs the
ABD energy inside its own Newton solve, and its bodies meet only the gel
pads and the analytic scene.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.config import configclass
from ...core.device import DEFAULT_DEVICE, resolve
from .ipc import barrier_extended, friction_mollifier

UNPORTED = "is not ported yet (ROADMAP Queue 1 item 8a: ABD body-body contact and the standalone ABD solve)"


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
    contact_k: int = 8  # body-body candidate triangles per surface vertex (0 = off; not ported)
    ee_contact_k: int = 4  # body-body edge-edge candidates (0 = off; not ported)
    hessian_reg: float = 1e-6
    linear_solver: str = "dense"  # the standalone solve's ("dense" | "cg"; not ported)
    cg_iters: int = 32
    analytic_hessian: bool = False


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
        if c.contact_k > 0:
            raise NotImplementedError(f"body-body contact (contact_k={c.contact_k}) {UNPORTED}")
        if c.ee_contact_k > 0:
            raise NotImplementedError(f"body-body edge-edge contact (ee_contact_k={c.ee_contact_k}) {UNPORTED}")
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
        pts_cat, tris_cat = np.concatenate(all_pts), np.concatenate(all_tris)
        self.volumes = torch.as_tensor(np.asarray(volumes), **f32)
        self.kappa_ortho = torch.as_tensor(kap * np.asarray(volumes), **f32)  # (B,)
        self.mass = torch.as_tensor(np.stack(M_blocks), **f32)  # (B, 12, 12)
        self.pts = torch.as_tensor(pts_cat, **f32)  # (Vt, 3)
        self.tris = torch.as_tensor(tris_cat, dtype=torch.int64, device=dev)  # (Tt, 3)
        self.vert_body = torch.as_tensor(np.concatenate(body_of_vert), dtype=torch.int64, device=dev)  # (Vt,)
        self.tri_body = torch.as_tensor(np.concatenate(body_of_tri), dtype=torch.int64, device=dev)  # (Tt,)
        tri_pts = pts_cat[tris_cat]
        self._tri_radius_max = float(np.linalg.norm(tri_pts - tri_pts.mean(1, keepdims=True), axis=-1).max())
        self.gravity_q = torch.as_tensor(np.stack(grav_force), **f32)  # (B, 12)
        self.mass_inv = torch.as_tensor(np.linalg.inv(np.stack(M_blocks) + 1e-9 * np.eye(12)), **f32)
        self._eye3 = torch.eye(3, **f32)

    # ------------------------------------------------------------- unported
    def step(self, *args, **kwargs):
        raise NotImplementedError(f"AbdModel.step (the standalone dense and CG solves) {UNPORTED}")

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

    def _energy(self, q, q_tilde, scene, aim_q, aim_strength, x_prev, friction_basis, cand=None,
                pair_friction=None):
        """(N,) incremental potential of each env's bodies at q (N, B, 12)."""
        if cand is not None or pair_friction is not None:
            raise NotImplementedError(f"body-body contact in the ABD energy {UNPORTED}")
        c = self.cfg
        dq = q - q_tilde
        inertia = (0.5 / c.dt**2) * (dq * torch.einsum("bij,...bj->...bi", self.mass, dq)).sum((-2, -1))
        x = self.world_points(q)
        contact = barrier_extended(scene.sdf(x), c.kappa_contact, c.d_hat).sum(-1)
        # soft transform constraint: per-DOF strengths weighted by the body mass
        dqa = q - aim_q
        m_body = self.mass[:, 0, 0][:, None]  # (B, 1)
        constr = 0.5 * (aim_strength * m_body * dqa * dqa).sum((-2, -1)) / c.dt**2
        e = inertia + self._ortho_energy(q) + contact + constr
        if friction_basis is not None:
            lam_n, n_dir = friction_basis
            du = x - x_prev
            du_t = du - (du * n_dir).sum(-1, keepdim=True) * n_dir
            f0 = friction_mollifier((du_t**2).sum(-1), c.eps_velocity * c.dt)
            e = e + c.friction_mu * (lam_n * f0).sum(-1)
        return e
