"""Codimensional (shell, cloth) finite elements: rest data and energies.

Port of ``tacex_tpu/physics/soft/codim.py``. A ``ShellElements`` bundle
holds the rest quantities of a set of membrane triangles and bending hinges
over any vertex array (numpy, copied from the JAX package so that both
packages build the same arrays, hinge list in the same dict order);
``ShellElementsTorch`` puts them on a device, and the two energies evaluate
them for whichever nodal solver owns those vertices: ``shell.ShellModel``
standalone, or ``ipc.SoftBodyModel`` when cloth joins the union or coupled
contact world (one nodal system with tet and shell elements).

  * Membrane: a constant-strain-triangle 2D Neo-Hookean. Per triangle the
    3x2 deformation gradient F maps rest tangent coordinates to the world;
    psi = mu/2 (tr C - 2) - mu ln J + lam/2 (ln J)^2 with C = F^T F and
    J^2 = det C (clamped at 1e-12), times rest area and thickness.
  * Bending: the discrete-shells hinge energy w (theta - theta0)^2 per
    interior edge, theta from an ``atan2(sin, cos)`` dihedral with 1e-16
    under each square root, so that its derivatives stay finite.

Both energies take x (N, V, 3) and return (N,): one value an env.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.device import DEFAULT_DEVICE, resolve


@dataclasses.dataclass(frozen=True)
class ShellElements:
    """Rest-state data of membrane triangles + bending hinges.

    Vertex ids (``tris``, ``hinges``) index whatever vertex array the
    owning solver solves over — local for a standalone shell, global
    (offset) inside a union model. ``masses`` is the lumped-mass
    CONTRIBUTION of these elements per owned vertex id (length = the
    owning vertex count), additive with tet lumped masses.
    """

    tris: np.ndarray  # (Tm, 3) int32
    d_inv: np.ndarray  # (Tm, 2, 2) inverse rest tangent matrix
    rest_area: np.ndarray  # (Tm,)
    mu: np.ndarray  # (Tm,) first Lamé (shear) modulus
    lam: np.ndarray  # (Tm,) second Lamé modulus
    thickness: np.ndarray  # (Tm,)
    masses: np.ndarray  # (V,) per-vertex lumped mass from these elements
    hinges: np.ndarray  # (H, 4) int32: edge a-b, opposite c, d
    hinge_w: np.ndarray  # (H,) bending weight kb * |e| / h_bar
    theta0: np.ndarray  # (H,) rest dihedral

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]


def _dihedral_np(P: np.ndarray, H: np.ndarray) -> np.ndarray:
    x0, x1, x2, x3 = P[H[:, 0]], P[H[:, 1]], P[H[:, 2]], P[H[:, 3]]
    e = x1 - x0
    n1 = np.cross(e, x2 - x0)
    n2 = np.cross(x3 - x0, e)
    n1n = np.linalg.norm(n1, axis=-1) + 1e-12
    n2n = np.linalg.norm(n2, axis=-1) + 1e-12
    en = np.linalg.norm(e, axis=-1) + 1e-12
    cos = (n1 * n2).sum(-1) / (n1n * n2n)
    sin = (np.cross(n1, n2) * e).sum(-1) / (n1n * n2n * en)
    return np.arctan2(sin, cos)


def build_shell_elements(
    points: np.ndarray,
    triangles: np.ndarray,
    youngs_modulus: float = 1e4,
    poisson_ratio: float = 0.3,
    thickness: float = 0.001,
    mass_density: float = 200.0,
    bending_stiffness: float = 10.0,
    num_vertices: int | None = None,
    vertex_offset: int = 0,
) -> ShellElements:
    """Precompute one shell's rest state (NeoHookeanShell.apply_to params).

    ``points`` are the shell's OWN rest positions (local, (Vl, 3));
    ``triangles`` index into them. ``vertex_offset`` / ``num_vertices``
    relocate the element ids and the mass vector into a larger vertex
    array (union models); defaults build local (standalone) elements.
    """
    P = np.asarray(points, np.float64)
    T = np.asarray(triangles, np.int64)
    V = num_vertices if num_vertices is not None else len(P)

    e1 = P[T[:, 1]] - P[T[:, 0]]
    e2 = P[T[:, 2]] - P[T[:, 0]]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=-1)
    if (area2 < 1e-14).any():
        raise ValueError("degenerate rest triangle in shell mesh")
    t1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    nn = n / area2[:, None]
    t2 = np.cross(nn, t1)
    # rest 2x2 material matrix D = [[e1.t1, e2.t1], [0, e2.t2]]
    D = np.zeros((len(T), 2, 2))
    D[:, 0, 0] = (e1 * t1).sum(-1)
    D[:, 0, 1] = (e2 * t1).sum(-1)
    D[:, 1, 1] = (e2 * t2).sum(-1)
    area = 0.5 * area2

    E, nu = float(youngs_modulus), float(poisson_ratio)
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu + 1e-9))

    # lumped vertex masses: density * thickness * area / 3 per corner
    masses = np.zeros(V)
    np.add.at(
        masses,
        T.reshape(-1) + vertex_offset,
        np.repeat(mass_density * thickness * area / 3.0, 3),
    )

    # bending hinges: interior edges with their opposite vertices
    edge_map: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for ti, tri in enumerate(T):
        for k in range(3):
            a, b = int(tri[k]), int(tri[(k + 1) % 3])
            o = int(tri[(k + 2) % 3])
            edge_map.setdefault((min(a, b), max(a, b)), []).append((ti, o))
    hinges = []
    for (a, b), occ in edge_map.items():
        if len(occ) == 2:
            hinges.append((a, b, occ[0][1], occ[1][1]))
    if hinges:
        H = np.asarray(hinges, np.int64)
        e_len = np.linalg.norm(P[H[:, 1]] - P[H[:, 0]], axis=-1)
        # h_bar = 1/3 of the summed opposite heights (Grinspun weight)
        a_sum = area[[edge_map[(int(h[0]), int(h[1]))][0][0] for h in H]] + area[
            [edge_map[(int(h[0]), int(h[1]))][1][0] for h in H]
        ]
        h_bar = (2.0 / 3.0) * a_sum / e_len
        # plate-bending modulus k_b = E_bend * t^3 / 12 per unit width,
        # times the discrete-shells hinge weight |e|/h_bar
        kb = bending_stiffness * thickness**3 / 12.0
        hinge_w = kb * e_len / np.maximum(h_bar, 1e-9)
        theta0 = _dihedral_np(P, H)
        H = H + vertex_offset
    else:
        H = np.zeros((0, 4), np.int64)
        hinge_w = np.zeros((0,))
        theta0 = np.zeros((0,))

    Tm = len(T)
    return ShellElements(
        tris=(T + vertex_offset).astype(np.int32),
        d_inv=np.linalg.inv(D).astype(np.float32),
        rest_area=area.astype(np.float32),
        mu=np.full(Tm, mu, np.float32),
        lam=np.full(Tm, lam, np.float32),
        thickness=np.full(Tm, thickness, np.float32),
        masses=masses.astype(np.float64),
        hinges=H.astype(np.int32),
        hinge_w=np.asarray(hinge_w, np.float32),
        theta0=np.asarray(theta0, np.float32),
    )


def merge_shell_elements(parts: list[ShellElements], num_vertices: int) -> ShellElements:
    """Concatenate already-offset element bundles over one vertex array."""
    masses = np.zeros(num_vertices)
    for p in parts:
        masses[: len(p.masses)] += p.masses
    return ShellElements(
        tris=np.concatenate([p.tris for p in parts]),
        d_inv=np.concatenate([p.d_inv for p in parts]),
        rest_area=np.concatenate([p.rest_area for p in parts]),
        mu=np.concatenate([p.mu for p in parts]),
        lam=np.concatenate([p.lam for p in parts]),
        thickness=np.concatenate([p.thickness for p in parts]),
        masses=masses,
        hinges=np.concatenate([p.hinges for p in parts]),
        hinge_w=np.concatenate([p.hinge_w for p in parts]),
        theta0=np.concatenate([p.theta0 for p in parts]),
    )


class ShellElementsTorch:
    """The constants of a ``ShellElements`` bundle on ``device``."""

    def __init__(self, e: ShellElements, device=DEFAULT_DEVICE):
        dev = resolve(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.tris = torch.as_tensor(np.asarray(e.tris, np.int64), device=dev)
        self.d_inv = torch.as_tensor(e.d_inv, **f32)
        self.rest_area = torch.as_tensor(e.rest_area, **f32)
        self.mu = torch.as_tensor(e.mu, **f32)
        self.lam = torch.as_tensor(e.lam, **f32)
        self.thickness = torch.as_tensor(e.thickness, **f32)
        self.hinges = torch.as_tensor(np.asarray(e.hinges, np.int64), device=dev)
        self.hinge_w = torch.as_tensor(e.hinge_w, **f32)
        self.theta0 = torch.as_tensor(e.theta0, **f32)


def membrane_energy(x: torch.Tensor, e: ShellElementsTorch) -> torch.Tensor:
    """CST 2D Neo-Hookean membrane energy of each env, x (N, V, 3) -> (N,)."""
    if e.tris.shape[0] == 0:
        return x.new_zeros(x.shape[0])
    a = x.index_select(1, e.tris[:, 0])
    f1 = x.index_select(1, e.tris[:, 1]) - a  # (N, T, 3)
    f2 = x.index_select(1, e.tris[:, 2]) - a
    F = torch.stack([f1, f2], -1) @ e.d_inv  # (N, T, 3, 2)
    C = F.transpose(-1, -2) @ F  # (N, T, 2, 2)
    I2 = C[..., 0, 0] + C[..., 1, 1]
    detC = torch.clamp(C[..., 0, 0] * C[..., 1, 1] - C[..., 0, 1] * C[..., 1, 0], min=1e-12)
    lnJ = 0.5 * torch.log(detC)
    psi = 0.5 * e.mu * (I2 - 2.0) - e.mu * lnJ + 0.5 * e.lam * lnJ**2
    return (psi * e.rest_area * e.thickness).sum(-1)


def bending_energy(x: torch.Tensor, e: ShellElementsTorch) -> torch.Tensor:
    """Discrete-shells hinge bending energy of each env, x (N, V, 3) -> (N,)."""
    if e.hinges.shape[0] == 0:
        return x.new_zeros(x.shape[0])
    H = e.hinges
    x0, x1, x2, x3 = (x.index_select(1, H[:, i]) for i in range(4))
    ed = x1 - x0
    n1 = torch.linalg.cross(ed, x2 - x0, dim=-1)
    n2 = torch.linalg.cross(x3 - x0, ed, dim=-1)
    n1n = torch.sqrt((n1**2).sum(-1) + 1e-16)
    n2n = torch.sqrt((n2**2).sum(-1) + 1e-16)
    en = torch.sqrt((ed**2).sum(-1) + 1e-16)
    cos = (n1 * n2).sum(-1) / (n1n * n2n)
    sin = (torch.linalg.cross(n1, n2, dim=-1) * ed).sum(-1) / (n1n * n2n * en)
    theta = torch.atan2(sin, cos)
    return (e.hinge_w * (theta - e.theta0) ** 2).sum(-1)
