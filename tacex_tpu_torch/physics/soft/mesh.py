"""Tetrahedral mesh generation for soft bodies (numpy).

A copy of ``tacex_tpu/physics/soft/mesh.py``: the port keeps its own copy of
this numpy-only host code, as it does for ``core/config.py``. The gel pads
are boxes, meshed by a structured hex->tet (Kuhn) subdivision: one topology
shared by all envs, well-conditioned elements, no external mesher. The voxel
and isosurface-stuffing meshers tetrahedralize arbitrary closed triangle
meshes. The JAX package's ``use_native`` branch (its C++ geometry runtime,
``native/libtacex_geom.so``) is not carried over: the numpy path below is
the only one, and the native one equals it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TetMesh:
    """Static mesh topology (numpy; constants under jit)."""

    points: np.ndarray  # (V, 3) float32 rest positions
    tets: np.ndarray  # (T, 4) int32
    surface_tris: np.ndarray  # (S, 3) int32, outward-oriented
    surface_verts: np.ndarray  # (Vs,) int32 unique surface vertex ids

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    def rest_volumes(self) -> np.ndarray:
        p = self.points
        t = self.tets
        d1 = p[t[:, 1]] - p[t[:, 0]]
        d2 = p[t[:, 2]] - p[t[:, 0]]
        d3 = p[t[:, 3]] - p[t[:, 0]]
        return np.einsum("ij,ij->i", np.cross(d1, d2), d3) / 6.0


def box_tet_mesh(
    size: tuple[float, float, float],
    resolution: tuple[int, int, int] = (8, 10, 3),
    center: tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> TetMesh:
    """Structured box tet mesh: (nx, ny, nz) cells, 6 tets per hex cell.

    The 6-tet (Kuhn) subdivision is orientation-consistent across cells, so
    neighboring tets share faces and the extracted boundary is watertight.
    """
    nx, ny, nz = resolution
    sx, sy, sz = size
    xs = np.linspace(-sx / 2, sx / 2, nx + 1)
    ys = np.linspace(-sy / 2, sy / 2, ny + 1)
    zs = np.linspace(-sz / 2, sz / 2, nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) + np.asarray(center)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    # Kuhn triangulation of the unit cube (6 tets around the main diagonal
    # v0 -> v6); consistent across cells without parity flips.
    corner_offsets = [
        (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    ]
    kuhn = [
        (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
        (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
    ]
    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                corners = [vid(i + di, j + dj, k + dk) for (di, dj, dk) in corner_offsets]
                for a, b, c, d in kuhn:
                    tets.append((corners[a], corners[b], corners[c], corners[d]))
    tets = np.asarray(tets, np.int32)

    # fix orientation: positive volume
    p = points
    d1 = p[tets[:, 1]] - p[tets[:, 0]]
    d2 = p[tets[:, 2]] - p[tets[:, 0]]
    d3 = p[tets[:, 3]] - p[tets[:, 0]]
    vol = np.einsum("ij,ij->i", np.cross(d1, d2), d3)
    flip = vol < 0
    tets[flip, 1], tets[flip, 2] = tets[flip, 2].copy(), tets[flip, 1].copy()

    surface_tris = extract_surface(tets, points)
    surface_verts = np.unique(surface_tris)
    return TetMesh(
        points=points.astype(np.float32),
        tets=tets,
        surface_tris=surface_tris.astype(np.int32),
        surface_verts=surface_verts.astype(np.int32),
    )


def voxel_tet_mesh(
    surf_points: np.ndarray,  # (V, 3) closed surface mesh vertices
    surf_tris: np.ndarray,  # (F, 3)
    resolution: int = 12,
) -> TetMesh:
    """Tetrahedralize an arbitrary closed triangle mesh by voxelization.

    The generic-mesh counterpart of the reference's wildmeshing/fTetWild
    MeshGenerator (reference mesh_gen.py:205-266, not available here):
    occupancy is computed by z-ray parity per (x, y) column, occupied cells
    get the 6-tet Kuhn split with shared grid vertices. Approximates the
    boundary to half a voxel — adequate for soft-body props; the gel pads
    themselves use the exact structured box mesh.
    """
    lo = surf_points.min(axis=0)
    hi = surf_points.max(axis=0)
    size = hi - lo
    h = float(size.max()) / resolution
    dims = np.maximum((size / h).round().astype(int), 1)
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])

    # cell-center occupancy via ray parity along +z
    cx = lo[0] + (np.arange(nx) + 0.5) * h
    cy = lo[1] + (np.arange(ny) + 0.5) * h
    cz = lo[2] + (np.arange(nz) + 0.5) * h
    occ = np.zeros((nx, ny, nz), bool)
    v0 = surf_points[surf_tris[:, 0]]
    v1 = surf_points[surf_tris[:, 1]]
    v2 = surf_points[surf_tris[:, 2]]
    for ix in range(nx):
        for iy in range(ny):
            ox, oy = cx[ix], cy[iy]
            # 2-D point-in-triangle of the column against each tri's xy proj
            d = np.stack([np.full(len(v0), ox), np.full(len(v0), oy)], -1)
            e1 = (v1 - v0)[:, :2]
            e2 = (v2 - v0)[:, :2]
            det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
            ok = np.abs(det) > 1e-18
            dd = d - v0[:, :2]
            w1 = (dd[:, 0] * e2[:, 1] - dd[:, 1] * e2[:, 0]) / np.where(ok, det, 1.0)
            w2 = (e1[:, 0] * dd[:, 1] - e1[:, 1] * dd[:, 0]) / np.where(ok, det, 1.0)
            hit = ok & (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1)
            if not hit.any():
                continue
            zs = (
                v0[hit][:, 2]
                + w1[hit] * (v1 - v0)[hit][:, 2]
                + w2[hit] * (v2 - v0)[hit][:, 2]
            )
            crossings = np.sort(zs)
            # parity count of crossings below each cell center
            below = np.searchsorted(crossings, cz)
            occ[ix, iy] = (below % 2) == 1

    if not occ.any():
        raise ValueError("voxelization produced an empty mesh; increase resolution")

    # shared grid vertices for occupied cells
    vid_map: dict[tuple[int, int, int], int] = {}
    points: list[tuple[float, float, float]] = []

    def vid(i, j, k):
        key = (i, j, k)
        if key not in vid_map:
            vid_map[key] = len(points)
            points.append((lo[0] + i * h, lo[1] + j * h, lo[2] + k * h))
        return vid_map[key]

    corner_offsets = [
        (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    ]
    kuhn = [
        (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
        (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
    ]
    tets = []
    for ix, iy, iz in zip(*np.where(occ)):
        corners = [vid(ix + a, iy + b, iz + c) for (a, b, c) in corner_offsets]
        for a, b, c, d in kuhn:
            tets.append((corners[a], corners[b], corners[c], corners[d]))

    pts = np.asarray(points, np.float32)
    tet_arr = np.asarray(tets, np.int32)
    d1 = pts[tet_arr[:, 1]] - pts[tet_arr[:, 0]]
    d2 = pts[tet_arr[:, 2]] - pts[tet_arr[:, 0]]
    d3 = pts[tet_arr[:, 3]] - pts[tet_arr[:, 0]]
    vol = np.einsum("ij,ij->i", np.cross(d1, d2), d3)
    flip = vol < 0
    tet_arr[flip, 1], tet_arr[flip, 2] = tet_arr[flip, 2].copy(), tet_arr[flip, 1].copy()
    tris = extract_surface(tet_arr, pts)
    return TetMesh(
        points=pts,
        tets=tet_arr,
        surface_tris=tris.astype(np.int32),
        surface_verts=np.unique(tris).astype(np.int32),
    )


def _closest_point_on_tris(p: np.ndarray, a, b, c) -> np.ndarray:
    """Closest points of (P, 3) points onto (F, 3, 3) triangles -> (P, F, 3).

    Vectorized Ericson RTCD 5.1.5 (numpy, host-side precompute only)."""
    ab, ac = b - a, c - a  # (F, 3)
    ap = p[:, None, :] - a[None]  # (P, F, 3)
    d1 = np.einsum("fk,pfk->pf", ab, ap)
    d2 = np.einsum("fk,pfk->pf", ac, ap)
    bp = p[:, None, :] - b[None]
    d3 = np.einsum("fk,pfk->pf", ab, bp)
    d4 = np.einsum("fk,pfk->pf", ac, bp)
    cp = p[:, None, :] - c[None]
    d5 = np.einsum("fk,pfk->pf", ab, cp)
    d6 = np.einsum("fk,pfk->pf", ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v_f = (vb / denom)[..., None]
    w_f = (vc / denom)[..., None]
    q = a[None] + v_f * ab[None] + w_f * ac[None]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ab = np.clip(d1 / np.where(np.abs(d1 - d3) > 1e-30, d1 - d3, 1e-30), 0, 1)
        t_ac = np.clip(d2 / np.where(np.abs(d2 - d6) > 1e-30, d2 - d6, 1e-30), 0, 1)
        den_bc = (d4 - d3) + (d5 - d6)
        t_bc = np.clip((d4 - d3) / np.where(np.abs(den_bc) > 1e-30, den_bc, 1e-30), 0, 1)
    q = np.where(((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0))[..., None],
                 b[None] + t_bc[..., None] * (c - b)[None], q)
    q = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                 a[None] + t_ac[..., None] * ac[None], q)
    q = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                 a[None] + t_ab[..., None] * ab[None], q)
    q = np.where(((d6 >= 0) & (d5 <= d6))[..., None], np.broadcast_to(c[None], q.shape), q)
    q = np.where(((d3 >= 0) & (d4 <= d3))[..., None], np.broadcast_to(b[None], q.shape), q)
    q = np.where(((d1 <= 0) & (d2 <= 0))[..., None], np.broadcast_to(a[None], q.shape), q)
    return q


def _ray_parity_inside(points: np.ndarray, v0, v1, v2) -> np.ndarray:
    """Inside test by +z ray-crossing parity, grouped by (x, y) columns."""
    inside = np.zeros(len(points), bool)
    cols, col_inv = np.unique(np.round(points[:, :2] / 1e-9).astype(np.int64),
                              axis=0, return_inverse=True)
    e1 = (v1 - v0)[:, :2]
    e2 = (v2 - v0)[:, :2]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    ok = np.abs(det) > 1e-18
    for ci in range(len(cols)):
        sel = col_inv == ci
        ox, oy = points[sel][0, 0], points[sel][0, 1]
        dd = np.stack([np.full(len(v0), ox), np.full(len(v0), oy)], -1) - v0[:, :2]
        w1 = (dd[:, 0] * e2[:, 1] - dd[:, 1] * e2[:, 0]) / np.where(ok, det, 1.0)
        w2 = (e1[:, 0] * dd[:, 1] - e1[:, 1] * dd[:, 0]) / np.where(ok, det, 1.0)
        hit = ok & (w1 >= 0) & (w2 >= 0) & (w1 + w2 <= 1)
        if not hit.any():
            continue
        zs = np.sort(
            v0[hit][:, 2]
            + w1[hit] * (v1 - v0)[hit][:, 2]
            + w2[hit] * (v2 - v0)[hit][:, 2]
        )
        below = np.searchsorted(zs, points[sel][:, 2])
        inside[sel] = (below % 2) == 1
    return inside


def isosurface_stuffing_tet_mesh(
    surf_points: np.ndarray,
    surf_tris: np.ndarray,
    resolution: int = 12,
    warp_alpha: float = 0.3,
) -> TetMesh:
    """Quality tetrahedralization of a closed triangle mesh: BCC lattice
    isosurface stuffing with boundary warping.

    The fTetWild-class replacement for the reference's wildmeshing
    MeshGenerator (reference mesh_gen.py:17-106 — AMIPS quality target,
    envelope epsilon): a body-centered-cubic lattice is stuffed with the
    standard BCC tets (dihedral angles bounded by construction, unlike the
    stair-stepped Kuhn-split voxel mesher); lattice points within
    ``warp_alpha * h`` of the surface snap onto their closest surface point
    (the Labelle–Shewchuk warp rule), so the boundary is smooth and
    conforming to O(h^2) instead of O(h). Interior-only tets are kept —
    the cut-cell stencil table of full isosurface stuffing is traded for
    the warp, which preserves its practical quality at these resolutions.
    """
    P = np.asarray(surf_points, np.float64)
    F = np.asarray(surf_tris, np.int64)
    lo = P.min(axis=0)
    hi = P.max(axis=0)
    size = hi - lo
    h = float(size.max()) / resolution
    pad = 1  # one lattice cell of padding so the surface never touches the hull
    dims = np.maximum(np.ceil(size / h).astype(int) + 2 * pad, 2)
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    origin = lo - pad * h

    # lattice: primary nodes (nx+1)*(ny+1)*(nz+1) then cell centers nx*ny*nz
    gi, gj, gk = np.meshgrid(
        np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
    )
    prim = origin + h * np.stack([gi, gj, gk], -1).reshape(-1, 3)
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    cent = origin + h * (np.stack([ci, cj, ck], -1).reshape(-1, 3) + 0.5)
    nodes = np.concatenate([prim, cent])
    n_prim = len(prim)

    def pid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    def cid(i, j, k):
        return n_prim + (i * ny + j) * nz + k

    # signed distance: unsigned via closest point (chunked), sign via parity
    v0, v1, v2 = P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]
    dist = np.empty(len(nodes))
    closest = np.empty((len(nodes), 3))
    chunk = max(1, 2_000_000 // max(len(F), 1))
    for s in range(0, len(nodes), chunk):
        q = _closest_point_on_tris(nodes[s : s + chunk], v0, v1, v2)
        d2 = ((nodes[s : s + chunk, None, :] - q) ** 2).sum(-1)
        amin = d2.argmin(axis=1)
        dist[s : s + chunk] = np.sqrt(d2[np.arange(len(amin)), amin])
        closest[s : s + chunk] = q[np.arange(len(amin)), amin]
    inside = _ray_parity_inside(nodes, v0, v1, v2)
    sd = np.where(inside, -dist, dist)

    # warp: snap near-surface lattice points onto the surface
    snap = dist < warp_alpha * h
    nodes = np.where(snap[:, None], closest, nodes)
    sd = np.where(snap, 0.0, sd)

    # BCC tets: for each pair of face-adjacent cells, 4 tets per shared face
    tets = []

    def add_face_tets(c1, c2, p_ids):
        for t in range(4):
            tets.append((c1, c2, p_ids[t], p_ids[(t + 1) % 4]))

    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                c1 = cid(ix, iy, iz)
                if ix + 1 < nx:  # face ⟂x between cells
                    ps = [pid(ix + 1, iy, iz), pid(ix + 1, iy + 1, iz),
                          pid(ix + 1, iy + 1, iz + 1), pid(ix + 1, iy, iz + 1)]
                    add_face_tets(c1, cid(ix + 1, iy, iz), ps)
                if iy + 1 < ny:
                    ps = [pid(ix, iy + 1, iz), pid(ix, iy + 1, iz + 1),
                          pid(ix + 1, iy + 1, iz + 1), pid(ix + 1, iy + 1, iz)]
                    add_face_tets(c1, cid(ix, iy + 1, iz), ps)
                if iz + 1 < nz:
                    ps = [pid(ix, iy, iz + 1), pid(ix + 1, iy, iz + 1),
                          pid(ix + 1, iy + 1, iz + 1), pid(ix, iy + 1, iz + 1)]
                    add_face_tets(c1, cid(ix, iy, iz + 1), ps)
    tets = np.asarray(tets, np.int64)

    # keep tets whose vertices are all inside or on the (warped) surface
    keep = (sd[tets] <= 1e-12).all(axis=1)
    tets = tets[keep]
    # drop degenerate tets the warp may have flattened
    d1 = nodes[tets[:, 1]] - nodes[tets[:, 0]]
    d2_ = nodes[tets[:, 2]] - nodes[tets[:, 0]]
    d3 = nodes[tets[:, 3]] - nodes[tets[:, 0]]
    vol6 = np.einsum("ij,ij->i", np.cross(d1, d2_), d3)
    ref_vol = h**3 / 12.0  # BCC tet volume at lattice spacing h
    good = np.abs(vol6) / 6.0 > 0.05 * ref_vol
    tets = tets[good]
    vol6 = vol6[good]
    if len(tets) == 0:
        raise ValueError("isosurface stuffing produced an empty mesh; raise resolution")
    flip = vol6 < 0
    tets[flip, 1], tets[flip, 2] = tets[flip, 2].copy(), tets[flip, 1].copy()

    # compact vertex ids
    used = np.unique(tets)
    remap = -np.ones(len(nodes), np.int64)
    remap[used] = np.arange(len(used))
    pts = nodes[used].astype(np.float32)
    tet_arr = remap[tets].astype(np.int32)
    tris = extract_surface(tet_arr, pts)
    return TetMesh(
        points=pts,
        tets=tet_arr,
        surface_tris=tris.astype(np.int32),
        surface_verts=np.unique(tris).astype(np.int32),
    )


def extract_surface(tets: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Boundary faces (appearing once), oriented outward.

    Equivalent of libuipc's label_surface + label_triangle_orient +
    flip_inward_triangles pipeline (reference uipc_object.py:181-187).
    """
    faces = np.concatenate(
        [
            tets[:, [0, 2, 1]],
            tets[:, [0, 1, 3]],
            tets[:, [0, 3, 2]],
            tets[:, [1, 2, 3]],
        ]
    )
    owner = np.repeat(np.arange(len(tets)), 4)
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    boundary = counts[inv] == 1
    bfaces = faces[boundary]
    bowner = owner[boundary]

    # orient outward: normal must point away from the owning tet's centroid
    centroids = points[tets[bowner]].mean(axis=1)
    v0, v1, v2 = points[bfaces[:, 0]], points[bfaces[:, 1]], points[bfaces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    outward = np.einsum("ij,ij->i", n, v0 - centroids) > 0
    bfaces[~outward] = bfaces[~outward][:, [0, 2, 1]]
    return bfaces


def union_meshes(parts: list[TetMesh]) -> tuple[TetMesh, np.ndarray]:
    """Disjoint union of tet meshes into ONE solver topology.

    Two separate gels pressing each other (the core GelSight-gripper
    scenario) become a single SoftBodyModel whose self-contact machinery
    resolves the gel-vs-gel barrier — no special FEM-FEM pairing code.

    Returns (union_mesh, vertex_offsets (len(parts)+1,)) so callers can
    slice each part's vertices back out (the reference tracks the same
    per-object global vertex offsets, uipc_sim.py:228-248).
    """
    offsets = np.zeros(len(parts) + 1, np.int64)
    pts, tets, tris = [], [], []
    for i, m in enumerate(parts):
        off = offsets[i]
        pts.append(np.asarray(m.points, np.float32))
        tets.append(np.asarray(m.tets, np.int64) + off)
        tris.append(np.asarray(m.surface_tris, np.int64) + off)
        offsets[i + 1] = off + m.points.shape[0]
    points = np.concatenate(pts)
    all_tets = np.concatenate(tets).astype(np.int32)
    all_tris = np.concatenate(tris).astype(np.int32)
    return (
        TetMesh(
            points=points,
            tets=all_tets,
            surface_tris=all_tris,
            surface_verts=np.unique(all_tris).astype(np.int32),
        ),
        offsets,
    )
