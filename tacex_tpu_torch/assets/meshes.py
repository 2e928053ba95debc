"""Triangle-mesh asset library: procedural generators + binary STL loader.

Counterpart of the reference's USD mesh props (tactile_test_shapes/*.usd,
Factory pegs/gears/nuts in factory_tasks_cfg, Franka collision STLs). USD
binaries can't be parsed without pxr, so the test shapes and Factory parts
are generated procedurally with matching dimensions; the Franka collision
meshes (plain binary STL in the reference asset tree) load directly.

All generators return a float32 ``(T, 3, 3)`` triangle soup in the local
frame, +Z = "up" (away from whatever the part presses into), units meters.
Use :func:`pad_tris` to fix the triangle capacity for a jitted scene and
``render.mesh_raster.transform_tris`` to place instances.
"""

from __future__ import annotations

import math
import struct

import numpy as np


def _f(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def pad_tris(tris: np.ndarray, capacity: int) -> np.ndarray:
    """Zero-pad a (T, 3, 3) soup to (capacity, 3, 3); zero triangles are
    degenerate and ignored by the rasterizer."""
    T = tris.shape[0]
    if T > capacity:
        raise ValueError(f"mesh has {T} triangles > capacity {capacity}")
    out = np.zeros((capacity, 3, 3), dtype=np.float32)
    out[:T] = tris
    return out


def load_stl(path: str) -> np.ndarray:
    """Binary STL -> (T, 3, 3) float32 triangle soup (vertex coords only)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:5] == b"solid" and b"facet" in data[:500]:
        # ASCII STL
        verts = []
        for line in data.decode("utf-8", "ignore").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(v) for v in parts[1:4]])
        return _f(verts).reshape(-1, 3, 3)
    (n_tris,) = struct.unpack("<I", data[80:84])
    rec = np.frombuffer(data[84 : 84 + 50 * n_tris], dtype=np.uint8).reshape(n_tris, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tris, 4, 3)
    return floats[:, 1:4].astype(np.float32)  # drop the normal row


# ---------------------------------------------------------------------------
# primitive generators


def box_mesh(hx: float, hy: float, hz: float) -> np.ndarray:
    """Axis-aligned box with half-extents, centered at origin. 12 triangles."""
    s = _f([[x, y, z] for x in (-hx, hx) for y in (-hy, hy) for z in (-hz, hz)])
    # faces as corner indices into the (x,y,z) binary ordering above
    quads = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for a, b, c, d in quads:
        tris.append([s[a], s[b], s[c]])
        tris.append([s[a], s[c], s[d]])
    return _f(tris)


def icosphere(radius: float, subdivisions: int = 3) -> np.ndarray:
    """Geodesic sphere; 20 * 4**subdivisions triangles."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = _f(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ]
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    tris = v[f]  # (20, 3, 3)
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    return (tris * radius).astype(np.float32)


def _circle(r: float, n: int, phase: float = 0.0) -> np.ndarray:
    a = np.arange(n) * (2 * math.pi / n) + phase
    return np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)


def _resample_loop(pts: np.ndarray, n: int) -> np.ndarray:
    """Resample a closed 2D polyline to n points by arc length."""
    closed = np.concatenate([pts, pts[:1]])
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    want = np.arange(n) * (total / n)
    idx = np.searchsorted(cum, want, side="right") - 1
    idx = np.clip(idx, 0, len(seg) - 1)
    frac = (want - cum[idx]) / np.maximum(seg[idx], 1e-12)
    return (closed[idx] * (1 - frac[:, None]) + closed[idx + 1] * frac[:, None]).astype(
        np.float32
    )


def _wall(loop: np.ndarray, z0: float, z1: float) -> np.ndarray:
    """Side wall between two z levels of a closed 2D loop."""
    n = loop.shape[0]
    lo = np.concatenate([loop, np.full((n, 1), z0, np.float32)], -1)
    hi = np.concatenate([loop, np.full((n, 1), z1, np.float32)], -1)
    lo2, hi2 = np.roll(lo, -1, 0), np.roll(hi, -1, 0)
    return np.concatenate(
        [np.stack([lo, lo2, hi2], 1), np.stack([lo, hi2, hi], 1)]
    ).astype(np.float32)


def _fan_cap(loop: np.ndarray, z: float) -> np.ndarray:
    """Centroid-fan cap of a star-shaped (wrt centroid) closed loop at z."""
    c2 = loop.mean(0)
    n = loop.shape[0]
    c = np.array([c2[0], c2[1], z], np.float32)
    a = np.concatenate([loop, np.full((n, 1), z, np.float32)], -1)
    b = np.roll(a, -1, 0)
    return np.stack([np.broadcast_to(c, a.shape), a, b], 1).astype(np.float32)


def _annulus_cap(outer: np.ndarray, inner: np.ndarray, z: float) -> np.ndarray:
    """Cap the region between an outer and inner loop (same point count)."""
    n = outer.shape[0]
    zc = np.full((n, 1), z, np.float32)
    o = np.concatenate([outer, zc], -1)
    i = np.concatenate([inner, zc], -1)
    o2, i2 = np.roll(o, -1, 0), np.roll(i, -1, 0)
    return np.concatenate(
        [np.stack([o, o2, i2], 1), np.stack([o, i2, i], 1)]
    ).astype(np.float32)


def _flip(tris: np.ndarray) -> np.ndarray:
    """Reverse winding (flip normals) of a (T, 3, 3) soup."""
    return tris[:, ::-1]


def extrude(
    outer: np.ndarray, height: float, inner: np.ndarray | None = None, z0: float = 0.0
) -> np.ndarray:
    """Extrude a 2D CCW profile (optional hole) from z0 to z0+height.

    Consistently OUTWARD-oriented closed surface: bottom caps and the inner
    (hole) wall are winding-flipped relative to their top/outer twins —
    required by the divergence-theorem mass/inertia integrals
    (weld_soup -> abd._mesh_moments) and the closed-surface solvers; the
    depth rasterizer itself is winding-agnostic.
    """
    z1 = z0 + height
    parts = [_wall(outer, z0, z1)]
    if inner is None:
        parts += [_flip(_fan_cap(outer, z0)), _fan_cap(outer, z1)]
    else:
        if inner.shape[0] != outer.shape[0]:
            inner = _resample_loop(inner, outer.shape[0])
        parts += [
            _flip(_wall(inner, z0, z1)),
            _flip(_annulus_cap(outer, inner, z0)),
            _annulus_cap(outer, inner, z1),
        ]
    return np.concatenate(parts)


def cylinder_mesh(radius: float, height: float, segments: int = 48) -> np.ndarray:
    """Capped cylinder, axis +Z, base at z=0."""
    return extrude(_circle(radius, segments), height)


def tube_mesh(r_out: float, r_in: float, height: float, segments: int = 48) -> np.ndarray:
    """Hollow cylinder (e.g. Factory hole counterpart / cylinder_shell prop)."""
    return extrude(_circle(r_out, segments), height, inner=_circle(r_in, segments))


def cone_mesh(radius: float, height: float, segments: int = 48) -> np.ndarray:
    """Cone, base at z=0, apex at (0,0,height)."""
    loop = _circle(radius, segments)
    apex = np.array([0, 0, height], np.float32)
    base3 = np.concatenate([loop, np.zeros((segments, 1), np.float32)], -1)
    side = np.stack([base3, np.roll(base3, -1, 0), np.broadcast_to(apex, base3.shape)], 1)
    return np.concatenate([side.astype(np.float32), _flip(_fan_cap(loop, 0.0))])


def torus_mesh(major: float, minor: float, seg_u: int = 36, seg_v: int = 18) -> np.ndarray:
    """Torus in the z = minor plane (resting on z=0), axis +Z."""
    u = np.arange(seg_u) * (2 * math.pi / seg_u)
    v = np.arange(seg_v) * (2 * math.pi / seg_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    y = (major + minor * np.cos(vv)) * np.sin(uu)
    z = minor * np.sin(vv) + minor
    P = np.stack([x, y, z], -1).astype(np.float32)  # (U, V, 3)
    a = P
    b = np.roll(P, -1, 0)
    c = np.roll(np.roll(P, -1, 0), -1, 1)
    d = np.roll(P, -1, 1)
    t1 = np.stack([a, b, c], 2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], 2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2])


def capsule_mesh(radius: float, length: float, subdivisions: int = 2) -> np.ndarray:
    """Capsule along +Z from z=0 to z=length with hemispherical ends,
    centered laterally; built by displacing an icosphere's halves."""
    sph = icosphere(radius, subdivisions)
    out = sph.copy()
    out[..., 2] += np.where(sph[..., 2] >= 0, length / 2, -length / 2).astype(np.float32)
    return out


def hex_prism(width_across_flats: float, height: float) -> np.ndarray:
    """Solid hexagonal prism (hexagon prop / nut blank), base at z=0."""
    r = width_across_flats / math.sqrt(3.0)  # circumradius
    return extrude(_circle(r, 6, phase=math.pi / 6), height)


def nut_mesh(width_across_flats: float, hole_radius: float, height: float, segments: int = 36) -> np.ndarray:
    """Hex nut: hexagonal outside, cylindrical bore (Factory NutThread part,
    reference factory_tasks_cfg nut assets)."""
    r = width_across_flats / math.sqrt(3.0)
    outer = _resample_loop(_circle(r, 6, phase=math.pi / 6), segments)
    return extrude(outer, height, inner=_circle(hole_radius, segments))


def gear_mesh(
    r_root: float, r_tip: float, n_teeth: int, height: float, seg_per_tooth: int = 4
) -> np.ndarray:
    """Spur gear with rectangular teeth (Factory GearMesh part)."""
    pts = []
    for i in range(n_teeth):
        a0 = 2 * math.pi * i / n_teeth
        a1 = 2 * math.pi * (i + 0.5) / n_teeth
        a2 = 2 * math.pi * (i + 1) / n_teeth
        for k in range(seg_per_tooth):
            a = a0 + (a1 - a0) * k / seg_per_tooth
            pts.append([r_tip * math.cos(a), r_tip * math.sin(a)])
        for k in range(seg_per_tooth):
            a = a1 + (a2 - a1) * k / seg_per_tooth
            pts.append([r_root * math.cos(a), r_root * math.sin(a)])
    return extrude(_f(pts), height)


def peg_mesh(radius: float, length: float, square: bool = False, segments: int = 32) -> np.ndarray:
    """Factory insertion peg, axis +Z, base at z=0 (round or square)."""
    if square:
        return box_mesh(radius, radius, length / 2) + _f([0, 0, length / 2])
    return cylinder_mesh(radius, length, segments)


# ---------------------------------------------------------------------------
# tactile test-shape mesh library (dimensions in mm to mirror assets/shapes.py,
# returned in meters)

_MM = 1e-3


def _shape_library() -> dict:
    return {
        "sphere": lambda: icosphere(4.0 * _MM, 3),
        "sphere2": lambda: icosphere(2.5 * _MM, 3),
        "cylinder": lambda: cylinder_mesh(3.0 * _MM, 6.0 * _MM),
        "cylinder_shell": lambda: tube_mesh(4.0 * _MM, 2.5 * _MM, 6.0 * _MM),
        "cylinder_side": lambda: _rot_x90(cylinder_mesh(2.5 * _MM, 10.0 * _MM)),
        "cone": lambda: cone_mesh(4.0 * _MM, 4.0 * _MM),
        "torus": lambda: torus_mesh(3.0 * _MM, 1.2 * _MM),
        "cube": lambda: box_mesh(3.0 * _MM, 3.0 * _MM, 3.0 * _MM) + _f([0, 0, 3.0 * _MM]),
        "hexagon": lambda: hex_prism(6.0 * _MM, 4.0 * _MM),
        "prism": lambda: _rot_x90(_prism_tri(1.5 * _MM, 60.0, 8.0 * _MM)),
        "flat_slab": lambda: box_mesh(5.0 * _MM, 5.0 * _MM, 1.5 * _MM) + _f([0, 0, 1.5 * _MM]),
        "nut": lambda: nut_mesh(12.0 * _MM, 4.0 * _MM, 6.0 * _MM),
        "gear": lambda: gear_mesh(6.0 * _MM, 8.0 * _MM, 12, 5.0 * _MM),
        "peg_round": lambda: peg_mesh(4.0 * _MM, 25.0 * _MM),
        "peg_square": lambda: peg_mesh(4.0 * _MM, 25.0 * _MM, square=True),
    }


def _rot_x90(tris: np.ndarray) -> np.ndarray:
    """Rotate +Z axis onto +Y (lay a part on its side), keep resting on z=0."""
    out = tris[..., [0, 2, 1]].copy()
    out[..., 1] *= -1
    out[..., 2] -= out[..., 2].min()
    return out


def _prism_tri(half_w: float, angle_deg: float, length: float) -> np.ndarray:
    h = half_w * math.tan(math.radians(angle_deg))
    profile = _f([[-half_w, 0], [half_w, 0], [0, h]])
    return extrude(profile, length)


MESH_SHAPE_NAMES: tuple[str, ...] = tuple(sorted(_shape_library().keys()))


def shape_mesh(name: str) -> np.ndarray:
    """(T, 3, 3) float32 triangle soup, meters, resting on/above z=0."""
    lib = _shape_library()
    if name not in lib:
        raise KeyError(f"unknown mesh shape {name!r}; have {MESH_SHAPE_NAMES}")
    return lib[name]().astype(np.float32)


def weld_soup(tris: np.ndarray, tol: float = 1e-6) -> tuple[np.ndarray, np.ndarray]:
    """(T, 3, 3) triangle soup -> indexed mesh (points (V, 3), faces (T, 3)).

    Coincident vertices (within ``tol``) are welded — the form the affine-body
    solver needs (shared vertices so surface moments and contact candidates
    see one closed surface, not 3T loose corners)."""
    flat = np.asarray(tris, np.float64).reshape(-1, 3)
    key = np.round(flat / tol).astype(np.int64)
    _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    return flat[idx].astype(np.float32), inv.reshape(-1, 3).astype(np.int32)
