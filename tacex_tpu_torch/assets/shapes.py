"""Analytic indenter shape library (tactile test shapes).

A copy of the JAX package's numpy-only ``assets/shapes.py``.

Counterpart of the reference's 25 ``Props/tactile_test_shapes`` USD meshes
(reference tacex_assets data dir; pressed into the gel by
scripts/demos/shape_touch/run_shape_touch.py). Instead of triangle meshes,
each shape is an analytic height-map function z(x, y) in mm over the sensor
window — exact, resolution-independent, and free for the depth camera to
evaluate (SDF-style; no meshing required).

All generators return height maps in the Taxim "processed" convention:
0 = the shape's lowest point touching the gel plane; larger = farther away.
Press them in with a ``press_depth``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

ShapeFn = Callable[[np.ndarray, np.ndarray], np.ndarray]  # (x_mm, y_mm) -> z_mm

FAR = 6.0  # background height (mm)


def _grid(h: int, w: int, pixmm: float) -> tuple[np.ndarray, np.ndarray]:
    y = (np.arange(h) - h / 2 + 0.5) * pixmm
    x = (np.arange(w) - w / 2 + 0.5) * pixmm
    yy, xx = np.meshgrid(y, x, indexing="ij")
    return xx, yy


def sphere(radius: float = 4.0) -> ShapeFn:
    def fn(x, y):
        r2 = x * x + y * y
        inside = r2 < radius * radius
        return np.where(inside, radius - np.sqrt(np.maximum(radius * radius - r2, 0)), FAR)

    return fn


def cylinder_flat(radius: float = 3.0) -> ShapeFn:
    """Flat-ended cylinder pressed axially."""
    def fn(x, y):
        return np.where(x * x + y * y < radius * radius, 0.0, FAR)

    return fn


def cylinder_side(radius: float = 2.5) -> ShapeFn:
    """Cylinder lying on its side (axis along y)."""
    def fn(x, y):
        inside = np.abs(x) < radius
        return np.where(inside, radius - np.sqrt(np.maximum(radius**2 - x * x, 0)), FAR)

    return fn


def cone(radius: float = 4.0, height: float = 4.0) -> ShapeFn:
    def fn(x, y):
        r = np.sqrt(x * x + y * y)
        return np.where(r < radius, r * (height / radius), FAR)

    return fn


def ring(outer: float = 4.0, inner: float = 2.5) -> ShapeFn:
    def fn(x, y):
        r = np.sqrt(x * x + y * y)
        return np.where((r < outer) & (r > inner), 0.0, FAR)

    return fn


def torus(major: float = 3.0, minor: float = 1.2) -> ShapeFn:
    def fn(x, y):
        r = np.sqrt(x * x + y * y)
        d2 = minor**2 - (r - major) ** 2
        return np.where(d2 > 0, minor - np.sqrt(np.maximum(d2, 0)), FAR)

    return fn


def cube_face(half: float = 3.0) -> ShapeFn:
    def fn(x, y):
        return np.where((np.abs(x) < half) & (np.abs(y) < half), 0.0, FAR)

    return fn


def cube_edge(half: float = 3.0, angle_deg: float = 45.0) -> ShapeFn:
    """Cube pressed on an edge: a V ridge along y."""
    s = math.tan(math.radians(angle_deg))

    def fn(x, y):
        z = np.abs(x) * s
        return np.where((np.abs(x) < half) & (np.abs(y) < half * 1.4), z, FAR)

    return fn


def cube_corner(half: float = 3.0) -> ShapeFn:
    def fn(x, y):
        z = (np.abs(x) + np.abs(y)) * 0.8
        return np.where(z < half * 1.6, z, FAR)

    return fn


def pyramid(half: float = 3.5, height: float = 3.0) -> ShapeFn:
    def fn(x, y):
        d = np.maximum(np.abs(x), np.abs(y))
        return np.where(d < half, d * (height / half), FAR)

    return fn


def prism(half_w: float = 1.5, angle_deg: float = 60.0, length: float = 8.0) -> ShapeFn:
    s = math.tan(math.radians(angle_deg))

    def fn(x, y):
        return np.where((np.abs(x) < half_w) & (np.abs(y) < length / 2), np.abs(x) * s, FAR)

    return fn


def capsule_side(radius: float = 1.5, length: float = 5.0) -> ShapeFn:
    def fn(x, y):
        yy = np.clip(np.abs(y) - length / 2, 0, None)
        d2 = x * x + yy * yy
        inside = d2 < radius * radius
        return np.where(inside, radius - np.sqrt(np.maximum(radius**2 - d2, 0)), FAR)

    return fn


def hemisphere_grid(radius: float = 1.0, pitch: float = 4.0, n: int = 3) -> ShapeFn:
    def fn(x, y):
        z = np.full_like(x, FAR)
        for i in range(n):
            for j in range(n):
                cx = (i - (n - 1) / 2) * pitch
                cy = (j - (n - 1) / 2) * pitch
                r2 = (x - cx) ** 2 + (y - cy) ** 2
                zz = np.where(r2 < radius**2, radius - np.sqrt(np.maximum(radius**2 - r2, 0)), FAR)
                z = np.minimum(z, zz)
        return z

    return fn


def cross_shape(arm: float = 4.0, width: float = 1.2) -> ShapeFn:
    def fn(x, y):
        in_cross = ((np.abs(x) < width) & (np.abs(y) < arm)) | (
            (np.abs(y) < width) & (np.abs(x) < arm)
        )
        return np.where(in_cross, 0.0, FAR)

    return fn


def star(points: int = 5, r_out: float = 4.0, r_in: float = 1.8) -> ShapeFn:
    def fn(x, y):
        theta = np.arctan2(y, x)
        r = np.sqrt(x * x + y * y)
        k = points
        a = np.mod(theta * k / (2 * np.pi) + 0.5, 1.0) - 0.5
        boundary = r_in + (r_out - r_in) * (1 - np.abs(a) * 2)
        return np.where(r < boundary, 0.0, FAR)

    return fn


def wave_ridges(wavelength: float = 3.0, amp: float = 1.0) -> ShapeFn:
    def fn(x, y):
        z = amp * (1 + np.sin(2 * np.pi * x / wavelength)) / 2
        return np.where((np.abs(x) < 7) & (np.abs(y) < 7), z, FAR)

    return fn


def dot_line(radius: float = 0.8, pitch: float = 2.5, n: int = 5) -> ShapeFn:
    def fn(x, y):
        z = np.full_like(x, FAR)
        for i in range(n):
            cx = (i - (n - 1) / 2) * pitch
            r2 = (x - cx) ** 2 + y * y
            zz = np.where(r2 < radius**2, radius - np.sqrt(np.maximum(radius**2 - r2, 0)), FAR)
            z = np.minimum(z, zz)
        return z

    return fn


def letter_t(width: float = 6.0, bar: float = 1.4) -> ShapeFn:
    def fn(x, y):
        top = (np.abs(x) < width / 2) & (np.abs(y - width / 3) < bar / 2)
        stem = (np.abs(x) < bar / 2) & (y < width / 3) & (y > -width / 2)
        return np.where(top | stem, 0.0, FAR)

    return fn


def ellipsoid(rx: float = 4.0, ry: float = 2.5, rz: float = 3.0) -> ShapeFn:
    def fn(x, y):
        q = 1 - (x / rx) ** 2 - (y / ry) ** 2
        return np.where(q > 0, rz * (1 - np.sqrt(np.maximum(q, 0))), FAR)

    return fn


def tilted_plane(slope: float = 0.35) -> ShapeFn:
    def fn(x, y):
        z = slope * (x + 6)
        return np.where((np.abs(x) < 6) & (np.abs(y) < 6), np.maximum(z, 0), FAR)

    return fn


SHAPE_LIBRARY: dict[str, ShapeFn] = {
    "sphere_small": sphere(2.5),
    "sphere_medium": sphere(4.0),
    "sphere_large": sphere(6.0),
    "cylinder_flat": cylinder_flat(3.0),
    "cylinder_flat_small": cylinder_flat(1.5),
    "cylinder_side": cylinder_side(2.5),
    "capsule_side": capsule_side(),
    "cone": cone(),
    "cone_sharp": cone(3.0, 5.0),
    "ring": ring(),
    "ring_thin": ring(4.0, 3.4),
    "torus": torus(),
    "cube_face": cube_face(),
    "cube_small": cube_face(1.5),
    "cube_edge": cube_edge(),
    "cube_corner": cube_corner(),
    "pyramid": pyramid(),
    "prism": prism(),
    "hemisphere_grid": hemisphere_grid(),
    "cross": cross_shape(),
    "star": star(),
    "wave_ridges": wave_ridges(),
    "dot_line": dot_line(),
    "letter_t": letter_t(),
    "ellipsoid": ellipsoid(),
    "tilted_plane": tilted_plane(),
}


def shape_height_map(name: str, resolution: tuple[int, int] = (240, 320), pixmm: float = 0.059) -> np.ndarray:
    """(h, w) float32 height map in mm for a library shape."""
    h, w = resolution
    xx, yy = _grid(h, w, pixmm)
    return SHAPE_LIBRARY[name](xx, yy).astype(np.float32)
