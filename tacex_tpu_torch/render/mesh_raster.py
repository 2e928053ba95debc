"""Batched orthographic triangle-mesh depth rasterizer (PyTorch).

Port of ``tacex_tpu/render/mesh_raster.py``. In the frame of an
orthographic camera a triangle's coverage and depth are affine in the pixel
coordinates (px, py):

  edge_i(p) = a_i px + b_i py + c_i     (>= 0 for all i  <=>  p inside)
  z(p)      = alpha px + beta py + gamma (the plane through the vertices)

so rasterizing P pixels against T triangles is one product of the (P, 3)
pixel vectors [px, py, 1] with (3, 4) coefficients a triangle, then a
masked minimum over T: the nearest hit with z > near, first-hit ray casting
with no BVH and no winding rule. Every function takes a leading batch of
cameras, so the whole env batch (both fingers of every env, in the Factory
tasks) is one call. The (B, P, T, 4) product is taken over chunks of
triangles, with a running (B, P) minimum, so its memory stays bounded.
"""

from __future__ import annotations

import torch

from ..core import maths

BIG = 1e9
_EPS_AREA = 1e-12
# elements of one chunk's (B, P, t, 4) product: 2^26 f32 = 256 MiB
CHUNK_ELEMENTS = 1 << 26


def triangle_affine_coeffs(verts_cam: torch.Tensor) -> torch.Tensor:
    """(..., T, 3, 3) camera-frame triangles (x right, y down, z forward) ->
    (..., T, 3, 4): per triangle, the three orientation-normalised edge
    functions and the z plane as coefficients of [px, py, 1]. A degenerate
    triangle (zero projected area: silhouette slivers, zero padding) gets a
    constant -BIG edge, so no pixel is inside it."""
    p0, p1, p2 = verts_cam[..., 0, :], verts_cam[..., 1, :], verts_cam[..., 2, :]
    x0, y0, z0 = p0.unbind(-1)
    x1, y1, z1 = p1.unbind(-1)
    x2, y2, z2 = p2.unbind(-1)

    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # twice the signed projected area
    valid = area2.abs() > _EPS_AREA
    s = torch.where(area2 >= 0, 1.0, -1.0)
    inv_area2 = torch.where(valid, 1.0 / torch.where(valid, area2, 1.0), 0.0)

    def edge(xa, ya, xb, yb):
        # e(p) = cross2(pb - pa, p - pa) = a px + b py + c
        return -(yb - ya), xb - xa, (yb - ya) * xa - (xb - xa) * ya

    a0, b0, c0 = edge(x0, y0, x1, y1)  # zero on p0 -> p1 (vertex 2's barycentric)
    a1, b1, c1 = edge(x1, y1, x2, y2)  # vertex 0's
    a2, b2, c2 = edge(x2, y2, x0, y0)  # vertex 1's

    za = (a1 * z0 + a2 * z1 + a0 * z2) * inv_area2
    zb = (b1 * z0 + b2 * z1 + b0 * z2) * inv_area2
    zc = (c1 * z0 + c2 * z1 + c0 * z2) * inv_area2

    c0 = torch.where(valid, s * c0, -BIG)
    return torch.stack(
        [
            torch.stack([s * a0, s * b0, c0], -1),
            torch.stack([s * a1, s * b1, s * c1], -1),
            torch.stack([s * a2, s * b2, s * c2], -1),
            torch.stack([za, zb, zc], -1),
        ],
        dim=-1,
    )


def _chunk(b: int, p: int, t: int, chunk: int | None) -> int:
    if chunk is None:
        chunk = max(1, CHUNK_ELEMENTS // max(1, 4 * b * p))
    return max(1, min(t, chunk))


def raster_depth(
    verts_cam: torch.Tensor,  # (B, T, 3, 3) camera-frame triangles
    pix: torch.Tensor,  # (P, 2) camera-frame pixel (x, y), shared by the B cameras
    near: float = 0.0,
    chunk: int | None = None,
) -> torch.Tensor:
    """Nearest triangle depth per pixel -> (B, P), BIG where no triangle is
    hit. ``chunk`` triangles are rasterized at a time (the default keeps the
    (B, P, chunk, 4) product under ``CHUNK_ELEMENTS``); the minimum does not
    depend on it."""
    b, t = verts_cam.shape[0], verts_cam.shape[1]
    p = pix.shape[0]
    depth = torch.full((b, p), BIG, dtype=torch.float32, device=pix.device)
    if t == 0:
        return depth
    coeffs = triangle_affine_coeffs(verts_cam)  # (B, T, 3, 4)
    pvec = torch.cat([pix, torch.ones_like(pix[:, :1])], -1)  # (P, 3)
    step = _chunk(b, p, t, chunk)
    for t0 in range(0, t, step):
        out = torch.einsum("pk,btkj->bptj", pvec, coeffs[:, t0 : t0 + step])  # (B, P, t, 4)
        inside = (out[..., 0] >= 0) & (out[..., 1] >= 0) & (out[..., 2] >= 0)
        z = out[..., 3]
        depth = torch.minimum(depth, torch.where(inside & (z > near), z, BIG).amin(-1))
    return depth


def world_tris_to_cam(cam_pos: torch.Tensor, cam_quat: torch.Tensor, tris_w: torch.Tensor) -> torch.Tensor:
    """(..., T, 3, 3) world triangles -> the frame of the camera at
    ``cam_pos`` (..., 3), ``cam_quat`` (..., 4) (+Z forward, wxyz)."""
    return maths.quat_apply_inverse(cam_quat[..., None, None, :], tris_w - cam_pos[..., None, None, :])


def transform_tris(pos: torch.Tensor, quat: torch.Tensor, tris: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Rigidly place (T, 3, 3) local-frame triangles at poses ``pos`` (..., 3),
    ``quat`` (..., 4) -> (..., T, 3, 3)."""
    return maths.quat_apply(quat[..., None, None, :], tris * scale) + pos[..., None, None, :]
