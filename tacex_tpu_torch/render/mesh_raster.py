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
``raster_attributes`` carries per-vertex attributes (the UVs of the textured
gel) through the same product, and ``sample_texture_bilinear`` fetches a
texture at them.
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


def _chunk(b: int, p: int, t: int, chunk: int | None, columns: int = 4) -> int:
    if chunk is None:
        chunk = max(1, CHUNK_ELEMENTS // max(1, columns * b * p))
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


def raster_attributes(
    verts_cam: torch.Tensor,  # (B, T, 3, 3) camera-frame triangles
    attrs: torch.Tensor,  # (T, 3, A) or (B, T, 3, A) per-vertex attributes (e.g. UV)
    pix: torch.Tensor,  # (P, 2) camera-frame pixel (x, y), shared by the B cameras
    near: float = 0.0,
    chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-hit depth and barycentrically interpolated attributes per pixel
    -> (depth (B, P), attr (B, P, A)); depth BIG and attr 0 where no
    triangle is hit. Attributes are affine in the pixel coordinates like z,
    so they ride the rasterizing product as extra columns. Of equally near
    hits the lowest-numbered triangle wins, whatever the chunking."""
    b, t = verts_cam.shape[0], verts_cam.shape[1]
    a = attrs.shape[-1]
    p = pix.shape[0]
    depth = torch.full((b, p), BIG, dtype=torch.float32, device=pix.device)
    attr = torch.zeros((b, p, a), dtype=torch.float32, device=pix.device)
    if t == 0:
        return depth, attr
    coeffs = triangle_affine_coeffs(verts_cam)  # (B, T, 3, 4)
    # attribute planes: the barycentric combination of the z plane
    x0, y0 = verts_cam[..., 0, 0], verts_cam[..., 0, 1]
    x1, y1 = verts_cam[..., 1, 0], verts_cam[..., 1, 1]
    x2, y2 = verts_cam[..., 2, 0], verts_cam[..., 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = area2.abs() > _EPS_AREA
    inv_area2 = torch.where(valid, 1.0 / torch.where(valid, area2, 1.0), 0.0)[..., None]

    def edge(xa, ya, xb, yb):
        return (-(yb - ya))[..., None], (xb - xa)[..., None], ((yb - ya) * xa - (xb - xa) * ya)[..., None]

    a0, b0, c0 = edge(x0, y0, x1, y1)
    a1, b1, c1 = edge(x1, y1, x2, y2)
    a2, b2, c2 = edge(x2, y2, x0, y0)
    v0, v1, v2 = attrs[..., 0, :], attrs[..., 1, :], attrs[..., 2, :]  # (..., T, A)
    aa = (a1 * v0 + a2 * v1 + a0 * v2) * inv_area2
    ab = (b1 * v0 + b2 * v1 + b0 * v2) * inv_area2
    ac = (c1 * v0 + c2 * v1 + c0 * v2) * inv_area2
    coeffs = torch.cat([coeffs, torch.stack([aa, ab, ac], dim=-2)], dim=-1)  # (B, T, 3, 4 + A)
    pvec = torch.cat([pix, torch.ones_like(pix[:, :1])], -1)  # (P, 3)
    step = _chunk(b, p, t, chunk, 4 + a)
    for t0 in range(0, t, step):
        out = torch.einsum("pk,btkj->bptj", pvec, coeffs[:, t0 : t0 + step])  # (B, P, t, 4 + A)
        inside = (out[..., 0] >= 0) & (out[..., 1] >= 0) & (out[..., 2] >= 0)
        z = torch.where(inside & (out[..., 3] > near), out[..., 3], BIG)
        idx = torch.argmin(z, dim=-1, keepdim=True)  # (B, P, 1): the first nearest
        z_best = torch.gather(z, 2, idx)[..., 0]
        a_best = torch.gather(out[..., 4:], 2, idx[..., None].expand(b, p, 1, a))[:, :, 0]
        better = z_best < depth
        depth = torch.where(better, z_best, depth)
        attr = torch.where(better[..., None], a_best, attr)
    return depth, attr


def sample_texture_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture fetch. tex: (th, tw, C); uv: (..., 2) in [0, 1]
    (u along the width, v along the height), clamped to the edge."""
    th, tw, ch = tex.shape
    u = torch.clamp(uv[..., 0], 0.0, 1.0) * (tw - 1)
    v = torch.clamp(uv[..., 1], 0.0, 1.0) * (th - 1)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, max=tw - 1)
    v1 = torch.clamp(v0 + 1, max=th - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    flat = tex.reshape(-1, ch)

    def fetch(idx):
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (ch,))

    return (
        fetch(v0 * tw + u0) * (1 - fu) * (1 - fv)
        + fetch(v0 * tw + u1) * fu * (1 - fv)
        + fetch(v1 * tw + u0) * (1 - fu) * fv
        + fetch(v1 * tw + u1) * fu * fv
    )


def world_tris_to_cam(cam_pos: torch.Tensor, cam_quat: torch.Tensor, tris_w: torch.Tensor) -> torch.Tensor:
    """(..., T, 3, 3) world triangles -> the frame of the camera at
    ``cam_pos`` (..., 3), ``cam_quat`` (..., 4) (+Z forward, wxyz)."""
    return maths.quat_apply_inverse(cam_quat[..., None, None, :], tris_w - cam_pos[..., None, None, :])


def transform_tris(pos: torch.Tensor, quat: torch.Tensor, tris: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Rigidly place (T, 3, 3) local-frame triangles at poses ``pos`` (..., 3),
    ``quat`` (..., 4) -> (..., T, 3, 3)."""
    return maths.quat_apply(quat[..., None, None, :], tris * scale) + pos[..., None, None, :]
