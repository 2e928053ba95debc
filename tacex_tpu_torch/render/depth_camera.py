"""Batched analytic depth camera (PyTorch).

Port of ``tacex_tpu/render/depth_camera.py``: scene geometry is analytic
(spheres, boxes, capsules, planes in fixed-capacity tensors) and depth is the
exact ray-primitive intersection of parallel rays cast along the camera axis
over the pixel grid (orthographic). A scene may also carry a world-space
triangle soup, rasterized in each camera's frame by ``mesh_raster``. The
whole env batch is one set of tensor ops.

Conventions: camera +Z forward, +X right (image width), +Y down (image
height). ``extent`` is the (width, height) in meters of the imaged window.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import maths
from . import mesh_raster

BIG = 1e9


@dataclasses.dataclass(frozen=True)
class SdfScene:
    """Fixed-capacity primitive soup, batched over a leading env axis.

    spheres: (N, S, 4)  -> center xyz, radius (radius <= 0 disables)
    boxes:   (N, B, 10) -> center xyz, quat wxyz, half-extents xyz
                           (half-extent x <= 0 disables)
    capsules:(N, C, 8)  -> endpoint a xyz, endpoint b xyz, radius, enabled
    planes:  (N, P, 4)  -> unit normal xyz, offset d (n.x = d)
    triangles: (N, T, 3, 3) optional world-space triangle soup (padded with
                           zero, degenerate triangles), rasterized by
                           ``render.mesh_raster``
    """

    spheres: torch.Tensor
    boxes: torch.Tensor
    capsules: torch.Tensor
    planes: torch.Tensor
    triangles: torch.Tensor | None = None


def _ray_sphere(o: torch.Tensor, d: torch.Tensor, sph: torch.Tensor) -> torch.Tensor:
    """Rays (N, P, 3) vs spheres (N, S, 4) -> nearest positive hit (N, P, S)."""
    c, r = sph[..., :3], sph[..., 3]
    oc = o[:, :, None, :] - c[:, None, :, :]  # (N, P, S, 3)
    b = (oc * d[:, :, None, :]).sum(-1)
    cq = (oc * oc).sum(-1) - (r * r)[:, None, :]
    disc = b * b - cq
    valid = (disc >= 0) & (r > 0)[:, None, :]
    sq = torch.sqrt(torch.where(valid, disc, 0.0))
    t = -b - sq
    return torch.where(valid & (t > 0), t, BIG)


def _ray_plane(o: torch.Tensor, d: torch.Tensor, pl: torch.Tensor) -> torch.Tensor:
    """(N, P, 3) rays vs (N, L, 4) planes -> (N, P, L)."""
    n, off = pl[..., :3], pl[..., 3]
    denom = torch.einsum("npk,nlk->npl", d, n)
    num = off[:, None, :] - torch.einsum("npk,nlk->npl", o, n)
    enabled = (n * n).sum(-1) > 0.5
    ok = denom.abs() > 1e-9
    t = num / torch.where(ok, denom, 1e-9)
    return torch.where(enabled[:, None, :] & ok & (t > 0), t, BIG)


def _ray_box(o: torch.Tensor, d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(N, P, 3) rays vs (N, B, 10) oriented boxes (slab method) -> (N, P, B)."""
    c, q, h = box[..., :3], box[..., 3:7], box[..., 7:10]
    ol = maths.quat_apply_inverse(q[:, None, :, :], o[:, :, None, :] - c[:, None, :, :])  # (N, P, B, 3)
    dl = maths.quat_apply_inverse(q[:, None, :, :], d[:, :, None, :].expand(ol.shape))
    inv = 1.0 / torch.where(dl.abs() > 1e-9, dl, 1e-9)
    t0 = (-h[:, None] - ol) * inv
    t1 = (h[:, None] - ol) * inv
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    enabled = box[..., 7] > 0
    hit = enabled[:, None, :] & (tmax >= tmin.clamp_min(0.0))
    t = torch.where(tmin > 0, tmin, tmax)  # inside the box -> exit face
    return torch.where(hit & (t > 0), t, BIG)


def _ray_capsule(o: torch.Tensor, d: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """(N, P, 3) rays vs (N, C, 8) capsules -> (N, P, C): the infinite
    cylinder clamped to the segment, plus the end-cap spheres."""
    a, b, r, en = cap[..., 0:3], cap[..., 3:6], cap[..., 6], cap[..., 7]
    ab = b - a
    ab2 = (ab * ab).sum(-1).clamp_min(1e-12)  # (N, C)
    ao = o[:, :, None, :] - a[:, None, :, :]  # (N, P, C, 3)
    dd = d[:, :, None, :].expand(ao.shape)
    ab_n = (ab / torch.sqrt(ab2)[..., None])[:, None]  # (N, 1, C, 3)
    d_par = (dd * ab_n).sum(-1)
    o_par = (ao * ab_n).sum(-1)
    d_perp = dd - d_par[..., None] * ab_n
    o_perp = ao - o_par[..., None] * ab_n
    A = (d_perp * d_perp).sum(-1)
    B = 2 * (d_perp * o_perp).sum(-1)
    C = (o_perp * o_perp).sum(-1) - (r * r)[:, None, :]
    disc = B * B - 4 * A * C
    okA = A > 1e-12
    sq = torch.sqrt(torch.where(disc >= 0, disc, 0.0))
    t_cyl = (-B - sq) / torch.where(okA, 2 * A, 1.0)
    s = o_par + t_cyl * d_par
    seg_len = torch.sqrt(ab2)[:, None, :]
    in_seg = (s >= 0) & (s <= seg_len)
    t_cyl = torch.where(okA & (disc >= 0) & in_seg & (t_cyl > 0), t_cyl, BIG)
    sph_a = torch.cat([a, r[..., None]], -1)
    sph_b = torch.cat([b, r[..., None]], -1)
    t_caps = torch.minimum(_ray_sphere(o, d, sph_a), _ray_sphere(o, d, sph_b))
    t = torch.minimum(t_cyl, t_caps)
    return torch.where(en[:, None, :] > 0.5, t, BIG)


def render_depth_batch(
    cam_pos: torch.Tensor,  # (N, 3)
    cam_quat: torch.Tensor,  # (N, 4)
    scene: SdfScene,
    resolution: tuple[int, int],  # (w, h)
    extent: tuple[float, float],  # (width_m, height_m) of the imaged window
    far: float,
) -> torch.Tensor:
    """Orthographic depth (N, h, w) in meters for the whole env batch."""
    w, h = resolution
    ex, ey = extent
    dev = cam_pos.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * ex - ex / 2
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * ey - ey / 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    origins_cam = torch.stack([xx, yy, torch.zeros_like(xx)], -1).reshape(1, -1, 3)  # (1, P, 3)
    o = maths.quat_apply(cam_quat[:, None, :], origins_cam) + cam_pos[:, None, :]  # (N, P, 3)
    z = torch.zeros_like(cam_pos)
    z[:, 2] = 1.0
    fwd = maths.quat_apply(cam_quat, z)  # (N, 3)
    d = fwd[:, None, :].expand(o.shape)

    t = torch.cat(
        [
            _ray_sphere(o, d, scene.spheres),
            _ray_box(o, d, scene.boxes),
            _ray_capsule(o, d, scene.capsules),
            _ray_plane(o, d, scene.planes),
        ],
        dim=-1,
    ).amin(-1)
    if scene.triangles is not None and scene.triangles.shape[1] > 0:
        tris_cam = mesh_raster.world_tris_to_cam(cam_pos, cam_quat, scene.triangles)
        t = torch.minimum(t, mesh_raster.raster_depth(tris_cam, origins_cam[0, :, :2]))
    t = torch.clamp(t, max=far)
    return t.reshape(-1, h, w)


def render_depth(
    cam_pos: torch.Tensor,  # (3,)
    cam_quat: torch.Tensor,  # (4,)
    scene_spheres: torch.Tensor,
    scene_boxes: torch.Tensor,
    scene_capsules: torch.Tensor,
    scene_planes: torch.Tensor,
    resolution: tuple[int, int],
    extent: tuple[float, float],
    far: float,
    scene_triangles: torch.Tensor | None = None,  # (T, 3, 3) world-space
) -> torch.Tensor:
    """Orthographic depth (h, w) in meters for one env."""
    tris = None if scene_triangles is None else scene_triangles[None]
    scene = SdfScene(scene_spheres[None], scene_boxes[None], scene_capsules[None], scene_planes[None], tris)
    return render_depth_batch(cam_pos[None], cam_quat[None], scene, resolution, extent, far)[0]
