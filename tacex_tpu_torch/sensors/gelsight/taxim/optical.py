"""Taxim optical simulation: height map -> tactile RGB (PyTorch).

Port of ``tacex_tpu/sensors/gelsight/taxim/optical.py``:

  1. gel-pad deformation: clamp the object height map against the gel rest
     surface, then the masked Gaussian pyramid (kernel ``ops/pyramid.py``);
  2. surface normals by central differences -> gradient (magnitude, direction);
  3. per-pixel shading: bin the gradients into the (num_bins x num_bins) LUT
     and evaluate the quadratic [x^2, y^2, xy, x, y, 1] model from the
     pixel's row (kernel ``ops/lut_shade.py``). ``interp="bilinear"``
     interpolates the LUT over (magnitude, direction) instead, in plain
     differentiable ops; ``compact_capacity`` shades every pixel from the
     125-row magnitude-bin-0 subtable (the same kernel, through
     ``dir_row_shade``) and then only the pixels of higher bins, compacted
     with one ``topk``, from the full table (the same kernel, as one flat
     row of pixels with their own features); ``lut_dtype=torch.bfloat16``
     rounds the full table to bf16 (the kernel's bf16 entry widens each row
     to f32), while the compact path's 125-row subtable stays f32;
  4. optional shadow pass: attenuation values ray-marched from the
     contact-boundary pixels along the calibrated light directions,
     composited with one scatter-min;
  5. add the background frame, clip to [0, 1].

Out of contact the gradient is float noise (|grad| ~ 1e-8 at 32x24), so its
direction bin, and the shade of those pixels, depends on the order of the
float operations in the blur: any two implementations differ there by up to
the LUT's magnitude-bin-0 direction spread (about 0.12).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ....ops.blur import box_dilate, gaussian_blur
from ....ops.lut_shade import dir_row_shade, lut_shade
from ....ops.pyramid import deformation_pyramid
from .calib import SHADOW_DEPTH_0, SHADOW_HEIGHT_IDX_OFFSET, TaximCalib


def shift_height_map(height_map: torch.Tensor, press_depth_mm: torch.Tensor) -> torch.Tensor:
    """Place the object so its closest point is ``press_depth_mm`` below the
    gel top. ``press_depth_mm``: (...,)."""
    hm_min = height_map.amin(dim=(-2, -1), keepdim=True)
    return height_map - hm_min - press_depth_mm[..., None, None]


def deformation_inputs(calib: TaximCalib, height_map: torch.Tensor):
    """The pyramid's inputs for ``height_map`` (..., h, w) mm: the height map
    clamped against the gel surface, the pin mask, and the
    ``(sigma_x, sigma_y)`` levels (pyramid levels, then the final blur)."""
    h, w = height_map.shape[-2:]
    sim = calib.sim_params
    pressing_depth = -height_map.amin(dim=(-2, -1), keepdim=True)
    contact_mask = height_map < 0

    gel_map = calib.gel_map
    joined = torch.minimum(height_map, gel_map)
    # pixels pressed deeper than contact_scale * press_depth stay pinned
    mask = ((joined - gel_map) < -pressing_depth * sim.contact_scale) & contact_mask
    sigmas = list(sim.deform_pyramid_sigma((h, w))) + [sim.deform_final_sigma((h, w))]
    return joined, mask, sigmas


def compute_gel_deformation(calib: TaximCalib, height_map: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Deform the gel pad under ``height_map`` (..., h, w) mm (0 = gel top,
    negative = penetration). Returns (deformed (..., h, w) mm, pin mask)."""
    h, w = height_map.shape[-2:]
    joined, mask, sigmas = deformation_inputs(calib, height_map)
    blurred = deformation_pyramid(
        joined.reshape(-1, h, w).contiguous(), mask.reshape(-1, h, w).contiguous(), sigmas
    )
    return blurred.reshape(height_map.shape), mask


def generate_normals(calib: TaximCalib, height_map_px: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient magnitude/direction maps by central differences.

    ``height_map_px``: (..., h, w) in pixel height units (mm / pixmm),
    negated so that bumps point up. Gradients are rescaled into
    full-calibration-resolution pixel units. The double ``where`` keeps the
    NaN-free form of the JAX package (sqrt and atan2 at 0).
    """
    h, w = height_map_px.shape[-2:]
    full_h, full_w = calib.sensor_params.height, calib.sensor_params.width
    top = height_map_px[..., 0 : h - 2, 1 : w - 1]
    bot = height_map_px[..., 2:h, 1 : w - 1]
    left = height_map_px[..., 1 : h - 1, 0 : w - 2]
    right = height_map_px[..., 1 : h - 1, 2:w]
    dzdx = (bot - top) * (0.5 * h / full_h)
    dzdy = (right - left) * (0.5 * w / full_w)

    mag2 = dzdx * dzdx + dzdy * dzdy
    nz = mag2 > 0
    mag_tan = torch.sqrt(torch.where(nz, mag2, 1.0))
    mag_tan = torch.where(nz, mag_tan, 0.0)
    grad_mag = torch.atan(mag_tan)
    sx = torch.where(nz, dzdx, 1.0)
    sy = torch.where(nz, dzdy, 1.0)
    grad_dir = torch.where(nz, torch.atan2(sx, sy), 0.0)

    def pad_edge(x):
        return F.pad(x.reshape(-1, 1, h - 2, w - 2), (1, 1, 1, 1), mode="replicate").reshape(
            height_map_px.shape
        )

    return pad_edge(grad_mag), pad_edge(grad_dir)


def lut_bins(calib: TaximCalib, grad_mag: torch.Tensor, grad_dir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floor-binned (magnitude, direction) LUT indices, int32."""
    nb = calib.sensor_params.num_bins
    x_binr = 0.5 * math.pi / (nb - 1)
    y_binr = 2.0 * math.pi / (nb - 1)
    idx_mag = torch.clamp(torch.floor(grad_mag / x_binr).to(torch.int32), 0, nb - 1)
    idx_dir = torch.clamp(torch.floor((grad_dir + math.pi) / y_binr).to(torch.int32), 0, nb - 1)
    return idx_mag, idx_dir


def _shade_bilinear(calib: TaximCalib, grad_mag: torch.Tensor, grad_dir: torch.Tensor) -> torch.Tensor:
    """LUT rows interpolated over (magnitude, direction); the direction axis
    wraps. Plain ops: autograd differentiates it in both gradients."""
    nb = calib.sensor_params.num_bins
    h, w = grad_mag.shape[-2:]
    lut = calib.poly_lut.reshape(nb * nb, 18)
    t_mag = torch.clamp(grad_mag / (0.5 * math.pi / (nb - 1)), 0.0, nb - 1 - 1e-6)
    t_dir = (grad_dir + math.pi) / (2.0 * math.pi / (nb - 1))
    m0f, d0f = torch.floor(t_mag), torch.floor(t_dir)
    fm, fd = (t_mag - m0f)[..., None], (t_dir - d0f)[..., None]
    m0, d0 = m0f.long(), d0f.long()
    m1 = torch.clamp(m0 + 1, max=nb - 1)
    d0w, d1w = torch.remainder(d0, nb), torch.remainder(d0 + 1, nb)
    c = (
        lut[m0 * nb + d0w] * (1 - fm) * (1 - fd)
        + lut[m0 * nb + d1w] * (1 - fm) * fd
        + lut[m1 * nb + d0w] * fm * (1 - fd)
        + lut[m1 * nb + d1w] * fm * fd
    )
    feats = calib.features.T.reshape(h, w, 6)
    return (feats[..., None] * c.reshape(c.shape[:-1] + (6, 3))).sum(dim=-2)


def compact_rows(calib: TaximCalib, idx_mag: torch.Tensor, idx_dir: torch.Tensor, capacity: int):
    """The compact path's contact pixels: the ``capacity`` highest-numbered
    pixels of magnitude bin >= 1 of each image (filled up with lower ones).
    Returns their (n, cap) positions and, as one flat row of n * cap pixels
    for ``lut_shade``, their (1, n cap) full-table rows and (6, n cap)
    features."""
    nb = calib.sensor_params.num_bins
    h, w = idx_mag.shape[-2:]
    hw = h * w
    n = idx_mag.numel() // hw
    cap = min(int(capacity), hw)
    idx_mag = idx_mag.reshape(n, hw)
    pix = torch.arange(hw, dtype=torch.int32, device=idx_mag.device)
    pos = torch.topk(torch.where(idx_mag >= 1, pix + hw, pix), cap, dim=1).values
    pos = torch.where(pos >= hw, pos - hw, pos).long()  # (n, cap)
    rows = torch.gather(idx_mag * nb + idx_dir.reshape(n, hw), 1, pos)
    return pos, rows.reshape(1, n * cap), calib.features.index_select(1, pos.reshape(-1))


def _shade_compact(calib: TaximCalib, idx_mag: torch.Tensor, idx_dir: torch.Tensor, capacity: int,
                   table: torch.Tensor) -> torch.Tensor:
    """Every pixel from its magnitude-bin-0 row (the deformation halo, where
    only the direction bin varies; f32, as in the JAX package), then the
    ``compact_rows`` pixels from their rows of ``table`` (the full table,
    f32 or bf16), scattered over the halo shade. Equal to the dense shade
    whenever the contact pixels fit the capacity; pixels beyond it keep
    their halo shade."""
    nb = calib.sensor_params.num_bins
    h, w = idx_mag.shape[-2:]
    n = idx_mag.numel() // (h * w)
    tabs = F.pad(calib.poly_lut.reshape(nb * nb, 18)[:nb].T, (0, 128 - nb))  # (18, 128)
    out = dir_row_shade(idx_dir.reshape(n, h * w).contiguous(), calib.features, tabs)  # (n, hw, 3)
    pos, rows, feats = compact_rows(calib, idx_mag, idx_dir, capacity)
    vals = lut_shade(rows, feats, table).reshape(pos.shape + (3,))
    out.scatter_(1, pos[..., None].expand(vals.shape), vals)
    return out.reshape(tuple(idx_dir.shape) + (3,))


def shade(
    calib: TaximCalib,
    grad_mag: torch.Tensor,
    grad_dir: torch.Tensor,
    interp: str = "nearest",
    lut_dtype: torch.dtype | None = None,
    compact_capacity: int | None = None,
) -> torch.Tensor:
    """Polynomial-LUT shading (..., h, w) -> (..., h, w, 3).

    ``interp="nearest"`` takes each pixel's floor-binned LUT row (piecewise
    constant in the gradients: no gradient flows); with ``compact_capacity``
    it goes through the halo pass and the compacted contact pixels.
    ``lut_dtype`` (None, ``torch.float32`` or ``torch.bfloat16``) is the
    type the nearest shade reads the full table in; the features and the
    sums stay f32. ``interp="bilinear"`` interpolates the LUT, which makes
    the optical model differentiable in the height map; like the JAX
    package's, it reads the f32 table whatever ``lut_dtype`` says."""
    h, w = grad_mag.shape[-2:]
    if (h, w) != calib.resolution:
        raise ValueError(f"gradients {h, w} != calib resolution {calib.resolution}; use calib.at_resolution()")
    if interp == "bilinear":
        return _shade_bilinear(calib, grad_mag, grad_dir)
    if interp != "nearest":
        raise ValueError(f"interp {interp!r} is neither 'nearest' nor 'bilinear'")
    if lut_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"lut_dtype {lut_dtype} is none of None, torch.float32 and torch.bfloat16")
    nb = calib.sensor_params.num_bins
    table = calib.poly_lut.reshape(nb * nb, 18)
    if lut_dtype is not None:
        table = table.to(lut_dtype)
    idx_mag, idx_dir = lut_bins(calib, grad_mag, grad_dir)
    if compact_capacity is not None:
        return _shade_compact(calib, idx_mag, idx_dir, compact_capacity, table)
    idx = (idx_mag * nb + idx_dir).reshape(-1, h * w).contiguous()
    out = lut_shade(idx, calib.features, table)
    return out.reshape(grad_mag.shape + (3,))


def _shadow_geometry(calib: TaximCalib, deformed_gel_px: torch.Tensor, contact_mask: torch.Tensor, grad_dir: torch.Tensor):
    """Shared shadow precomputation on (..., h, w) inputs: the boundary ring
    where shadows attach, each pixel's flat row into the shadow table, and
    its fan-angle row."""
    h, w = deformed_gel_px.shape[-2:]
    sim = calib.sim_params
    n_dirs, n_heights = calib.shadow_table.shape[:2]

    # grow the contact mask by the attachment kernel, in two rounds
    ks_w, ks_h = sim.shadow_attachment_kernel_size((h, w))
    total = (int(round(ks_h * 2)), int(round(ks_w * 2)))
    first = (total[0] // 2, total[1] // 2)
    second = (total[0] - first[0], total[1] - first[1])
    boundary = box_dilate(box_dilate(contact_mask, first), second) & ~contact_mask

    norm_idx = torch.floor((grad_dir + math.pi) / sim.discretize_precision).to(torch.int32)
    norm_idx = torch.clamp(norm_idx, 0, n_dirs - 1)
    contact_height = calib.gel_map - deformed_gel_px * calib.sensor_params.pixmm
    height_idx = torch.floor((contact_height - SHADOW_DEPTH_0) / sim.height_precision).to(torch.int32)
    height_idx = height_idx + SHADOW_HEIGHT_IDX_OFFSET
    # out-of-range heights take the all-inf sentinel row
    height_idx = torch.where((height_idx < 0) | (height_idx >= n_heights - 1), n_heights - 1, height_idx)
    return boundary, (norm_idx * n_heights + height_idx).long(), norm_idx.long()


def _march_targets(src_x, src_y, thetas, step_wh, dist, hw):
    """Ray-march target pixels: from sources at (``src_x``, ``src_y``)
    (float, broadcastable against ``thetas``) along ``thetas`` at distances
    ``dist``. Returns (flat target index, in-bounds mask). The float -> int
    conversion truncates toward zero, as the JAX package's does."""
    h, w = hw
    tx = (src_x + step_wh[0] * dist * torch.cos(thetas)).to(torch.int32)
    ty = (src_y + step_wh[1] * dist * torch.sin(thetas)).to(torch.int32)
    in_bounds = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    tgt = torch.clamp(ty, 0, h - 1) * w + torch.clamp(tx, 0, w - 1)
    return tgt.long(), in_bounds


def _shadow_pass_dense(
    calib: TaximCalib,
    sim_img: torch.Tensor,  # (h, w, 3) raw shaded (no background)
    deformed_gel_px: torch.Tensor,  # (h, w)
    contact_mask: torch.Tensor,  # (h, w) bool
    grad_dir: torch.Tensor,  # (h, w)
) -> torch.Tensor:
    """Cast shadows from contact-boundary pixels, one image, densely: the
    oracle of ``_shadow_pass_compact``. It loops over the march steps with a
    full-image scatter-min per step, every pixel a potential source."""
    h, w = deformed_gel_px.shape
    boundary, flat_idx, norm_idx = _shadow_geometry(calib, deformed_gel_px, contact_mask, grad_dir)
    num_steps = calib.shadow_table.shape[2]
    table_flat = calib.shadow_table.reshape(-1, num_steps, 3)
    thetas = calib.shadow_fan_angles[norm_idx]  # (h, w, R)
    num_rays = thetas.shape[-1]
    dev = deformed_gel_px.device
    yy = torch.arange(h, device=dev)[:, None, None]
    xx = torch.arange(w, device=dev)[None, :, None]
    step_wh = calib.sim_params.shadow_step((h, w))
    heights = deformed_gel_px.reshape(-1)

    out = sim_img.reshape(h * w, 3).clone()
    for s in range(num_steps):
        tgt, in_bounds = _march_targets(xx, yy, thetas, step_wh, float(s + 1), (h, w))  # (h, w, R)
        # shadow only falls on pixels higher (closer to the camera) than its source
        higher = deformed_gel_px[..., None] < heights[tgt]
        valid = in_bounds & boundary[..., None] & higher
        vals = table_flat[flat_idx, s][:, :, None, :].expand(h, w, num_rays, 3)
        vals = torch.where(valid[..., None], vals, float("inf")).reshape(-1, 3)
        out.scatter_reduce_(0, tgt.reshape(-1, 1).expand(-1, 3), vals, "amin", include_self=True)
    return out.reshape(h, w, 3)


def _shadow_pass_compact(
    calib: TaximCalib,
    sim_img: torch.Tensor,  # (n, h, w, 3) raw shaded (no background)
    deformed_gel_px: torch.Tensor,  # (n, h, w)
    contact_mask: torch.Tensor,  # (n, h, w) bool
    grad_dir: torch.Tensor,  # (n, h, w)
    capacity: int = 1024,
) -> torch.Tensor:
    """Batched shadow pass: shadows come only from contact-boundary pixels,
    so they are compacted to ``capacity`` sources per image with one ``topk``
    (boundary pixels first, in any order: the composite is a minimum), the
    (source, ray, step) march targets and attenuation values are built by
    broadcasting, the admission test (target in bounds and higher than the
    source) takes one gather of target heights, and one scatter-min composites
    all pairs. Equal to the dense oracle whenever the boundary ring has at
    most ``capacity`` pixels; beyond that the lowest-numbered boundary pixels
    are dropped."""
    n, h, w = deformed_gel_px.shape
    hw = h * w
    boundary, flat_idx, norm_idx = _shadow_geometry(calib, deformed_gel_px, contact_mask, grad_dir)

    cap = min(int(capacity), hw)
    pix = torch.arange(hw, dtype=torch.int32, device=deformed_gel_px.device)
    top = torch.topk(torch.where(boundary.reshape(n, hw), pix + hw, pix), cap, dim=1).values
    is_src = top >= hw  # the others are filler, masked out below
    pos = torch.where(is_src, top - hw, top).long()  # (n, cap)
    src_y = torch.div(pos, w, rounding_mode="floor").to(torch.float32)[..., None, None]
    src_x = (pos % w).to(torch.float32)[..., None, None]

    heights = deformed_gel_px.reshape(n, hw)
    h_src = torch.gather(heights, 1, pos)
    num_steps = calib.shadow_table.shape[2]
    table_flat = calib.shadow_table.reshape(-1, num_steps, 3)
    vals = table_flat[torch.gather(flat_idx.reshape(n, hw), 1, pos)]  # (n, cap, L, 3)
    thetas = calib.shadow_fan_angles[torch.gather(norm_idx.reshape(n, hw), 1, pos)]  # (n, cap, R)
    num_rays = thetas.shape[-1]

    dist = torch.arange(1, num_steps + 1, dtype=torch.float32, device=pos.device)  # (L,)
    step_wh = calib.sim_params.shadow_step((h, w))
    tgt, in_bounds = _march_targets(src_x, src_y, thetas[..., None], step_wh, dist, (h, w))  # (n, cap, R, L)
    h_dst = torch.gather(heights, 1, tgt.reshape(n, -1)).reshape(tgt.shape)
    valid = in_bounds & is_src[..., None, None] & (h_src[..., None, None] < h_dst)

    v = torch.where(valid[..., None], vals[:, :, None].expand(n, cap, num_rays, num_steps, 3), float("inf"))
    out = sim_img.reshape(n, hw, 3).clone()
    out.scatter_reduce_(1, tgt.reshape(n, -1, 1).expand(-1, -1, 3), v.reshape(n, -1, 3), "amin", include_self=True)
    return out.reshape(n, h, w, 3)


def shadowed_image(calib: TaximCalib, raw, deformed_px, contact_mask, grad_dir) -> torch.Tensor:
    """The shadow pass on a raw shade (n, h, w, 3), blurred, over the
    background, blurred again; not yet clipped."""
    h, w = deformed_px.shape[-2:]
    shadowed = _shadow_pass_compact(calib, raw, deformed_px, contact_mask, grad_dir)
    shadowed = gaussian_blur(shadowed, calib.sim_params.shadow_blur_sigma((h, w)))
    return gaussian_blur(shadowed + calib.background, calib.sim_params.deform_final_sigma((h, w)))


def render(
    calib: TaximCalib,
    height_map: torch.Tensor,
    press_depth: torch.Tensor | None = None,
    with_shadow: bool = False,
    orig_hm_fmt: bool = False,
    interp: str = "nearest",
    lut_dtype: torch.dtype | None = None,
    compact_capacity: int | None = None,
) -> torch.Tensor:
    """Tactile RGB (..., h, w, 3) in [0, 1] from height maps (..., h, w) mm
    (0 = gel top, negative = pressed in). ``orig_hm_fmt`` takes the original
    Taxim format instead (inverted and shifted by the gel map's maximum,
    ``calib.gel_map_shift``). ``press_depth`` (...,) mm shifts each map so
    its minimum sits that far below the gel top; ``with_shadow`` adds the
    shadow pass; ``interp``, ``lut_dtype`` and ``compact_capacity`` as in
    ``shade``."""
    lead = height_map.shape[:-2]
    h, w = height_map.shape[-2:]
    if (h, w) != calib.resolution:
        raise ValueError(f"height map {h, w} != calib resolution {calib.resolution}; use calib.at_resolution()")
    hm = height_map.reshape(-1, h, w).to(torch.float32)
    if orig_hm_fmt:
        hm = calib.gel_map_shift - hm
    if press_depth is not None:
        hm = shift_height_map(hm, torch.as_tensor(press_depth, dtype=torch.float32, device=hm.device).expand(lead).reshape(-1))

    deformed, contact_mask = compute_gel_deformation(calib, hm)
    deformed_px = deformed / calib.sensor_params.pixmm
    grad_mag, grad_dir = generate_normals(calib, -deformed_px)
    raw = shade(calib, grad_mag, grad_dir, interp=interp, lut_dtype=lut_dtype, compact_capacity=compact_capacity)
    if with_shadow:
        img = shadowed_image(calib, raw, deformed_px, contact_mask, grad_dir)
    else:
        img = raw + calib.background
    return torch.clamp(img, 0.0, 1.0).reshape(lead + (h, w, 3))
