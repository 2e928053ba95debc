"""Shape-touch demo of the PyTorch/CUDA port: press each test shape into
the gel at increasing depth.

The port's counterpart of ``run_shape_touch.py``: each shape (from the
analytic library, or with ``--mesh`` from its triangle mesh through the
rasterizer) is pressed over a depth ramp on ``--device`` (the card by
default; ``--device cpu`` runs on the CPU), and the tactile RGB with the
FOTS marker dots is written as one PNG strip per shape.

Usage: python scripts/demos/run_shape_touch_torch.py [--shapes sphere_medium cross]
       [--depths 0.3 0.9 1.5] [--out_dir /tmp/shape_touch] [--mesh] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

DEFAULT_SHAPES = ["sphere_medium", "cube_edge", "cross"]
MESH_DEFAULT_SHAPES = ["sphere", "cube", "gear"]


def mesh_height_map(name: str, res: tuple[int, int], device, pixmm: float = 0.059) -> np.ndarray:
    """(h, w) height map in mm of the shape's triangle mesh, rendered by a
    camera above the part's highest point looking straight down (the
    geometry the reference's camera sees in run_shape_touch)."""
    import torch

    from tacex_tpu_torch.assets import meshes
    from tacex_tpu_torch.render.depth_camera import render_depth

    tris = torch.as_tensor(meshes.shape_mesh(name), device=device)
    h, w = res
    extent = (w * pixmm * 1e-3, h * pixmm * 1e-3)
    z_top = float(tris[..., 2].max())
    f32 = dict(dtype=torch.float32, device=device)
    cam_pos = torch.tensor([0.0, 0.0, z_top + 1e-4], **f32)
    cam_down = torch.tensor([0.0, 1.0, 0.0, 0.0], **f32)  # 180 deg about x: +Z -> -Z
    far = 1e-4 + 6e-3  # camera offset + 6 mm of visible relief, like shapes.FAR
    depth = render_depth(
        cam_pos, cam_down, torch.zeros((1, 4), **f32), torch.zeros((1, 10), **f32), torch.zeros((1, 8), **f32),
        torch.zeros((1, 4), **f32), (w, h), extent, far, scene_triangles=tris,
    )
    return ((depth - depth.min()) * 1000.0).cpu().numpy().astype(np.float32)  # meters -> mm, 0 = contact


def main(argv: list[str] | None = None) -> dict:
    """Press the shapes; returns {shape: strip path}."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--shapes", nargs="*", default=DEFAULT_SHAPES)
    p.add_argument("--depths", nargs="*", type=float, default=[0.3, 0.6, 0.9, 1.2, 1.5])
    p.add_argument("--out_dir", default="/tmp/shape_touch")
    p.add_argument("--res", type=int, nargs=2, default=(240, 320))
    p.add_argument("--mesh", action="store_true",
                   help="render contact geometry from triangle meshes (assets.meshes) "
                        "instead of the analytic height-map library")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from tacex_tpu_torch.assets import meshes
    from tacex_tpu_torch.assets.shapes import SHAPE_LIBRARY, shape_height_map
    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.sensors.gelsight import taxim as tx
    from tacex_tpu_torch.sensors.gelsight.fots import marker_motion as fots
    from tacex_tpu_torch.sensors.gelsight.taxim import optical
    from tacex_tpu_torch.utils.png import to_uint8, write_png

    dev = resolve(args.device)
    res = tuple(args.res)
    calib = tx.load_calib().at_resolution(res).to(dev)
    mcfg = fots.FOTSMarkerCfg(num_markers_row=9, num_markers_col=11, x0=15, y0=26,
                              tactile_img_width=res[1], tactile_img_height=res[0])
    init_m = fots.init_marker_grid(mcfg, device=dev)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shapes = MESH_DEFAULT_SHAPES if args.mesh and args.shapes == DEFAULT_SHAPES else args.shapes

    written = {}
    for name in shapes:
        if args.mesh:
            if name not in meshes.MESH_SHAPE_NAMES:
                print(f"unknown mesh shape {name}; available: {meshes.MESH_SHAPE_NAMES}")
                continue
            hm0 = mesh_height_map(name, res, dev)
        elif name not in SHAPE_LIBRARY:
            print(f"unknown shape {name}; available: {sorted(SHAPE_LIBRARY)}")
            continue
        else:
            hm0 = shape_height_map(name, res)
        hm = torch.as_tensor(hm0[None], device=dev)
        no_traj = dict(traj_start=torch.zeros((1, 3), device=dev), traj_curr=torch.zeros((1, 3), device=dev),
                       traj_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
        panels = []
        for depth in args.depths:
            press = torch.full((1,), depth, device=dev)
            rgb = tx.render(calib, hm, press_depth=press)
            deformed, mask = optical.compute_gel_deformation(calib, optical.shift_height_map(hm, press))
            d_mk = deformed.amax(dim=(-2, -1), keepdim=True) - deformed
            markers = fots.marker_motion(mcfg, d_mk, mask, init_markers=init_m, **no_traj)
            dots = fots.draw_marker_image(mcfg, markers)
            panels.append((rgb[0] * dots[0][..., None]).cpu().numpy())
        path = write_png(out_dir / f"{name}.png", to_uint8(np.concatenate(panels, axis=1)))
        written[name] = path
        print(f"{name}: pressed {args.depths} mm -> {path}")
    return written


if __name__ == "__main__":
    main()
