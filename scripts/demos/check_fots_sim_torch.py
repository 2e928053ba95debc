"""FOTS marker-motion sanity demo of the PyTorch/CUDA port: press + shear +
twist marker fields.

The port's counterpart of ``check_fots_sim.py``: presses a sphere 1.2 mm into
the gel, moves the markers under four trajectories (press, shear, twist,
shear+twist), prints each case's largest marker displacement and writes the
marker dots over the tactile image, on ``--device`` (the card by default;
``--device cpu`` runs on the CPU). At the default 240x320 the deformation is
one pyramid (K1) launch on one image, and the render one more K1 and one
LUT-shading (K2) launch.

Usage: python scripts/demos/check_fots_sim_torch.py [--out /tmp/fots_demo.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

RES = (240, 320)
PRESS_MM = 1.2
# case -> (trajectory start [x_mm, y_mm, theta], current pose, has a trajectory)
CASES = {
    "press": ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], False),
    "shear": ([0.0, 0.0, 0.0], [1.2, 0.6, 0.0], True),
    "twist": ([0.0, 0.0, 0.0], [0.0, 0.0, 0.6], True),
    "shear+twist": ([0.0, 0.0, 0.0], [0.8, -0.5, 0.45], True),
}


def marker_cfg(res=RES):
    """The demo's 9 x 11 marker grid, its margins and pixel scale scaled
    from 240x320 to ``res`` (at 240x320, ``check_fots_sim.py``'s)."""
    from tacex_tpu_torch.sensors.gelsight.fots import marker_motion as fots

    h, w = res
    base = fots.FOTSMarkerCfg()
    return fots.FOTSMarkerCfg(num_markers_row=9, num_markers_col=11, x0=15 * w / 320, y0=26 * h / 240,
                              tactile_img_width=w, tactile_img_height=h, mm_to_pixel=base.mm_to_pixel * w / 320)


def pressed_sphere(res, device):
    """(1, H, W) height map (mm) of the medium sphere pressed ``PRESS_MM`` in."""
    import torch

    from tacex_tpu_torch.assets.shapes import shape_height_map

    hm = shape_height_map("sphere_medium", tuple(res))
    return torch.as_tensor(hm[None], device=device) - float(hm.min()) - PRESS_MM


def fots_cases(calib, res, device) -> dict:
    """{case: (1, M, 2) marker positions (px)} of the four trajectories on
    the pressed sphere; ``calib`` as ``load_calib`` gives it."""
    import torch

    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.sensors.gelsight.fots import marker_motion as fots
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    dev = resolve(device)
    cal = calib.at_resolution(tuple(res)).to(dev)
    cfg = marker_cfg(res)
    init_m = fots.init_marker_grid(cfg, device=dev)
    deformed, mask = optical.compute_gel_deformation(cal, pressed_sphere(res, dev))
    depth = deformed.amax(dim=(-2, -1), keepdim=True) - deformed
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        name: fots.marker_motion(cfg, depth, mask, torch.tensor([t0], **f32), torch.tensor([t1], **f32),
                                 torch.tensor([valid], device=dev), init_m)
        for name, (t0, t1, valid) in CASES.items()
    }


def main(argv: list[str] | None = None) -> dict:
    """Run the four cases and save the panels; returns ``fots_cases``'s dict."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="/tmp/fots_demo.png")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.sensors.gelsight import taxim as tx
    from tacex_tpu_torch.sensors.gelsight.fots import marker_motion as fots
    from tacex_tpu_torch.utils.png import to_uint8, write_png

    dev = resolve(args.device)
    calib = tx.load_calib()
    cases = fots_cases(calib, RES, dev)
    rgb = tx.render(calib.at_resolution(RES).to(dev), pressed_sphere(RES, dev))[0].cpu().numpy()
    cfg = marker_cfg(RES)
    init_m = fots.init_marker_grid(cfg, device=dev)
    panels = []
    for name, markers in cases.items():
        dots = fots.draw_marker_image(cfg, markers)[0].cpu().numpy()
        panels.append(rgb * dots[..., None])
        print(f"{name}: max marker displacement {float((markers - init_m).abs().max()):.2f} px")
    write_png(args.out, to_uint8(np.concatenate(panels, axis=1)))
    print(f"saved {args.out}")
    return cases


if __name__ == "__main__":
    main()
