"""Taxim optical sanity demo of the PyTorch/CUDA port: render the tactile
test-shape library.

The port's counterpart of ``check_taxim_sim.py``: presses every shape of the
analytic library (26 shapes) into the gel in one ``render`` call, on
``--device`` (the card by default; ``--device cpu`` runs on the CPU), and
writes a montage of the tactile RGB images, six to a row. At the default
240x320 that is one pyramid (K1) and one LUT-shading (K2) launch over the
26 images.

Usage: python scripts/demos/check_taxim_sim_torch.py [--out /tmp/taxim_shapes.png]
       [--press 1.0] [--shadow] [--res 240 320] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root, so the script runs from anywhere

COLS = 6


def render_library(calib, names, res, press: float, with_shadow: bool, device):
    """(N, H, W, 3) tactile RGB on ``device`` of the library shapes ``names``
    pressed ``press`` mm into the gel at ``res`` = (H, W), in one ``render``;
    ``calib`` as ``load_calib`` gives it."""
    import torch

    from tacex_tpu_torch.assets.shapes import shape_height_map
    from tacex_tpu_torch.core.device import resolve
    from tacex_tpu_torch.sensors.gelsight import taxim as tx

    dev = resolve(device)
    cal = calib.at_resolution(tuple(res)).to(dev)
    hms = torch.as_tensor(np.stack([shape_height_map(n, tuple(res)) for n in names]), device=dev)
    return tx.render(cal, hms, press_depth=torch.full((len(names),), float(press), device=dev), with_shadow=with_shadow)


def montage(imgs: np.ndarray, cols: int = COLS) -> np.ndarray:
    """(N, H, W, 3) images in rows of ``cols`` on a white ground."""
    n, h, w = imgs.shape[:3]
    rows = (n + cols - 1) // cols
    out = np.ones((rows * h, cols * w, 3), np.float32)
    for i, img in enumerate(imgs):
        r, c = divmod(i, cols)
        out[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    return out


def main(argv: list[str] | None = None) -> np.ndarray:
    """Render and save the montage; returns the (N, H, W, 3) images."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="/tmp/taxim_shapes.png")
    p.add_argument("--press", type=float, default=1.0)
    p.add_argument("--shadow", action="store_true")
    p.add_argument("--res", type=int, nargs=2, default=(240, 320))
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from tacex_tpu_torch.assets.shapes import SHAPE_LIBRARY
    from tacex_tpu_torch.sensors.gelsight import taxim as tx
    from tacex_tpu_torch.utils.png import to_uint8, write_png

    names = list(SHAPE_LIBRARY)
    imgs = render_library(tx.load_calib(), names, args.res, args.press, args.shadow, args.device).cpu().numpy()
    write_png(args.out, to_uint8(montage(imgs)))
    print(f"{len(names)} shapes rendered -> {args.out}")
    return imgs


if __name__ == "__main__":
    main()
