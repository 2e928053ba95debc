"""Headless training/episode observability.

Port of ``tacex_tpu/utils/visualizer.py`` (the reference's
``DirectLiveVisualizer`` role): a recorder that accumulates scalar series and
image frames and writes them as PNGs on demand. It draws with numpy and
writes through ``png.write_png``, so the same code runs where no plotting or
imaging library is installed: each series is one panel, a polyline scaled to
the panel's box, and the panels' titles, in order, go to a text file beside
the plot.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from .png import to_uint8, write_png

PANEL_HW = (160, 240)  # one panel's pixels
MARGIN = 8
COLS = 3
BACKGROUND = 255
FRAME = (190, 190, 190)
LINE = (31, 119, 180)


def _draw_polyline(panel: np.ndarray, ys: np.ndarray) -> None:
    """Draw the series ``ys`` into ``panel`` (H, W, 3) uint8: x spans the
    panel's inner width by sample index, y its inner height from the
    series' minimum (bottom) to its maximum (top)."""
    h, w = panel.shape[:2]
    panel[[MARGIN - 1, h - MARGIN], MARGIN - 1:w - MARGIN + 1] = FRAME
    panel[MARGIN - 1:h - MARGIN + 1, [MARGIN - 1, w - MARGIN]] = FRAME
    ys = np.asarray(ys, np.float64)
    ys = ys[np.isfinite(ys)]
    if ys.size == 0:
        return
    lo, hi = ys.min(), ys.max()
    inner_h, inner_w = h - 2 * MARGIN, w - 2 * MARGIN
    py = MARGIN + (inner_h - 1) * (1.0 - ((ys - lo) / (hi - lo) if hi > lo else np.full_like(ys, 0.5)))
    px = MARGIN + (inner_w - 1) * (np.arange(ys.size) / max(ys.size - 1, 1))
    if ys.size == 1:
        px, py = np.repeat(px, 2), np.repeat(py, 2)
    for (x0, y0), (x1, y1) in zip(zip(px[:-1], py[:-1]), zip(px[1:], py[1:])):
        k = int(max(abs(x1 - x0), abs(y1 - y0))) + 2
        t = np.linspace(0.0, 1.0, k)
        panel[np.rint(y0 + t * (y1 - y0)).astype(int), np.rint(x0 + t * (x1 - x0)).astype(int)] = LINE


class LiveVisualizer:
    """Accumulate scalar series + image frames; dump PNG dashboards."""

    def __init__(self, out_dir: str | Path = "viz"):
        self.out_dir = Path(out_dir)
        self.series: dict[str, list[float]] = defaultdict(list)
        self.frames: dict[str, list[np.ndarray]] = defaultdict(list)

    # ------------------------------------------------------------------ feed
    def add_scalars(self, step: int, scalars: dict):
        self.series["step"].append(step)
        for k, v in scalars.items():
            self.series[k].append(float(v))

    def add_frame(self, name: str, frame: np.ndarray, keep_last: int = 16):
        buf = self.frames[name]
        buf.append(np.asarray(frame))
        if len(buf) > keep_last:
            del buf[0]

    # ------------------------------------------------------------------ dump
    def save_plots(self, filename: str = "metrics.png"):
        """One panel per series (``COLS`` to a row, in the order the series
        were first fed); writes ``metrics_panels.txt`` beside the plot with
        each panel's row, column, series name and value range."""
        keys = [k for k in self.series if k != "step"]
        if not keys:
            return None
        cols = min(COLS, len(keys))
        rows = (len(keys) + cols - 1) // cols
        ph, pw = PANEL_HW
        canvas = np.full((rows * ph, cols * pw, 3), BACKGROUND, np.uint8)
        lines = []
        for i, k in enumerate(keys):
            r, c = divmod(i, cols)
            _draw_polyline(canvas[r * ph:(r + 1) * ph, c * pw:(c + 1) * pw], self.series[k])
            vals = np.asarray(self.series[k], np.float64)
            lines.append(f"{r} {c} {k} min={vals.min():.6g} max={vals.max():.6g} n={vals.size}")
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / filename
        write_png(path, canvas)
        (self.out_dir / f"{Path(filename).stem}_panels.txt").write_text("\n".join(lines) + "\n")
        return path

    def save_frame_strip(self, name: str, filename: str | None = None):
        frames = self.frames.get(name)
        if not frames:
            return None
        fr = [np.clip(np.asarray(f, np.float32), 0, 1) for f in frames]
        fr = [f[..., None].repeat(3, -1) if f.ndim == 2 else f for f in fr]
        strip = np.concatenate(fr, axis=1)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / (filename or f"{name}_strip.png")
        return write_png(path, to_uint8(strip))
