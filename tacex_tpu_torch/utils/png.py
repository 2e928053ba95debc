"""PNG writing with the standard library (``zlib`` and ``struct``).

The port's scripts write every image through ``write_png``: the machine with
the card has no imaging library.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str | Path, image: np.ndarray) -> Path:
    """Write a uint8 (H, W) gray or (H, W, 3) RGB image as an 8-bit PNG;
    returns the path."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter type 0 a row
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    path = Path(path)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                     + _chunk(b"IEND", b""))
    return path


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A float image in [0, 1] as uint8, clipped, truncated as the JAX
    scripts' ``(img * 255).astype(np.uint8)``."""
    return (np.clip(np.asarray(image, np.float32), 0.0, 1.0) * 255).astype(np.uint8)
