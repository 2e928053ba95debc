"""LUT row-gather shading: CUDA kernel and its plain version.

``lut_shade`` runs the hand-written kernel of ``csrc/lut_shade.cu`` (the
port of ``tacex_tpu/ops/pallas_lut.py``, widened to tables of any row
count) on CUDA tensors, and the plain PyTorch version on CPU tensors. It
never falls back from one to the other. ``dir_row_shade`` keeps the JAX
package's signature and layout for the 125-row subtable. The table may be
f32 or bf16 (the JAX package's ``shade(lut_dtype=jnp.bfloat16)``): a bf16
table goes to the kernel's bf16 entry, which widens each gathered row to f32
for the same f32 feature dot, and counts its launches in
``lut_shade.bf16_launches``.
"""

from __future__ import annotations

import torch

from . import _build

MAX_ENVS = 65535 * 8  # grid.y blocks of 8 envs each


def lut_shade_plain(idx: torch.Tensor, feats: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[n, p, c] = sum_k feats[k, p] * table[idx[n, p], 3 k + c]``."""
    n, p = idx.shape
    coeffs = table[idx.long()].to(torch.float32).reshape(n, p, 6, 3)
    return (feats.T[None, :, :, None] * coeffs).sum(dim=-2)


def lut_shade(idx: torch.Tensor, feats: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(n, P) int32 row indices, (6, P) f32 features, (R, 18) f32 or bf16
    table -> (n, P, 3) f32. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises (a ``RuntimeError`` for ``feats`` or
    ``table`` that require grad: the kernel has no backward). A row index outside ``[0, R)`` gives NaN
    on the card and raises on the CPU."""
    if idx.device.type == "cpu":
        return lut_shade_plain(idx, feats, table)
    if idx.device.type != "cuda":
        raise ValueError(f"lut_shade: unsupported device {idx.device}")
    if torch.is_grad_enabled() and (feats.requires_grad or table.requires_grad):
        raise RuntimeError(
            "lut_shade: the CUDA kernel has no backward kernel, so no gradient can reach `feats` or `table`; "
            "detach them, or differentiate on the CPU"
        )
    if idx.dtype != torch.int32 or idx.ndim != 2:
        raise ValueError(f"idx must be (n, P) int32, got {tuple(idx.shape)} {idx.dtype}")
    n, p = idx.shape
    if feats.dtype != torch.float32 or tuple(feats.shape) != (6, p):
        raise ValueError(f"feats must be (6, {p}) float32, got {tuple(feats.shape)} {feats.dtype}")
    if table.dtype not in (torch.float32, torch.bfloat16) or table.ndim != 2 or table.shape[1] != 18:
        raise ValueError(f"table must be (R, 18) float32 or bfloat16, got {tuple(table.shape)} {table.dtype}")
    if not (feats.device == table.device == idx.device):
        raise ValueError("idx, feats and table must be on one device")
    if not (idx.is_contiguous() and feats.is_contiguous() and table.is_contiguous()):
        raise ValueError("idx, feats and table must be contiguous")
    bf16 = table.dtype == torch.bfloat16
    if table.data_ptr() % (4 if bf16 else 16) != 0:
        raise ValueError("table must be 16-byte aligned (its f32 rows are read as float4), or 4-byte aligned in bf16")
    if n > MAX_ENVS:
        raise ValueError(f"the shading kernel takes at most {MAX_ENVS} envs, got {n}")
    lib = _build.load_library()
    out = torch.empty((n, p, 3), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        entry = lib.tacex_lut_shade_bf16 if bf16 else lib.tacex_lut_shade
        err = entry(idx.data_ptr(), feats.data_ptr(), table.data_ptr(), out.data_ptr(), n, p, table.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"lut_shade kernel launch failed: CUDA error {err}")
    if bf16:
        lut_shade.bf16_launches += 1
    else:
        lut_shade.launches += 1
    return out


lut_shade.launches = 0
lut_shade.bf16_launches = 0


def dir_row_shade(idir: torch.Tensor, feats: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """(n, P, 3) shading of every pixel with its magnitude-bin-0 LUT row.

    ``idir``: (n, P) int32 direction bins; ``feats``: (6, P); ``tabs``:
    (18, 128) laid out ``[3 k + c, dir]`` as in the JAX package.
    """
    return lut_shade(idir, feats, tabs.T.contiguous())
