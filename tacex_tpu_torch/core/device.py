"""Where the port's entry points run.

Every entry point (``envs.make``, the envs, ``GelSightSensor``,
``state_from_numpy``, the networks) takes ``device="cuda"`` by default and
passes it through ``resolve``. A CUDA device on a machine without one raises:
the port never drops to the CPU for lack of a card. The CPU is used only
when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device when PyTorch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
