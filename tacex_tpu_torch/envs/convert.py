"""Carry an env state across from numpy.

``state_from_numpy(cls, leaves, device)`` builds a state dataclass of the
port (``FactoryState``, ``PoleBalancingState``, ``GraspLiftState``,
``FactoryUipcState``, ...) from a nested dict of
numpy arrays (field name -> array, a dict for each nested dataclass), as
the JAX package's state of the same task gives them, on ``device`` (the
card unless the caller asks for the CPU), so that both envs can start from
one state. Fields of the JAX state that the port's lacks (the random key)
are ignored.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve


def _build(cls, leaves: dict, device: torch.device):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v, kind = leaves[f.name], hints[f.name]
        if dataclasses.is_dataclass(kind):
            kwargs[f.name] = _build(kind, v, device)
        else:
            kwargs[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return cls(**kwargs)


def state_from_numpy(cls, leaves: dict, device=DEFAULT_DEVICE):
    return _build(cls, leaves, resolve(device))
