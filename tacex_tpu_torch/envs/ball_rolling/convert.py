"""Carry a ball-rolling state across from numpy.

``state_from_numpy`` takes the leaves of a ``BallRollingState`` of the JAX
package as a nested dict of numpy arrays (field name -> array, with nested
dicts for ``arm``, ``sensor`` and ``dr``) and returns the port's state on
``device`` (the card unless the caller asks for the CPU), so that both
envs can start from one state; ``actions`` and ``prev_actions`` keep their
width (6 columns, or the privileged tasks' 5). The JAX state's random key
has no counterpart and is ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.device import DEFAULT_DEVICE, resolve
from ...physics.rigid.franka import ArmState
from ...sensors.gelsight.sensor import GelSightSensorState
from .env import BallRollingState, DomainRandomization


def _build(cls, leaves: dict, device, nested: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = leaves[f.name]
        if f.name in nested:
            kwargs[f.name] = _build(nested[f.name], v, device, {})
        else:
            kwargs[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return cls(**kwargs)


def state_from_numpy(leaves: dict, device=DEFAULT_DEVICE) -> BallRollingState:
    return _build(
        BallRollingState,
        leaves,
        resolve(device),
        {"arm": ArmState, "sensor": GelSightSensorState, "dr": DomainRandomization},
    )
