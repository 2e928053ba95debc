"""Carry a ball-rolling state across from numpy.

``state_from_numpy`` takes the leaves of a ``BallRollingState`` of the JAX
package as a nested dict of numpy arrays (field name -> array, with nested
dicts for ``arm``, ``sensor`` and ``dr``), or of a ``UipcBallRollingState``
(``base`` and the gel's ``gel``: ``x``, ``v``), and returns the port's state on
``device`` (the card unless the caller asks for the CPU), so that both
envs can start from one state; ``actions`` and ``prev_actions`` keep their
width (6 columns, or the privileged tasks' 5). The JAX state's random key
has no counterpart and is ignored.
"""

from __future__ import annotations

from ...core.device import DEFAULT_DEVICE
from .. import convert
from .env import BallRollingState
from .env_uipc import UipcBallRollingState


def state_from_numpy(leaves: dict, device=DEFAULT_DEVICE) -> BallRollingState | UipcBallRollingState:
    cls = UipcBallRollingState if "gel" in leaves else BallRollingState
    return convert.state_from_numpy(cls, leaves, device)
