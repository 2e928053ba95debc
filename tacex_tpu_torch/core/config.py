"""Config system: a ``@configclass`` decorator with the semantics TacEx relies on.

The reference framework builds every component around isaaclab's ``@configclass``
(nested dataclasses, mutable defaults allowed, ``.replace()``/``.copy()``/
``.to_dict()``, class-as-config plugin dispatch via ``class_type`` fields —
see reference source/tacex/tacex/gelsight_sensor_cfg.py:13-64 and
source/tacex_uipc/tacex_uipc/sim/uipc_sim.py:32-131).

This is a standalone implementation with the same surface: plain dataclasses
whose mutable defaults are deep-copied per instance, nested-config aware
``to_dict``/``from_dict``, and functional ``replace``.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
from typing import Any, TypeVar

_T = TypeVar("_T")

MISSING = dataclasses.MISSING


def configclass(cls: type[_T]) -> type[_T]:
    """Decorator turning ``cls`` into a config dataclass.

    Differences from a vanilla ``@dataclass``:
      * mutable class-attribute defaults (lists, dicts, nested config
        instances) are allowed — they become per-instance deep copies;
      * instances get ``replace(**overrides)``, ``copy()`` and ``to_dict()``;
      * equality and repr come from dataclass machinery.
    """
    # Wrap mutable defaults in default_factory before handing to dataclass().
    annotations = getattr(cls, "__annotations__", {})
    for name in annotations:
        if name.startswith("__"):
            continue
        default = cls.__dict__.get(name, MISSING)
        if default is MISSING or isinstance(default, dataclasses.Field):
            continue
        if _is_mutable(default):
            setattr(
                cls,
                name,
                dataclasses.field(default_factory=_DeepCopyFactory(default)),
            )
    dcls = dataclasses.dataclass(cls)

    dcls.replace = _replace
    dcls.copy = _copy
    dcls.to_dict = _to_dict
    dcls.__configclass__ = True
    return dcls


class _DeepCopyFactory:
    def __init__(self, value: Any):
        self.value = value

    def __call__(self) -> Any:
        return copy.deepcopy(self.value)


def _is_mutable(value: Any) -> bool:
    if isinstance(value, (list, dict, set, bytearray)):
        return True
    return is_configclass_instance(value)


def is_configclass_instance(value: Any) -> bool:
    return getattr(type(value), "__configclass__", False) and not isinstance(value, type)


def _replace(self, **overrides: Any):
    return dataclasses.replace(self, **overrides)


def _copy(self):
    return copy.deepcopy(self)


def _to_dict(self) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for f in dataclasses.fields(self):
        v = getattr(self, f.name)
        if is_configclass_instance(v):
            v = v.to_dict()
        elif isinstance(v, type):
            v = f"{v.__module__}.{v.__qualname__}"
        out[f.name] = v
    return out


def update_recursive(default: dict, update: dict | None) -> dict:
    """Recursively override ``default`` with ``update``.

    Unknown keys raise — mirrors the strict calibration-param override of the
    reference (source/tacex/.../gpu_taxim/sim/taxim_impl.py:183-202).
    """
    if update is None:
        return default
    unknown = [k for k in update if k not in default]
    if unknown:
        raise ValueError(f"Unknown key(s): {', '.join(map(str, unknown))}")
    return {
        k: (
            update_recursive(default[k], update[k])
            if isinstance(default[k], dict) and k in update
            else update.get(k, default[k])
        )
        for k in default
    }


def parse_overrides(pairs: list[str]) -> dict[str, Any]:
    """``KEY=VALUE`` command-line overrides as a dict; each value is read as
    a Python literal where it is one, else kept as a string."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # keep as string
        out[k] = v
    return out
