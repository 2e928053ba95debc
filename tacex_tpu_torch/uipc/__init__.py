"""The UIPC scene API on the port: ``UipcSim``, ``UipcObject``, the
attachments and ``UipcInteractiveScene`` (see ``sim.py``)."""

from .sim import UipcSim, UipcSimCfg  # noqa: F401
from .objects import UipcObject, UipcObjectCfg, AffineBodyConstitutionCfg, StableNeoHookeanCfg  # noqa: F401
from .attachments import UipcIsaacAttachments, UipcIsaacAttachmentsCfg  # noqa: F401
from .objects import NeoHookeanShellCfg  # noqa: F401
from .scene import (  # noqa: F401
    RigidObjectCfg,
    UipcInteractiveScene,
    UipcInteractiveSceneCfg,
)
