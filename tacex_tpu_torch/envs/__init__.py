from .base import DirectRLEnv, DirectRLEnvCfg, default_cfg, make, register, registered_envs  # noqa: F401
from . import ball_rolling  # noqa: F401  (registers the eight TacEx-Ball-Rolling-* ids: six rigid, two UIPC)
from . import factory  # noqa: F401  (registers the three TacEx-Factory-*-Direct-v0 ids and the two -Uipc ids)
from . import grasp_lift  # noqa: F401  (registers the three TacEx-Grasp-Lift-Uipc* ids)
from . import pole_balancing  # noqa: F401  (registers TacEx-Pole-Balancing-Base-v0)
