from .base import DirectRLEnv, DirectRLEnvCfg, make, register  # noqa: F401
from . import ball_rolling  # noqa: F401  (registers the six rigid TacEx-Ball-Rolling-* ids)
from . import factory  # noqa: F401  (registers the three TacEx-Factory-*-Direct-v0 ids)
from . import pole_balancing  # noqa: F401  (registers TacEx-Pole-Balancing-Base-v0)
