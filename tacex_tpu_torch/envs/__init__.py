from .base import DirectRLEnv, DirectRLEnvCfg, make, register  # noqa: F401
from . import ball_rolling  # noqa: F401  (registers the six rigid TacEx-Ball-Rolling-* ids)
