"""Ball-rolling task registration (the id mirrors the reference gym id)."""

from ..base import register
from .env import BallRollingEnv, BallRollingEnvCfg

register(
    "TacEx-Ball-Rolling-Taxim-Fots-v0",
    BallRollingEnv,
    lambda: BallRollingEnvCfg().replace(with_markers=True),
)
