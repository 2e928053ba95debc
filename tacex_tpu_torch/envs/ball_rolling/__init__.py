"""Ball-rolling task registration (the ids mirror the reference gym ids).

The two ``Uipc`` ids of the JAX package run in the soft-body world, which
the port does not have: they are not registered here."""

from ..base import register
from .env import BallRollingEnv, BallRollingEnvCfg


def _cfg(**kw) -> BallRollingEnvCfg:
    return BallRollingEnvCfg().replace(**kw)


register(
    "TacEx-Ball-Rolling-Taxim-Fots-v0",
    BallRollingEnv,
    lambda: _cfg(obs_mode="taxim_fots", with_markers=True),
)
register(
    "TacEx-Ball-Rolling-Tactile-RGB-v0",
    BallRollingEnv,
    lambda: _cfg(obs_mode="rgb", with_markers=False),
)
register(
    "TacEx-Ball-Rolling-Tactile-Depth-v1",
    BallRollingEnv,
    lambda: _cfg(obs_mode="depth", with_markers=False, vision_obs_shape=(24, 32, 1)),
)
register(
    "TacEx-Ball-Rolling-Privileged-v0",
    BallRollingEnv,
    lambda: _cfg(obs_mode="privileged", with_markers=False, action_space=5),
)
register(
    "TacEx-Ball-Rolling-Privileged-Reset-with-IK-v0",
    BallRollingEnv,
    lambda: _cfg(obs_mode="privileged", with_markers=False, action_space=5, reset_mode="ik_above"),
)
register(
    "TacEx-Ball-Rolling-Privileged-Without-Reaching-v0",
    BallRollingEnv,
    lambda: _cfg(obs_mode="privileged", with_markers=False, action_space=5, reset_mode="ik_contact"),
)
