"""Ball-rolling task registration (the ids mirror the reference gym ids):
the six rigid tasks and the two whose gel pad is a soft FEM body."""

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


from .env_uipc import BallRollingUipcEnv, BallRollingUipcEnvCfg  # noqa: E402


def _uipc_cfg(**kw) -> BallRollingUipcEnvCfg:
    # the UIPC cfg subclass, so that envs.make(..., gel_resolution=...,
    # gel_embed_surface=...) reaches the gel's own fields
    return BallRollingUipcEnvCfg().replace(**{"num_envs": 16, "obs_mode": "rgb", "with_markers": False, **kw})


register("TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0", BallRollingUipcEnv, _uipc_cfg)
register("TacEx-Ball-Rolling-Uipc-Textured-v0", BallRollingUipcEnv, lambda: _uipc_cfg(obs_mode="camera_rgb"))
