"""Grasp-and-lift task registrations (the ids of ``tacex_tpu/envs/grasp_lift``)."""

from ..base import register
from .env import GraspLiftEnv, GraspLiftEnvCfg

register("TacEx-Grasp-Lift-Uipc-v0", GraspLiftEnv, lambda: GraspLiftEnvCfg())
# a 16x16 compression image embedded in each pad's inner face
register(
    "TacEx-Grasp-Lift-Uipc-Depth-v0",
    GraspLiftEnv,
    lambda: GraspLiftEnvCfg().replace(obs_mode="depth", tactile_embed=(16, 16)),
)
# the full GelSight stack on both pads, from a 32x32 embedded surface
register(
    "TacEx-Grasp-Lift-Uipc-Tactile-v0",
    GraspLiftEnv,
    lambda: GraspLiftEnvCfg().replace(obs_mode="tactile", tactile_embed=(32, 32)),
)
