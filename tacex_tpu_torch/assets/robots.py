"""Robot configuration presets: Franka + GelSight Mini variants.

A copy of the JAX package's ``assets/robots.py`` over the port's
``core.config.configclass``.

Counterpart of the reference's ``tacex_assets`` robot configs (reference
source/tacex_assets/tacex_assets/robots/franka/franka_gsmini_single_uipc.py:
29-108 and siblings): six articulations — single-sensor {rigid, soft,
uipc, uipc_textured} and gripper {rigid, uipc} — with HIGH_PD variants for
task-space IK. Here a preset is a plain config naming the kinematics,
default joints, tool offsets, servo gains, and which gel model the envs
should build (compliant-rigid box vs FEM soft body).
"""

from __future__ import annotations

import dataclasses

from ..core.config import configclass


@configclass
class FrankaGelSightCfg:
    """One arm + sensor mount preset."""

    name: str = "franka_gsmini_single_rigid"
    gel_model: str = "rigid"  # rigid | uipc | uipc_textured
    num_sensors: int = 1  # 1 = single fingertip sensor, 2 = gripper fingers
    # tool: offset from the flange to the gel contact surface
    ee_offset: tuple = (0.0, 0.0, 0.131)
    default_joint_pos: tuple = (-1.02, 0.3175, 0.06, -2.60, 0.0, 2.91, -0.12)
    # servo gains; HIGH_PD = stiffness 400 / damping 80 with gravity comp in
    # the reference — our rate-limited servo exposes an equivalent stiffness
    servo_stiffness: float = 40.0
    high_pd: bool = True
    gelpad_dimensions: tuple = (0.02075, 0.02525, 0.0045)
    gel_youngs_modulus_mpa: float = 0.145
    gel_poisson_ratio: float = 0.45


FRANKA_PANDA_ARM_SINGLE_GSMINI_RIGID_CFG = FrankaGelSightCfg()
FRANKA_PANDA_ARM_SINGLE_GSMINI_HIGH_PD_RIGID_CFG = FrankaGelSightCfg(servo_stiffness=80.0)
FRANKA_PANDA_ARM_SINGLE_GSMINI_SOFT_CFG = FrankaGelSightCfg(
    name="franka_gsmini_single_soft", gel_model="uipc", servo_stiffness=40.0
)
FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_CFG = FrankaGelSightCfg(
    name="franka_gsmini_single_uipc", gel_model="uipc"
)
FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_TEXTURED_CFG = FrankaGelSightCfg(
    name="franka_gsmini_single_uipc_textured", gel_model="uipc_textured"
)
FRANKA_PANDA_GRIPPER_GSMINI_RIGID_CFG = FrankaGelSightCfg(
    name="franka_gsmini_gripper_rigid",
    num_sensors=2,
    ee_offset=(0.0, 0.0, 0.107),
    default_joint_pos=(1.5178e-3, -0.19651, -1.4364e-3, -1.9761, -2.7717e-4, 1.7796, 0.78556),
)
FRANKA_PANDA_GRIPPER_GSMINI_UIPC_CFG = dataclasses.replace(
    FRANKA_PANDA_GRIPPER_GSMINI_RIGID_CFG, name="franka_gsmini_gripper_uipc", gel_model="uipc"
)

ALL_ROBOT_CFGS = {
    c.name: c
    for c in [
        FRANKA_PANDA_ARM_SINGLE_GSMINI_RIGID_CFG,
        FRANKA_PANDA_ARM_SINGLE_GSMINI_SOFT_CFG,
        FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_CFG,
        FRANKA_PANDA_ARM_SINGLE_GSMINI_UIPC_TEXTURED_CFG,
        FRANKA_PANDA_GRIPPER_GSMINI_RIGID_CFG,
        FRANKA_PANDA_GRIPPER_GSMINI_UIPC_CFG,
    ]
}
