"""Factory task registrations (the ids mirror the reference gym ids)."""

from ..base import register
from .env import FactoryEnv, FactoryEnvCfg, gear_mesh_task, nut_thread_task, peg_insert_task
from .env_uipc import FactoryUipcEnv, FactoryUipcEnvCfg

register("TacEx-Factory-PegInsert-Direct-v0", FactoryEnv, lambda: FactoryEnvCfg(task=peg_insert_task()))
register("TacEx-Factory-GearMesh-Direct-v0", FactoryEnv, lambda: FactoryEnvCfg(task=gear_mesh_task()))
register("TacEx-Factory-NutThread-Direct-v0", FactoryEnv, lambda: FactoryEnvCfg(task=nut_thread_task()))
# peg insertion in the coupled FEM+ABD world: gel pads and a free affine peg
register("TacEx-Factory-PegInsert-Uipc-v0", FactoryUipcEnv, lambda: FactoryUipcEnvCfg())
register("TacEx-Factory-PegInsert-Uipc-Depth-v0", FactoryUipcEnv, lambda: FactoryUipcEnvCfg(obs_mode="depth"))
