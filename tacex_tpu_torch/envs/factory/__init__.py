"""Factory task registrations (the ids mirror the reference gym ids).

The two ``Uipc`` ids of the JAX package run in the soft-body world, which
the port does not have: they are not registered here."""

from ..base import register
from .env import FactoryEnv, FactoryEnvCfg, gear_mesh_task, nut_thread_task, peg_insert_task

register("TacEx-Factory-PegInsert-Direct-v0", FactoryEnv, lambda: FactoryEnvCfg(task=peg_insert_task()))
register("TacEx-Factory-GearMesh-Direct-v0", FactoryEnv, lambda: FactoryEnvCfg(task=gear_mesh_task()))
register("TacEx-Factory-NutThread-Direct-v0", FactoryEnv, lambda: FactoryEnvCfg(task=nut_thread_task()))
