"""Pole balancing registration (the id mirrors the reference gym id)."""

from ..base import register
from .env import PoleBalancingEnv, PoleBalancingEnvCfg

register("TacEx-Pole-Balancing-Base-v0", PoleBalancingEnv, lambda: PoleBalancingEnvCfg())
