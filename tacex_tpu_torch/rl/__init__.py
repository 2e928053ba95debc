from .networks import ActorCritic, VisionEncoder, actor_critic_from_flax, actor_critic_to_flax  # noqa: F401
from .ppo import PPO, PPOConfig  # noqa: F401
from .sac import SAC, SACConfig, sac_params_from_flax, sac_params_to_flax  # noqa: F401
