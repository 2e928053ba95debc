from .networks import ActorCritic, VisionEncoder, actor_critic_from_flax, actor_critic_to_flax  # noqa: F401
from .ppo import PPO, PPOConfig  # noqa: F401
