from .networks import ActorCritic, VisionEncoder, actor_critic_from_flax  # noqa: F401
