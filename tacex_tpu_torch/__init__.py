"""tacex_tpu_torch: the PyTorch/CUDA port of ``tacex_tpu``.

A second package beside the JAX one, which stays the reference. It keeps
the JAX package's module paths and function names, its public layouts (NHWC
images, (N, h, w) height maps, (x, y) marker coordinates), and runs its two
Pallas kernels as hand-written CUDA kernels for Hopper (``csrc/``, built at
first use by ``ops/_build.py``). It imports torch and numpy and never jax.

Layers, from the trainer down (``rl.PPO(envs.make("TacEx-Ball-Rolling-Taxim-Fots-v0"))``):
  rl             — PPO (rollout, GAE, minibatch updates), the actor-critic, per-task configs
  physics/rigid  — Franka IK + servo, sphere contact
  render         — analytic orthographic depth camera
  sensors        — GelSight: Taxim optical (pyramid kernel, LUT-shade kernel), FOTS markers
  envs           — dones, rewards, curriculum, masked resets, observations
"""

__version__ = "0.1.0"
