"""tacex_tpu_torch: the PyTorch/CUDA port of ``tacex_tpu``.

A second package beside the JAX one, which stays the reference. It keeps
the JAX package's module paths and function names, its public layouts (NHWC
images, (N, h, w) height maps, (x, y) marker coordinates), and runs its two
Pallas kernels as hand-written CUDA kernels for Hopper (``csrc/``, built at
first use by ``ops/_build.py``). It imports torch and numpy and never jax.

Layers, from the trainer down (``rl.PPO(envs.make("TacEx-Ball-Rolling-Taxim-Fots-v0"))``):
  rl             — PPO and SAC, the actor-critic, the SAC actor and twin critics, per-task configs
  physics/rigid  — Franka IK + servo, sphere contact, the 9-DOF arm's dynamics and OSC
  ops            — the two kernels' wrappers, blurs, resizes, signed-distance functions
  render         — analytic orthographic depth camera, triangle-mesh rasterizer
  sensors        — GelSight: Taxim optical (pyramid kernel, LUT-shade kernel), FOTS markers
  envs           — ball rolling, Factory (held-asset contact), pole balancing: dones,
                   rewards, masked resets, observations
"""

__version__ = "0.1.0"
