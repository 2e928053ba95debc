"""tacex_tpu_torch: the PyTorch/CUDA port of ``tacex_tpu``.

A second package beside the JAX one, which stays the reference. It keeps
the JAX package's module paths and function names, its public layouts (NHWC
images, (N, h, w) height maps, (x, y) marker coordinates), and runs its two
Pallas kernels as hand-written CUDA kernels for Hopper (``csrc/``, built at
first use by ``ops/_build.py``). It imports torch and numpy and never jax.

Layers, from the trainer down (``rl.PPO(envs.make("TacEx-Ball-Rolling-Taxim-Fots-v0"))``):
  rl             — PPO and SAC, the actor-critic, the SAC actor and twin critics, per-task configs
  envs           — all 17 ids of the JAX package: ball rolling (six rigid, two UIPC with a
                   soft gel pad), Factory (three with held-asset contact, two UIPC with gel
                   pads and a free peg), Grasp-Lift (three), pole balancing: dones, rewards,
                   masked resets, observations
  physics/rigid  — Franka IK + servo, sphere contact, the 9-DOF arm's dynamics and OSC
  physics/soft   — the FEM gel: tet meshes, Neo-Hookean FEM, the batched IPC Newton solve
                   (ipc), dense surfaces embedded in coarse faces (embed), affine bodies
                   (abd) and the coupled FEM+ABD contact world (coupled)
  ops            — the two kernels' wrappers, blurs, resizes, signed-distance functions
  render         — analytic orthographic depth camera, triangle-mesh rasterizer
  sensors        — GelSight: Taxim optical (pyramid kernel, LUT-shade kernel), FOTS markers,
                   FEM marker flow and its ManiSkillSimulator facade
  assets         — procedural meshes, the analytic indenter shapes, the robot presets
  utils          — Timer and torch.profiler traces, the training dashboard, PNG output
                   (the scripts' tools: scripts/*_torch.py, scripts/demos/*_torch.py)
"""

__version__ = "0.1.0"
