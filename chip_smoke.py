#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: the flagship env step,
PPO training on it, the other ball-rolling tasks, every shading path, the
Factory tasks, pole balancing, SAC, the soft FEM gel pad of the UIPC
ball-rolling tasks, the user-facing tools and demos, the coupled FEM+ABD
world of the Grasp-Lift and Factory-UIPC tasks, the UIPC scene API, the
standalone ABD solve, shells (cloth) and env-axis data parallelism
(torch.distributed, one rank on the one card).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository's ``tacex_tpu_torch``
package beside this file; it imports nothing of JAX. In order it:

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the CUDA kernels from ``tacex_tpu_torch/csrc`` for sm_90a (one
     nvcc per source, in parallel) and prints ptxas's registers and spills;
  3. runs ``GelSightSensor`` with its default 320x240 Taxim + FOTS config on
     256 envs (a 4 mm sphere pressed into the gel, its centre and depth
     varied per env), with the launch counters reset just before one update;
     checks both kernels ran, times the update, and holds 2 envs to the
     CPU's (plain versions) under the bin rule of ``tests/_torch_bins.py``,
     printing how near a bin edge the pixels whose bins differ lie;
  4. holds each kernel against its plain PyTorch version (atol 1e-5: sums
     run in another order and nvcc contracts to FMA): the pyramid at the
     flagship frame (4096, 24, 32), at (5, 48, 64) and at the sensor frame
     (256, 240, 320); the shading at (4096, 768) with the 15,625-row table,
     through ``dir_row_shade``, and at the sensor frame's (256, 76800)
     pixels; times each with CUDA events beside its
     plain version, its bound (bytes over 3.35 TB/s or FLOPs over
     67 TFLOP/s FP32, NVIDIA's H100 SXM data sheet, whichever is larger)
     and, for the shading, the one PyTorch call that computes it
     (``embedding_bag``, timed here only: the port never calls it); and
     K2's bf16-table entry (``lut_dtype=torch.bfloat16``) at (4096, 768)
     and (256, 76800), after a counted ``render(lut_dtype=bfloat16)`` of
     the flagship's frame and of the sensor's (``embedding_bag`` then runs
     on the bf16-rounded table, widened);
  5. runs ``TacEx-Ball-Rolling-Taxim-Fots-v0`` at 4096 envs with the
     actor-critic's mean action (plus -0.1 on z, so the gel presses the
     ball) in the loop; the steady steps run under
     ``torch.cuda.set_sync_debug_mode("error")``, so any host sync raises;
     checks every output is finite, that the gel is pressed, and that both
     kernels were launched on every step;
  6. steps the env at 8 envs on the card (kernels) and on the CPU (plain
     versions) from one state and holds the two to each other; runs
     ``DirectRLEnv.rollout`` for 5 steps at 4096 envs under sync-debug
     "error" (K1 and K2 once a step) and holds its first 16 envs to the same
     rollout on the CPU; and holds one ``ActorCritic(shared_trunk=True)``
     forward on the card to the CPU's (atol 1e-5);
  7. trains: ``PPO`` on the flagship at 4096 envs under its tuned config
     (rollouts of 64, 4 epochs of 32 minibatches of 8,192 samples), one
     warm-up iteration and two timed ones, the second under sync-debug
     "error"; checks that loss and reward are finite, every parameter
     moved, the step count, the learning rate's range and that both kernels
     ran once per rollout step; prints seconds per iteration, env-steps/s,
     the rollout/update split (CUDA events) and peak memory;
  8. trains ``TacEx-Ball-Rolling-Privileged-v0`` at 4096 envs under its state
     config for 5 iterations and prints each one's reward per step;
  9. resets and steps each of the other five ball-rolling ids at 256 envs
     under sync-debug "error", checks the observation shapes, and holds the
     two IK resets' joint angles to the same solve on the CPU (atol 1e-4);
 10. at 320x240 on 16 pressed envs, holds ``render(with_shadow=True)``,
     ``shade(interp="bilinear")`` and ``render(compact_capacity=16384)`` on
     the card to the same calls on the CPU, times each, checks the compact
     call launched the shading kernel twice (the halo, the contact rows),
     that the shading kernel's wrapper refuses a CUDA input that requires
     grad (the pyramid's has a backward kernel: phase 23);
     ``render(lut_dtype=bfloat16)`` on the card against the CPU under the
     bin rule, the compact render with the bf16 table (K2's bf16 entry on
     the contact rows, counted and held to its plain version), and
     ``render(orig_hm_fmt=True)`` against the CPU under the bin rule;
 11. steps each Factory task (PegInsert, GearMesh, NutThread) at its
     default 128 envs: reset, a warm-up step, 5 steps under sync-debug
     "error" with K1 and K2 each launched exactly once a step on the 256
     finger images of 32x32; prints ms/step, CUDA kernels a step
     (``torch.profiler``) and peak memory; holds K1 (warp design) and K2 on
     PegInsert's frame to their plain versions and times them, and one
     PegInsert step on the card to the CPU from the same state
     (``tests/test_torch_factory.py``'s tolerances);
 12. trains PPO one iteration on PegInsert at 128 envs under its tuned
     config (4 epochs x 32 minibatches), cut to 16 rollout steps, on
     the (32, 32, 6) finger images, with the rollout/update split;
 13. resets and steps pole balancing at 1024 envs under sync-debug "error";
 14. trains SAC on the privileged task at 512 envs under the config of
     ``logs/sac_privileged_r05`` (one train step crosses the warm-up, five
     more run under sync-debug "error") and on the flagship at 4096 envs
     under its SAC config (two train steps), with losses and temperature;
 15. steps ``TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0`` (the FEM gel pad, one
     batched IPC Newton solve a step) at its registered 16 envs pressing the
     gel onto the ball: reset, a warm-up step, 5 steps under sync-debug
     "error" with K1 and K2 launched once a step; prints ms/step, CUDA
     kernels a step, peak memory, the envs in contact and the gel's largest
     displacement; holds K1 and K2 on its (16, 24, 32) frame to their plain
     versions; holds 2 envs on the card to the CPU after one step from a
     carried-over pressed state (gel, ball, reward, indentation, and the
     tactile image under the bin rule); steps the textured id at 16 envs (3
     steps) and checks that the filmed marker dots move under the press; and
     the embedded dense contact surface (gel "low", surface
     "extremely_high") at 64 envs, 3 steps, with K1 and K2 on its frame;
 16. (after step 4) the sensor at the calibration's own 640x480 frame on 4
     envs: one update counted, K1 through its global-memory design (no
     cluster of 8 CTAs holds the 117-tap first level's halo), held to its
     plain version and timed ("pyramid global 480x640");
 17. the coupled FEM+ABD world: ``TacEx-Grasp-Lift-Uipc-Tactile-v0`` at its
     registered 16 envs from a pressed start (each pad 0.6 mm toward the
     cube): a warm step, 1 step under sync-debug "error" with K1 and K2
     launched once a step on the 2N = 32 pad images of 32x32; prints ms a
     step, torch.profiler's device activities and device time of one more
     step, one coupled solve alone and peak memory; holds K1 (warp design,
     (32, 32, 32)) and K2 ((32, 1024), full table, beside ``embedding_bag``)
     to their plain versions; holds 2 envs on the card to the CPU after one
     step from a carried-over pressed state at the parity tests' 2 Newton x
     8 CG (gel, cube q, reward, grip, and the tactile image of the CPU's gel
     under the bin rule; at the registered iterations it prints how far a
     2e-9 m jolt of the gel moves the CPU's own step); the scripted
     squeeze of ``-Uipc-v0`` (action [1, 0], 2 steps: the cube must stay
     above -3 mm); and 1 step each of ``-Uipc-Depth-v0`` and both
     Factory-UIPC ids under sync-debug "error";
 18. (before step 17) the user-facing tools, each through its script's entry
     point, with the launch counters reset just before it: the 26-shape
     Taxim library at 240x320 in one ``render`` (``check_taxim_sim_torch``;
     K1 and K2 once, 2 shapes held to the CPU's render under the bin rule);
     ``follow_goal_torch`` at its 150 steps (K1 and K2 once a step on one
     240x320 image); ``pick_up_rigid_torch`` at its 4 x 120 steps (the ball
     must rise 5 cm); ``check_mani_skill_marker_torch`` at its 8 steps (no
     kernel; the markers must move); ``pick_up_uipc_torch`` cut to 4 x 3
     steps (finite); ``train_torch.py`` -> ``play_torch.py`` on the flagship
     at 512 envs (2 iterations with the dashboard, 20 played steps with
     ``--save_frames``; the played first action is the trained net's to
     1e-6); ``benchmark_non_rl_example_torch`` at its 64 envs and 100
     frames; and K1 and K2 held to their plain versions and timed on the
     library's (26, 240, 320) frame and on the pressed sphere's 1- and 2-image
     frames (the follow-goal and pick-up demos' shapes);
 19. the UIPC scene API, which launches neither kernel: the six
     example scripts through ``main(argv)`` at their own envs and meshes,
     cut to 2 steps (``grasp_lift`` to 1; ``floating_cube`` ends with
     ``check_health``), with ms a step and finite positions; the union of
     two ``TetMeshCfg()`` gel pads (396 vertices each) with self and
     edge-edge contact at K = 4 at 16 envs, the top pad driven down onto
     the bottom one by its attachment: a warm step, 4 steps under
     sync-debug "error" with the kernel counters at 0, ms a step and a
     solve, torch.profiler's device activities and busy share of one more
     step, peak memory, the broad-phase counts, the bottom pad pushed and
     no interpenetration, and envs 0-1 carried to the CPU for one step
     (atol 1.5e-5 m); ``save_frame``/``replay_frame`` after a later step
     and write; ``step_n(4)`` against 4 ``step``s within 1e-6 (in
     deterministic mode); and ``ccd_envelope_torch``'s ``run`` at 0.8 m/s
     (caught) and 1.6 m/s (tunnels) at dt 1/60;
 20. the standalone ABD solve, which launches neither kernel: the
     8-cube pile of ``benchmark_abd_pile_torch`` at 64 envs with the dense
     Newton solve and with CG, each a warm step and 3 steps, the first
     profiled (torch.profiler's device activities and busy share), the last
     2 timed under sync-debug "error" (ms a step), with peak memory and the
     broad-phase counts; envs 0-1 of the stepped pile taken one more step
     on the card and on the CPU at the parity tests' 2 Newton x 6
     line-search (x 3 CG) iterations (atol 1e-5 dense, 1e-4 CG), and the
     same from the 8 cubes stacked in contact (within the larger of that
     and 4x the CPU step's response to a 1e-7 jolt of its input);
     ``wrecking_balls_torch`` (six bodies in the split ABD world of
     ``UipcSim``) and ``screw_and_nut_torch`` (thread contact) at 2 steps,
     with their broad-phase counts;
 21. (last) shells, which launch neither kernel: the standalone
     ``ShellModel`` on ``grid_cloth()``'s 20 x 20 cloth of 2 m (400
     vertices, 722 triangles; the bunny-cloth sample's constitution) over a
     320-triangle icosphere soup 1.5 mm under it and the ground at 64 envs:
     a warm step, then 4 steps under sync-debug "error", the first profiled
     (torch.profiler's device activities and busy share), the other 3 timed
     (ms a step), peak memory, the clearance to the soup; envs 0-1 taken one
     more step on the card and on the CPU at the parity tests' 2 Newton x 6
     CG x 4 line-search iterations (within 1e-5 m, or 4x the CPU step's own
     response to a 1e-7 m jolt where that is larger); ``cloth_trampoline_torch``
     (cloth and a free cube in the coupled world) and ``bunny_cloth_torch``
     (a standalone cloth over a kinematic body) at 1 step each; and a lone
     20 x 20 cloth with self contact through the union at 16 envs, 1 step,
     with its broad-phase counts;
 22. (after step 8) env-axis data parallelism: a 1-rank NCCL group in this
     process (127.0.0.1, a free port; NCCL refuses two ranks on one card)
     runs the flagship's PPO at 4096 envs under its tuned config through
     the sharded path, a warm iteration then one under sync-debug "error";
     holds the all-reduced gradient, loss and KL of each minibatch of that
     iteration's first epoch, at the iteration's end, to the plain PPO's
     ``autograd.grad`` of the same rows (relative 1e-6, or twice the
     spread of two plain gradients where that is larger), and the whole
     iteration to the plain PPO's from the same state and the same
     permutations, in the parameters and the loss, within twice the spread
     of two plain iterations from that state (equal where that is 0, as it
     is under cuDNN's deterministic algorithms, which the phase selects);
     prints the iteration's seconds beside the plain one's, and the count
     and device time (CUDA events) of its all-reduces; 3
     flagship steps with the curriculum's all-reduce under sync-debug
     "error"; one sharded SAC train step on the privileged task at 512
     envs; and ``torchrun --nproc_per_node 1 scripts/train_torch.py
     --shard`` (2 iterations at 256 envs) as a subprocess, which must exit
     0 with one JSON line an iteration;
 23. (last, after the shells) gradients: ``render(interp="bilinear")``'s
     height-map gradient at (4096, 24, 32), (256, 240, 320) and (4, 480,
     640), each launching K1 and its backward kernel once (counted), then
     the backward kernel held to ``deformation_pyramid_backward_plain``
     (max |err| within 1e-5 of max |plain|) and timed at those shapes; the
     gradient at 16 x 240 x 320 on the card under sync-debug "error",
     against the CPU's (relative 1e-3 in norm; the loss weighs a ring of
     each press off the LUT's bin edges); the UIPC gel at its registered
     16 envs, pressed, then one ``SoftBodyModel.step`` forward and backward
     under sync-debug "error", with its device activities, device ms
     (torch.profiler), host ms and peak memory beside the no-grad step's;
     and its gradient in (x, aim, ball) on 2 envs against the CPU's at 3
     Newton x 3 CG (relative 1e-2).

Each phase prints its seconds. The second-to-last line is a JSON object with a row per kernel and shape:
its launches on the main path that runs it at that shape, its error against
the plain version, its times, bound and share of the bound, and the library
call's time; then each phase's numbers. The last line is ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ENV_ID = "TacEx-Ball-Rolling-Taxim-Fots-v0"
NUM_ENVS = 4096
SENSOR_ENVS = 256
PRIVILEGED_ID = "TacEx-Ball-Rolling-Privileged-v0"
OTHER_IDS = {  # id -> vision obs shape (None: proprio only)
    "TacEx-Ball-Rolling-Tactile-RGB-v0": (24, 32, 3),
    "TacEx-Ball-Rolling-Tactile-Depth-v1": (24, 32, 1),
    PRIVILEGED_ID: None,
    "TacEx-Ball-Rolling-Privileged-Reset-with-IK-v0": None,
    "TacEx-Ball-Rolling-Privileged-Without-Reaching-v0": None,
}
FACTORY_IDS = (
    "TacEx-Factory-PegInsert-Direct-v0",
    "TacEx-Factory-GearMesh-Direct-v0",
    "TacEx-Factory-NutThread-Direct-v0",
)
FACTORY_STEPS = 5
FACTORY_TRAIN_ROLLOUTS = 16  # the tuned 128 cut, so that the whole run stays under 900 s
POLE_ID = "TacEx-Pole-Balancing-Base-v0"
POLE_STEPS = 5
SAC_PRIVILEGED_ENVS = 512  # logs/sac_privileged_r05/config.json
SAC_GUARDED_STEPS = 5
SAC_VISION_STEPS = 2
TRAIN_ITERATIONS = 3  # one warm-up, two timed
PRIVILEGED_ITERATIONS = 5
OTHER_ENVS = 256
SHADING_ENVS = 16
COMPACT_CAPACITY = 16384
UIPC_IDS = ("TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0", "TacEx-Ball-Rolling-Uipc-Textured-v0")
UIPC_STEPS = 5
UIPC_TEXTURED_STEPS = 3
UIPC_EMBED_ENVS = 64  # scripts/benchmarking/benchmark_embedded_gel.py
UIPC_EMBED_STEPS = 3
UIPC_PRESS = -0.02
GRASP_IDS = ("TacEx-Grasp-Lift-Uipc-Tactile-v0", "TacEx-Grasp-Lift-Uipc-v0", "TacEx-Grasp-Lift-Uipc-Depth-v0")
FACTORY_UIPC_IDS = ("TacEx-Factory-PegInsert-Uipc-v0", "TacEx-Factory-PegInsert-Uipc-Depth-v0")
COUPLED_PRESS = 6e-4
# the card-against-CPU check's iterations: the parity tests' (tests/_torch_coupled.py)
REF_NEWTON_ITERS = 2
REF_CG_ITERS = 8
COUPLED_STEPS = 1  # few: a step takes 12-22 s, and the whole run stays under 900 s
COUPLED_OTHER_STEPS = 1
SQUEEZE_STEPS = 2  # as COUPLED_STEPS
CALIB_ENVS = 4
# the tools phase: the scripts' own default sizes (scripts/demos, scripts/benchmarking)
TOOLS_RES = (240, 320)
FOLLOW_GOAL_STEPS = 150
FOLLOW_GOAL_MAX_ERROR = 2e-4  # m, the mean after step 10 (the CPU test's 0.2 mm)
PICK_UP_RIGID_STEPS = 120  # a phase, 4 phases
PICK_UP_RIGID_MIN_LIFT = 0.05
MANI_SKILL_STEPS = 8
PICK_UP_UIPC_STEPS = 3  # a phase (the demo's default is 100)
PLAY_ENVS = 512
PLAY_ITERATIONS = 2
PLAY_STEPS = 20
NON_RL_ENVS = 64
NON_RL_FRAMES = 100
TOOLS_CPU_SHAPES = 2  # the library shapes also rendered on the CPU
UIPC_API_ENVS = 16  # the UIPC ids' registered count
UIPC_API_STEPS = 5
UIPC_API_DROP = 4e-4  # m a step, the top pad's attachment
UIPC_API_REF_AFTER = 3  # the card's step after which 2 envs are carried to the CPU for one step
UIPC_API_ATOL = 1.5e-5  # m: two f32 solves of one step (tests/_torch_uipc_api.py)
UIPC_EXAMPLES = {  # script -> steps in the phase (the scripts' own: 90, 150, 120, 60, 40, 130; ~2 s a step)
    "examples/libuipc_samples/hello_uipc_torch.py": 2,
    "examples/libuipc_samples/floating_cube_torch.py": 2,
    "examples/libuipc_samples/periodically_pressed_tetrahedron_torch.py": 2,
    "examples/falling_gel_cubes_torch.py": 2,
    "examples/single_uipc_attachment_torch.py": 2,
    "examples/grasp_lift_torch.py": 1,
}
STEP_N_STEPS = 4
ABD_ENVS = 64  # scripts/benchmarking/benchmark_abd_pile.py's default
ABD_STEPS = 3  # the first profiled
ABD_REF_CFG = dict(newton_max_iter=2, line_search_iters=6, cg_iters=3)  # tests/_torch_abd.py's iterations
ABD_REF_ATOL = {"dense": 1e-5, "cg": 1e-4}  # tests/test_torch_abd_step.py
ABD_SAMPLE_STEPS = 2
SHELL_ENVS = 64  # the abd phase's batch
SHELL_STEPS = 4  # under sync-debug "error" after a warm step: the first profiled, the others timed
SHELL_SOUP_GAP = 1.5e-3  # m: the cloth over the soup's top vertex, inside d_hat (2 mm)
SHELL_REF_CFG = dict(newton_max_iter=2, cg_iters=6, line_search_iters=4, velocity_tol=0.0)  # tests/_torch_shell.py
SHELL_REF_ATOL = 1e-5  # m, or 4x the CPU step's response to a 1e-7 m jolt where that is larger
SHELL_SCENE_STEPS = 1
SHELL_UNION_ENVS = 16
SHELL_UNION_STEPS = 1
PARALLEL_SAC_ENVS = 512  # the sac phase's privileged width
PARALLEL_CURRICULUM_STEPS = 3
PARALLEL_TORCHRUN_ENVS = 256
PARALLEL_TORCHRUN_ITERATIONS = 2
# One minibatch of the 1-rank NCCL PPO (its rows picked from the global
# permutation, each term summed and divided by the minibatch size, the
# flat all-reduce) against the plain PPO's autograd.grad of the same rows
# at the same network: ||g - g_plain|| / ||g_plain||, and the relative
# difference of the loss and the KL. The two run the same arithmetic, so
# they may differ only by kernels that are not deterministic: the bound is
# the larger of PARALLEL_GRAD_RTOL and PARALLEL_SPREAD_FACTOR times the
# spread of two plain gradients of the same rows (0 under the
# deterministic cuDNN algorithms the phase selects; up to 1.4e-6 with the
# default ones).
PARALLEL_GRAD_RTOL = 1e-6
# The whole 1-rank iteration against the plain PPO's from the same state
# and permutations, in the parameters and the loss: within this factor of
# the spread of two plain iterations from that state (the card's
# run-to-run noise: 0 under the phase's deterministic cuDNN algorithms, and
# then the two must be equal).
PARALLEL_SPREAD_FACTOR = 2.0
ROLLOUT_STEPS = 5
ROLLOUT_CPU_ENVS = 16  # the rollout's first envs, held to the CPU
WARMUP_STEPS = 2
STEPS = 10
KERNEL_ATOL = 1e-5
# K1's backward against its plain adjoint: max |err| within this share of
# max |plain| (the two sum the taps in another order)
BACKWARD_RTOL = 1e-5
# the shapes of K1's backward: the flagship's, the sensor's, the calibration frame's
GRAD_KERNEL_SHAPES = ((4096, 24, 32), (256, 240, 320), (4, 480, 640))
GRAD_RENDER_ENVS = 16  # render's height-map gradient at 320x240, card against CPU
# ||g_card - g_cpu|| / ||g_cpu|| of render's height-map gradient: the loss
# weighs a ring of the press where the slope is well above float noise (the
# direction's derivative is 1 / |slope| times the noise elsewhere)
GRAD_RENDER_RTOL = 1e-3
GRAD_GEL_PRESS_STEPS = 7  # the UIPC press steps before the gradient step: the gel within d_hat of the ball
# The gel's one-step gradient, card against CPU on 2 envs, at 3 Newton x 3
# CG: at the registered 4 x 16 the unrolled gradient moves by ~100% of its
# norm under a 1e-9 m jolt of x (CG's later iterations run on rounding
# noise; on the CPU and in JAX alike), at 3 x 3 by 5e-4
GRAD_GEL_REF_CFG = dict(newton_max_iter=3, cg_iters=3)
GRAD_GEL_RTOL = 1e-2
# NVIDIA H100 SXM data sheet: device memory rate and FP32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SPIN_CYCLES = 20_000_000  # ~10 ms at 2 GHz: the host queues the timed calls meanwhile
# How near a LUT bin edge (in bins) a gradient may lie for the card's and the
# CPU's sensor images to take different rows there: their inputs differ by one
# f32 step of the depth, which moved no gradient by more than 0.0013 bins on
# an H100 (the sensor phase prints the largest it sees).
EDGE_BINS = 0.005
REPO = Path(__file__).resolve().parent


def _timed_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, host ms) of one call. The calls are queued behind a spin
    on the card, so the CUDA events around them time the device alone; the
    host clock around the queueing times the host's side of a call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host / iters


def _frame(env, state):
    """The flagship's tactile frame of ``state`` up to the kernels' inputs:
    the pyramid's (joined, mask, sigmas) and, after the deformation, the LUT
    indices (full table and direction only)."""
    return _height_frame(env.sensor.calib, _flagship_shifted(env, state))


def _flagship_shifted(env, state):
    """The flagship's (n, 24, 32) shifted height maps (mm) of ``state``."""
    from tacex_tpu_torch.envs.ball_rolling.env import CAM_EXTENT
    from tacex_tpu_torch.render.depth_camera import SdfScene, render_depth_batch
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    c = env.cfg
    n = c.num_envs
    tool_pos, tool_quat = env._tool_pose(state.arm.q)
    cam_pos, cam_quat = env._camera_pose(tool_pos, tool_quat)
    radius = torch.full((n, 1), c.ball_radius, device=env.device)
    scene = SdfScene(torch.cat([state.ball_pos, radius], -1)[:, None], env._boxes, env._capsules, env._planes)
    depth = render_depth_batch(cam_pos, cam_quat, scene, tuple(c.camera_resolution), CAM_EXTENT, far=c.sensor_clipping[1])
    hm = env.sensor.height_map_from_depth(depth)
    return optical.shift_height_map(hm, env.sensor.compute_indentation_depth(hm))


def _depth_frame(sensor, depth):
    """The sensor's frame of a (n, h, w) depth map up to the kernels' inputs."""
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    hm = sensor.height_map_from_depth(depth)
    return _height_frame(sensor.calib, optical.shift_height_map(hm, sensor.compute_indentation_depth(hm)))


def _optical_bins(calib, shifted):
    """The LUT gradients and bins of (n, h, w) shifted height maps."""
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    deformed, _ = optical.compute_gel_deformation(calib, shifted)
    grad_mag, grad_dir = optical.generate_normals(calib, -deformed / calib.sensor_params.pixmm)
    return grad_mag, grad_dir, optical.lut_bins(calib, grad_mag, grad_dir)


def _height_frame(calib, shifted):
    """The kernels' inputs of the optical path on (n, h, w) shifted height
    maps (mm): the pyramid's (joined, mask, sigmas) and, after the
    deformation, the LUT indices (full table and direction only)."""
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    n = shifted.shape[0]
    joined, mask, sigmas = optical.deformation_inputs(calib, shifted)
    _, _, (idx_mag, idx_dir) = _optical_bins(calib, shifted)
    nb = calib.sensor_params.num_bins
    p = idx_mag.shape[-2] * idx_mag.shape[-1]
    idx = (idx_mag * nb + idx_dir).reshape(n, p).contiguous()
    return joined.contiguous(), mask.contiguous(), sigmas, idx, idx_dir.reshape(n, p).contiguous()


def sensor_sigmas(hw) -> tuple:
    """The sensor's pyramid at an h x w image: its levels, then the final blur."""
    from tacex_tpu_torch.sensors.gelsight.taxim.calib import default_calib_folder
    from tacex_tpu_torch.sensors.gelsight.taxim.params import load_params

    sim = load_params(default_calib_folder())[0]
    return tuple(sim.deform_pyramid_sigma(hw)) + (sim.deform_final_sigma(hw),)


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate or
    operations over the FP32 rate, whichever is larger, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pyramid_bound(shape, sigmas) -> tuple[float, str]:
    """K1 reads joined (f32) and mask (1 byte) and writes the result (f32)
    once; each tap of a pass with more than one tap is one FMA (2 FLOPs) a
    pixel (a one-tap pass is the identity)."""
    from tacex_tpu_torch.ops.blur import gaussian_taps

    n, h, w = shape
    taps = sum(len(gaussian_taps(s)) for sx, sy in sigmas for s in (sy, sx) if len(gaussian_taps(s)) > 1)
    return _bound(n * h * w * (4 + 1 + 4), 2.0 * n * h * w * taps)


def lut_bound(n, p, rows, row_bytes: int = 72) -> tuple[float, str]:
    """K2 reads the indices (i32), the features (6 x P f32) and the table
    (R x 18 f32, or bf16: 36-byte rows) once and writes (n, P, 3) f32; 18
    FMAs a pixel."""
    return _bound(4 * n * p + 24 * p + row_bytes * rows + 12 * n * p, 36.0 * n * p)


def _timing(fn, plain, nbytes_flops, library=None) -> dict:
    ms, host_ms = _timed_ms(fn)
    bound_ms, bound_by = nbytes_flops
    return dict(ms=ms, plain_ms=_timed_ms(plain)[0], bound_ms=bound_ms, bound_by=bound_by,
                pct_of_bound=100.0 * bound_ms / ms, host_ms=host_ms,
                library_ms=None if library is None else _timed_ms(library)[0])


def _compare(name, out, ref) -> float:
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    finite = bool(torch.isfinite(out).all())
    print(f"kernel {name}: shape {tuple(out.shape)} max_abs_err {err:.3e} (atol {KERNEL_ATOL})")
    if not finite or not err <= KERNEL_ATOL:
        raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}, finite {finite}")
    return err


def _pyramid_entry(label, joined, mask, sigmas, design) -> dict:
    """K1 held to its plain version and timed on (joined, mask, sigmas),
    after checking which design the kernel takes for the shape (0 = a warp
    per image, 1..8 the cluster's CTAs, 9 the global-memory design)."""
    from tacex_tpu_torch.ops import _build
    from tacex_tpu_torch.ops import pyramid as K1

    n, h, w = joined.shape
    taps, ky, kx = K1._packed_taps(tuple((float(sx), float(sy)) for sx, sy in sigmas), h, w)
    plan = _build.load_library().tacex_deformation_pyramid_plan(
        h, w, taps.ctypes.data, ky.ctypes.data, kx.ctypes.data, len(ky)
    )
    expected = {"warp": plan == 0, "global": plan == K1.GLOBAL_DESIGN, "cluster": 1 <= plan <= 8}[design]
    if not expected:
        raise AssertionError(f"the pyramid takes design {plan} at {h}x{w}, expected the {design} design")
    err = _compare(f"deformation_pyramid[{label}]", K1.deformation_pyramid(joined, mask, sigmas),
                   K1.deformation_pyramid_plain(joined, mask, sigmas))
    return dict(shape=[n, h, w], design=design, max_abs_err=err,
                **_timing(lambda: K1.deformation_pyramid(joined, mask, sigmas),
                          lambda: K1.deformation_pyramid_plain(joined, mask, sigmas),
                          pyramid_bound(joined.shape, sigmas)))


def _lut_entry(label, idx, feats, table) -> dict:
    """K2 held to its plain version and timed, beside the library yardstick:
    one ``embedding_bag`` over bags of the pixel's six 3-float LUT entries,
    weighted by its features (inputs built untimed; the port never calls it)."""
    from tacex_tpu_torch.ops import lut_shade as K2

    n, p = idx.shape
    err = _compare(f"lut_shade[{label}]", K2.lut_shade(idx, feats, table), K2.lut_shade_plain(idx, feats, table))
    bags = (idx.long()[..., None] * 6 + torch.arange(6, device=idx.device)).reshape(n * p, 6)
    weights = feats.T.expand(n, p, 6).reshape(n * p, 6).contiguous()
    entries = table.to(torch.float32).reshape(-1, 3)  # a bf16 table rounded, then widened
    library = lambda: torch.nn.functional.embedding_bag(bags, entries, per_sample_weights=weights, mode="sum")
    _compare(f"embedding_bag[{label}] (library yardstick)", library().reshape(n, p, 3),
             K2.lut_shade_plain(idx, feats, table))
    return dict(shape=[n, p, table.shape[0]], max_abs_err=err,
                **_timing(lambda: K2.lut_shade(idx, feats, table), lambda: K2.lut_shade_plain(idx, feats, table),
                          lut_bound(n, p, table.shape[0], 18 * table.element_size()), library))


def _print_entries(entries: dict) -> None:
    for label, r in entries.items():
        lib = "" if r.get("library_ms") is None else f", library call {r['library_ms']:.4f} ms"
        print(f"kernel {label} {r['shape']}: {r['ms']:.4f} ms, plain PyTorch {r['plain_ms']:.4f} ms{lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['pct_of_bound']:.1f}% of bound; "
              f"host {r['host_ms']:.4f} ms a call")


def kernel_phase(env, state, device, sensor_frame, sensor_lut) -> dict:
    """Each kernel against its plain version at the flagship's shapes, at a
    ragged (5, 48, 64) batch and at the default sensor's (256, 240, 320)
    frame: {label: entry}."""
    from tacex_tpu_torch.ops import pyramid as K1

    calib = env.sensor.calib
    joined, mask, sigmas, idx, idir = _frame(env, state)
    entries = {"pyramid warp 24x32": _pyramid_entry("4096x24x32", joined, mask, sigmas, "warp")}
    sig48 = sensor_sigmas((48, 64))
    g = torch.Generator(device=device).manual_seed(0)
    j48 = torch.rand((5, 48, 64), generator=g, device=device) * 3.0 - 1.0
    m48 = torch.rand((5, 48, 64), generator=g, device=device) < 0.2
    _compare("deformation_pyramid[5x48x64]", K1.deformation_pyramid(j48, m48, sig48),
             K1.deformation_pyramid_plain(j48, m48, sig48))
    entries["pyramid cluster 240x320"] = _pyramid_entry("256x240x320", *sensor_frame, "cluster")

    # K2 with the full 15,625-row table at (4096, 768); the 125-row
    # magnitude-bin-0 subtable that the compact shading path gives it,
    # through dir_row_shade; the sensor frame's (256, 76800) pixels
    nb = calib.sensor_params.num_bins
    table = calib.poly_lut.reshape(nb * nb, 18)
    feats = calib.features
    entries["lut full table 4096x768"] = _lut_entry("4096x768", idx, feats, table)
    entries["lut subtable 4096x768"] = _lut_entry("4096x768 subtable", idir, feats, table[:nb].contiguous())
    tabs = torch.zeros((18, 128), device=device)
    tabs[:, :nb] = table[:nb].T
    from tacex_tpu_torch.ops import lut_shade as K2

    _compare("dir_row_shade", K2.dir_row_shade(idir, feats, tabs), K2.lut_shade_plain(idir, feats, tabs.T))
    entries["lut full table 256x76800"] = _lut_entry("256x76800", *sensor_lut)

    # K2's bf16 entry: the flagship's frame rendered with lut_dtype=bfloat16
    # (counted), then the entry held to its plain version on the rounded table
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    shifted = _flagship_shifted(env, state)
    _reset_counters()
    rgb = optical.render(calib, shifted, lut_dtype=torch.bfloat16)
    bf16 = {"render_bf16_24x32_4096": _bf16_launches()}
    if bf16["render_bf16_24x32_4096"]["lut_shade_bf16"] != 1 or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"render(lut_dtype=bfloat16) at 4096 envs: launches {bf16}")
    entries["lut bf16 full table 4096x768"] = _lut_entry("4096x768 bf16", idx, feats, table.to(torch.bfloat16))
    idx_s, feats_s, table_s = sensor_lut
    entries["lut bf16 full table 256x76800"] = _lut_entry("256x76800 bf16", idx_s, feats_s, table_s.to(torch.bfloat16))
    _print_entries(entries)
    return entries, bf16


def _counters():
    from tacex_tpu_torch.ops import lut_shade as K2
    from tacex_tpu_torch.ops import pyramid as K1

    return K1.deformation_pyramid, K2.lut_shade


def _reset_counters() -> None:
    for fn in _counters():
        fn.launches = 0
    _counters()[0].backward_launches = 0
    _counters()[1].bf16_launches = 0


def _bf16_launches() -> dict:
    """K2's bf16-table entry's launches since the last reset."""
    return {"lut_shade_bf16": _counters()[1].bf16_launches}


def _read_counters() -> dict:
    k1, k2 = _counters()
    return {"deformation_pyramid": k1.launches, "lut_shade": k2.launches}


def _press_depth(n: int, device) -> torch.Tensor:
    """(n, 240, 320) camera depth (m) of a 4 mm sphere pressed 1.2-1.6 mm
    into the gel, as in the verify recipe, its centre moved per env."""
    h, w = 240, 320
    i = torch.arange(n, device=device, dtype=torch.float32)
    cy = 120.0 + (i % 16 - 8.0) * 3.0
    cx = 160.0 + (torch.div(i, 16, rounding_mode="floor") % 16 - 8.0) * 3.0
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    r = torch.sqrt((yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2) * 0.059
    z = torch.where(r < 4.0, 4.0 - torch.sqrt(torch.clamp(16.0 - r * r, min=0.0)), 4.0)
    press = 0.0012 + 0.0001 * (i % 5)
    return 0.0285 + (z - z.amin(dim=(-2, -1), keepdim=True)) / 1000.0 - press[:, None, None]


def _sensor_frame(sensor, out):
    """The sensor frame's pyramid inputs and LUT gradients and bins."""
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    shifted = optical.shift_height_map(out["height_map"], out["indentation_depth"])
    joined, mask, sigmas = optical.deformation_inputs(sensor.calib, shifted)
    return (joined.contiguous(), mask.contiguous(), sigmas), *_optical_bins(sensor.calib, shifted)


def sensor_phase(device) -> dict:
    """The default GelSight Mini sensor (320x240 Taxim + FOTS) on 256 envs:
    one update counted, its time, and 2 envs held to the CPU's."""
    from _torch_bins import NOISE_FLOOR, assert_bin_rule, bin_coords, lut_spread
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg

    cfg = gelsight_mini_cfg()
    sensor = GelSightSensor(cfg, num_envs=SENSOR_ENVS, device=device)
    depth = _press_depth(SENSOR_ENVS, device)
    state, out = sensor.update(sensor.init_state(), depth)
    torch.cuda.synchronize()
    _reset_counters()
    state, out = sensor.update(state, depth)
    launches = _read_counters()
    torch.cuda.synchronize()
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched by the 320x240 sensor update")
    rgb = out["tactile_rgb"]
    if tuple(rgb.shape) != (SENSOR_ENVS, 240, 320, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"tactile_rgb {tuple(rgb.shape)} is not a finite (256, 240, 320, 3) image")
    if not bool((out["indentation_depth"] > 0).all()):
        raise AssertionError("an env of the sensor phase does not press the gel")
    t0 = time.perf_counter()
    for _ in range(10):
        sensor.update(state, depth)
    torch.cuda.synchronize()
    update_ms = 1e3 * (time.perf_counter() - t0) / 10

    # 2 envs through the plain versions on the CPU, from the same state
    cpu = GelSightSensor(cfg, num_envs=2, device="cpu")
    st_c, out_c = cpu.update(cpu.init_state(), depth[:2].cpu())
    st_c, out_c = cpu.update(st_c, depth[:2].cpu())
    d_ind = float((out["indentation_depth"][:2].cpu() - out_c["indentation_depth"]).abs().max())
    d_mark = float((out["marker_motion"][:2].cpu() - out_c["marker_motion"]).abs().max())
    frame, _, _, bins_g = _sensor_frame(sensor, out)
    _, gm_c, gd_c, bins_c = _sensor_frame(cpu, out_c)
    nb = cpu.calib.sensor_params.num_bins
    spread = lut_spread(cpu.calib.poly_lut.numpy(), cpu.calib.features.numpy(), nb)
    # the two devices round the depth's m -> mm -> m arithmetic differently,
    # so indentation, and with it the pyramid's input, differs by one f32
    # step of the 0.0285 m depth (~2e-6 mm); gradients within EDGE_BINS of
    # an edge may then switch bins (the kernels themselves are held to their
    # plain versions on this frame in the kernel phase)
    bt, bc = [b[:2].cpu().numpy() for b in bins_g], [b.numpy() for b in bins_c]
    held = assert_bin_rule(rgb[:2].cpu().numpy(), out_c["tactile_rgb"].numpy(), gm_c.numpy(), gd_c.numpy(), nb,
                           spread, bins_t=bt, bins_j=bc, edge_bins=EDGE_BINS)
    t_mag, t_dir = bin_coords(gm_c.numpy(), gd_c.numpy(), nb)
    edge = np.minimum(np.abs(t_mag - np.round(t_mag)), np.abs(t_dir - np.round(t_dir)))
    moved = ((bt[0] != bc[0]) | (bt[1] != bc[1])) & (np.tan(gm_c.numpy().astype(np.float64)) >= NOISE_FLOOR)
    worst_edge = float(edge[moved].max(initial=0.0))
    print(f"sensor: default GelSight Mini 320x240 Taxim + FOTS, {SENSOR_ENVS} envs: {update_ms:.3f} ms per update "
          "(host clock over 10 updates, synchronised); "
          f"launches {launches}; cuda vs cpu (2 envs): indentation {d_ind:.2e} mm, markers {d_mark:.2e} px, "
          f"{held:.4f} of pixels held to 1e-4 under the bin rule; {int(moved.sum())} pixels above the noise floor "
          f"take another bin, the farthest {worst_edge:.2e} bins from an edge (margin {EDGE_BINS})")
    if not (d_ind <= 1e-3 and d_mark <= 1e-3):
        raise AssertionError("the card's 320x240 sensor update disagrees with the CPU's")
    idx_mag, idx_dir = bins_g
    lut = ((idx_mag * nb + idx_dir).reshape(SENSOR_ENVS, -1).contiguous(), sensor.calib.features,
           sensor.calib.poly_lut.reshape(nb * nb, 18))

    # the sensor's frame rendered with the bf16 table (K2's bf16 entry, counted)
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    shifted = optical.shift_height_map(out["height_map"], out["indentation_depth"])
    _reset_counters()
    rgb_bf16 = optical.render(sensor.calib, shifted, lut_dtype=torch.bfloat16)
    bf16 = _bf16_launches()
    d_bf16 = float((rgb_bf16 - optical.render(sensor.calib, shifted)).abs().max())
    print(f"sensor: render(lut_dtype=bfloat16) at 320x240 on {SENSOR_ENVS} envs: launches {bf16}, "
          f"{d_bf16:.4f} from the f32 table's image")
    if bf16["lut_shade_bf16"] != 1 or not 0.0 < d_bf16 < 0.05:
        raise AssertionError(f"render(lut_dtype=bfloat16): launches {bf16}, {d_bf16} from the f32 image")
    return dict(launches=launches, update_ms=update_ms, frame=frame, lut=lut, worst_edge_bins=worst_edge,
                bf16_launches=bf16)


def calib_frame_phase(device) -> dict:
    """The sensor at the calibration's own 640x480 frame on CALIB_ENVS envs
    (the 320x240 press resampled): one update counted, K1 taking it through
    its global-memory design (no cluster holds the 117-tap first level's
    halo), and K1 held to its plain version on the frame."""
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg

    sensor = GelSightSensor(gelsight_mini_cfg(camera_resolution=(640, 480), tactile_img_res=(640, 480)),
                            num_envs=CALIB_ENVS, device=device)
    depth = torch.nn.functional.interpolate(_press_depth(CALIB_ENVS, device)[:, None], size=(480, 640),
                                            mode="bilinear", align_corners=False)[:, 0].contiguous()
    state, out = sensor.update(sensor.init_state(), depth)
    torch.cuda.synchronize()
    _reset_counters()
    state, out = sensor.update(state, depth)
    launches = _read_counters()
    torch.cuda.synchronize()
    if launches["deformation_pyramid"] != 1:
        raise AssertionError(f"the 640x480 sensor update launched K1 {launches['deformation_pyramid']} times, not once")
    rgb = out["tactile_rgb"]
    if tuple(rgb.shape) != (CALIB_ENVS, 480, 640, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"tactile_rgb {tuple(rgb.shape)} is not a finite ({CALIB_ENVS}, 480, 640, 3) image")
    t0 = time.perf_counter()
    for _ in range(5):
        sensor.update(state, depth)
    torch.cuda.synchronize()
    update_ms = 1e3 * (time.perf_counter() - t0) / 5
    frame, _, _, _ = _sensor_frame(sensor, out)
    entries = {"pyramid global 480x640": _pyramid_entry(f"{CALIB_ENVS}x480x640", *frame, "global")}
    print(f"calibration frame: GelSight Mini at 640x480, {CALIB_ENVS} envs: {update_ms:.3f} ms per update "
          f"(host clock over 5, synchronised), launches {launches}")
    _print_entries(entries)
    return dict(launches=launches, update_ms=update_ms, kernels=entries)


def _policy_action(policy, obs):
    with torch.no_grad():
        mean, _, _ = policy(obs)
    action = mean.clone()
    action[:, 2] -= 0.1
    return action


def _tensors(x, prefix=""):
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), f"{prefix}{f.name}.")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), x


def _check_finite(tag, tree) -> None:
    for name, t in _tensors(tree):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{tag}: {name} is not finite")


def slice_phase(env, state, obs, policy) -> dict:
    """The main path: policy forward + env step. The counted steps run under
    sync-debug 'error' with the launch counters reset just before; the timed
    steps follow with the debug mode off."""
    for _ in range(WARMUP_STEPS):
        state, obs, *_ = env.step(state, _policy_action(policy, obs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEPS):
            state, obs, reward, term, trunc, info = env.step(state, _policy_action(policy, obs))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = _read_counters()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    _check_finite("slice", {"state": state, "obs": obs, "reward": reward, "indentation_depth": info["indentation_depth"]})
    n = env.cfg.num_envs
    vh, vw, vc = env.cfg.vision_obs_shape
    if tuple(obs["vision_obs"].shape) != (n, vh, vw, vc) or tuple(obs["proprio_obs"].shape) != (n, 14):
        raise AssertionError(f"obs shapes {obs['vision_obs'].shape}, {obs['proprio_obs'].shape}")
    pressed = int((info["indentation_depth"] > 0).sum())
    if pressed == 0:
        raise AssertionError("no env presses the gel on the last step")
    for name, count in launches.items():
        if count < STEPS:
            raise AssertionError(f"{name} launched {count} times in {STEPS} steps")

    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, obs, *_ = env.step(state, _policy_action(policy, obs))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = n * STEPS / dt
    print(f"slice: {n} envs, {STEPS} steps with no host sync; {pressed} envs pressed on the last step; "
          f"launches {launches}; peak memory {peak_gb:.3f} GB")
    print(f"slice: {STEPS} timed steps in {dt:.4f} s = {1e3 * dt / STEPS:.2f} ms/step = {rate:.1f} env-steps/s "
          "(policy forward + env step)")
    return dict(launches=launches, env_steps_per_s=rate, step_ms=1e3 * dt / STEPS, peak_gb=peak_gb)


def reference_phase(device) -> None:
    """8 envs stepped on the card and on the CPU from one state: the CPU path
    runs the plain versions the CPU tests hold to the JAX package."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.envs.ball_rolling.env import BallRollingEnvCfg

    events = {**BallRollingEnvCfg().events_cfg, "enabled": False}
    kw = dict(num_envs=8, action_noise=0.0, obs_noise_std=0.0, events_cfg=events)
    gpu, cpu = envs.make(ENV_ID, device=device, **kw), envs.make(ENV_ID, device="cpu", **kw)
    st_g, _ = gpu.reset_all(gpu.init_state())
    # goals near the ball: no env may finish, so no reset draws random numbers
    st_g = dataclasses.replace(st_g, goal_pos=st_g.ball_pos[:, :2] + 0.05)
    st_c = _state_to(st_g, "cpu")
    actions = torch.rand((3, 8, 6), generator=torch.Generator().manual_seed(1)) * 0.04 - 0.02
    actions[..., 2] -= 0.05
    for a in actions:
        st_g, obs_g, rew_g, term_g, trunc_g, info_g = gpu.step(st_g, a.to(device))
        st_c, obs_c, rew_c, term_c, trunc_c, info_c = cpu.step(st_c, a)
        if bool((term_c | trunc_c).any()) or not torch.equal(term_g.cpu(), term_c):
            raise AssertionError("an env finished in the reference steps")
        d_prop = float((obs_g["proprio_obs"].cpu() - obs_c["proprio_obs"]).abs().max())
        d_ind = float((info_g["indentation_depth"].cpu() - info_c["indentation_depth"]).abs().max())
        d_rew = float((rew_g.cpu() - rew_c).abs().max())
        d_vis = (obs_g["vision_obs"].cpu() - obs_c["vision_obs"]).abs()
        near = float((d_vis.amax(-1) <= 1e-4).float().mean())
        print(f"reference (cuda vs cpu, 8 envs): proprio {d_prop:.2e} indentation {d_ind:.2e} mm "
              f"reward {d_rew:.2e} vision max {float(d_vis.max()):.3e} mean {float(d_vis.mean()):.3e}, "
              f"{near:.3f} of pixels within 1e-4")
        # bounds: the f32 noise of the 0.35 m world pose (tests/test_torch_env.py);
        # a pixel whose gradient lies at the noise floor or near a LUT bin edge
        # may take another LUT row, so the image is held by its share of
        # pixels that agree, not by its largest difference
        if not (d_prop <= 1e-4 and d_ind <= 1e-3 and d_rew <= 1e-4 and near >= 0.9):
            raise AssertionError("the card's env step disagrees with the CPU's")
    rollout_reference(device, kw, actions[0])
    shared_trunk_reference(device)


def rollout_reference(device, kw, action) -> None:
    """``DirectRLEnv.rollout``: ROLLOUT_STEPS steps of the flagship at
    NUM_ENVS envs under sync-debug "error" (K1 and K2 once a step), its
    first ROLLOUT_CPU_ENVS envs held to the same rollout on the CPU (the
    envs are independent, and this config draws nothing that counts)."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.parallel import mesh

    kw = {**kw, "num_envs": NUM_ENVS}
    gpu = envs.make(ENV_ID, device=device, **kw)
    st, _ = gpu.reset_all(gpu.init_state())
    st = dataclasses.replace(st, goal_pos=st.ball_pos[:, :2] + 0.05)
    actions = action.to(device).repeat(NUM_ENVS // action.shape[0], 1).expand(ROLLOUT_STEPS, NUM_ENVS, -1).contiguous()
    gpu.rollout(st, actions)  # warm
    torch.cuda.synchronize()
    _reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        end, (obs, rew, term, trunc) = gpu.rollout(st, actions)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = _read_counters()
    if any(count != ROLLOUT_STEPS for count in launches.values()):
        raise AssertionError(f"rollout: launches {launches}, expected {ROLLOUT_STEPS} each")
    if tuple(rew.shape) != (ROLLOUT_STEPS, NUM_ENVS) or tuple(obs["vision_obs"].shape[:2]) != (ROLLOUT_STEPS, NUM_ENVS):
        raise AssertionError(f"rollout: reward {tuple(rew.shape)}, vision {tuple(obs['vision_obs'].shape)}")
    _check_finite("rollout", {"state": end, "obs": obs, "reward": rew})
    m = ROLLOUT_CPU_ENVS
    cpu = envs.make(ENV_ID, device="cpu", **{**kw, "num_envs": m})
    sub = mesh.slice_envs(_state_to(st, "cpu"), 0, m, NUM_ENVS)
    end_c, (obs_c, rew_c, term_c, trunc_c) = cpu.rollout(sub, actions[:, :m].cpu())
    if bool((term_c | trunc_c).any()) or not torch.equal(term[:, :m].cpu(), term_c):
        raise AssertionError("an env finished in the rollout's CPU slice")
    d_prop = float((obs["proprio_obs"][:, :m].cpu() - obs_c["proprio_obs"]).abs().max())
    d_rew = float((rew[:, :m].cpu() - rew_c).abs().max())
    near = float(((obs["vision_obs"][:, :m].cpu() - obs_c["vision_obs"]).abs().amax(-1) <= 1e-4).float().mean())
    print(f"rollout: {ROLLOUT_STEPS} steps at {NUM_ENVS} envs with no host sync, launches {launches}; envs 0-{m - 1} "
          f"cuda vs cpu: proprio {d_prop:.2e} reward {d_rew:.2e}, {near:.3f} of pixels within 1e-4")
    if not (d_prop <= 1e-4 and d_rew <= 1e-4 and near >= 0.9):  # the reference steps' bounds
        raise AssertionError("the card's rollout disagrees with the CPU's")


def shared_trunk_reference(device) -> None:
    """``ActorCritic(shared_trunk=True)`` on the flagship's observation
    shapes: one forward on the card held to the same weights on the CPU."""
    from tacex_tpu_torch.rl.networks import ActorCritic

    net = ActorCritic(14, (24, 32, 3), 6, shared_trunk=True, device=device).init_(
        torch.Generator(device=device).manual_seed(3))
    cpu = ActorCritic(14, (24, 32, 3), 6, shared_trunk=True, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    g = torch.Generator().manual_seed(4)
    obs = {"proprio_obs": torch.randn((256, 14), generator=g), "vision_obs": torch.rand((256, 24, 32, 3), generator=g)}
    with torch.no_grad():
        out_g = net({k: v.to(device) for k, v in obs.items()})
        out_c = cpu(obs)
    d = max(float((a.cpu() - b).abs().max()) for a, b in zip(out_g, out_c))
    print(f"shared trunk: ActorCritic(shared_trunk=True) forward on 256 flagship observations, cuda vs cpu {d:.2e} "
          "(atol 1e-5)")
    if not d <= 1e-5:
        raise AssertionError(f"the shared-trunk forward disagrees with the CPU's by {d}")


def _event_timed(fn, spans: list):
    """``fn`` with a pair of CUDA events recorded around each call."""
    def wrapped(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    return wrapped


def train_phase(device) -> dict:
    """PPO on the flagship at full width: the trainer a user would launch
    with ``scripts/train_torch.py``, through ``PPO.train_step``."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl import PPO
    from tacex_tpu_torch.rl.agents import agent_cfg_for

    cfg = agent_cfg_for(ENV_ID, "ppo")
    env = envs.make(ENV_ID, num_envs=NUM_ENVS, device=device)
    ppo = PPO(env, cfg)
    ppo.init(0)
    before = [p.detach().clone() for p in ppo.params]
    rollouts, updates = [], []
    ppo.rollout, ppo.update = _event_timed(ppo.rollout, rollouts), _event_timed(ppo.update, updates)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    seconds = []
    for it in range(TRAIN_ITERATIONS):
        guarded = it == TRAIN_ITERATIONS - 1
        t0 = time.perf_counter()
        if guarded:
            torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = ppo.train_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = _read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = {k: float(v) for k, v in metrics.items()}

    steps_per_iter = cfg.rollouts * NUM_ENVS
    for name in ("loss", "reward_per_step"):
        if not np.isfinite(metrics[name]):
            raise AssertionError(f"train: {name} is {metrics[name]}")
    if not all(bool((a != b).any()) for a, b in zip(ppo.params, before)):
        raise AssertionError("train: a parameter tensor did not change")
    if ppo.steps != TRAIN_ITERATIONS * steps_per_iter:
        raise AssertionError(f"train: {ppo.steps} env steps, expected {TRAIN_ITERATIONS * steps_per_iter}")
    if not cfg.lr_min <= metrics["lr"] <= cfg.lr_max:
        raise AssertionError(f"train: lr {metrics['lr']} outside [{cfg.lr_min}, {cfg.lr_max}]")
    for name, count in launches.items():
        if count != TRAIN_ITERATIONS * cfg.rollouts:
            raise AssertionError(f"train: {name} launched {count} times, expected {TRAIN_ITERATIONS * cfg.rollouts}")

    rollout_s = [s.elapsed_time(e) / 1e3 for s, e in rollouts]
    update_s = [s.elapsed_time(e) / 1e3 for s, e in updates]
    timed = seconds[1:]
    sec_per_iter = sum(timed) / len(timed)
    mb = steps_per_iter // cfg.mini_batches
    print(f"train: {ENV_ID}, {NUM_ENVS} envs, rollouts {cfg.rollouts}, {cfg.learning_epochs} epochs x "
          f"{cfg.mini_batches} minibatches of {mb}, hidden {tuple(cfg.hidden)}; iterations (s): "
          f"{[round(x, 3) for x in seconds]} (first is the warm-up, last ran with no host sync)")
    print(f"train: {sec_per_iter:.3f} s/iteration = {steps_per_iter / sec_per_iter:.1f} env-steps/s; rollout "
          f"{[round(x, 3) for x in rollout_s]} s, update {[round(x, 3) for x in update_s]} s (CUDA events); "
          f"launches {launches}; peak memory {peak_gb:.3f} GB; loss {metrics['loss']:.5f}, "
          f"reward/step {metrics['reward_per_step']:.5f}, lr {metrics['lr']:.3e}")
    return dict(launches=launches, sec_per_iter=sec_per_iter, env_steps_per_s=steps_per_iter / sec_per_iter,
                rollout_s=sum(rollout_s[1:]) / len(timed), update_s=sum(update_s[1:]) / len(timed), peak_gb=peak_gb)


def privileged_train_phase(device) -> dict:
    """PPO on the privileged (state-vector) task at 4096 envs: learning is
    asserted by the CPU tests under a fixed seed, here only that it runs,
    stays finite and moves its parameters."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl import PPO
    from tacex_tpu_torch.rl.agents import agent_cfg_for

    cfg = agent_cfg_for(PRIVILEGED_ID, "ppo")
    ppo = PPO(envs.make(PRIVILEGED_ID, num_envs=NUM_ENVS, device=device), cfg)
    ppo.init(0)
    before = [p.detach().clone() for p in ppo.params]
    torch.cuda.synchronize()
    rewards, t0 = [], time.perf_counter()
    for _ in range(PRIVILEGED_ITERATIONS):
        metrics = ppo.train_step()
        rewards.append(float(metrics["reward_per_step"]))
    dt = time.perf_counter() - t0
    if not (np.isfinite(rewards).all() and np.isfinite(float(metrics["loss"]))):
        raise AssertionError(f"privileged train: rewards {rewards}, loss {float(metrics['loss'])}")
    if not all(bool((a != b).any()) for a, b in zip(ppo.params, before)):
        raise AssertionError("privileged train: a parameter tensor did not change")
    sec = dt / PRIVILEGED_ITERATIONS
    print(f"privileged train: {PRIVILEGED_ID}, {NUM_ENVS} envs, rollouts {cfg.rollouts}, {cfg.learning_epochs} epochs x "
          f"{cfg.mini_batches} minibatches: {sec:.3f} s/iteration = {cfg.rollouts * NUM_ENVS / sec:.1f} env-steps/s; "
          f"reward/step by iteration {[round(r, 4) for r in rewards]}")
    return dict(sec_per_iter=sec, rewards=rewards)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ppo_snapshot(ppo) -> dict:
    """What a PPO iteration starts from, copied: the network, Adam's moments
    and count, the learning rate, the value scaler, the env state and
    observation, and the trainer's and the env's generators."""
    clone = lambda t: t.detach().clone()  # noqa: E731
    return dict(net={k: clone(v) for k, v in ppo.net.state_dict().items()}, adam_m=[clone(m) for m in ppo.adam_m],
                adam_v=[clone(v) for v in ppo.adam_v], adam_count=ppo.adam_count, lr=clone(ppo.lr),
                value_scaler=ppo.value_scaler, env_state=_state_clone(ppo.env_state),
                obs={k: clone(v) for k, v in ppo.obs.items()}, generator=ppo.generator.get_state(),
                env_generator=ppo.env.generator.get_state(), steps=ppo.steps)


def _ppo_restore(ppo, snap: dict) -> None:
    """Put an initialised PPO at ``snap``."""
    ppo.net.load_state_dict(snap["net"])
    for mine, theirs in ((ppo.adam_m, snap["adam_m"]), (ppo.adam_v, snap["adam_v"])):
        for a, b in zip(mine, theirs):
            a.copy_(b)
    ppo.adam_count, ppo.lr, ppo.value_scaler = snap["adam_count"], snap["lr"].clone(), snap["value_scaler"]
    ppo.env_state, ppo.obs = _state_clone(snap["env_state"]), {k: v.clone() for k, v in snap["obs"].items()}
    ppo.generator.set_state(snap["generator"])
    ppo.env.generator.set_state(snap["env_generator"])
    ppo.steps = snap["steps"]


def _state_clone(state):
    if dataclasses.is_dataclass(state):
        return type(state)(**{f.name: _state_clone(getattr(state, f.name)) for f in dataclasses.fields(state)})
    return state.clone()


def _relative(a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors."""
    num = sum(float(((x.detach() - y.detach()).double() ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y.detach().double() ** 2).sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def _minibatch_check(sharded, plain, flat, perm, group) -> dict:
    """Each minibatch of one epoch of ``perm`` at the sharded PPO's network:
    its ``minibatch_grads`` (the rank's rows, each term over the minibatch
    size, the flat all-reduce) against the plain PPO's ``autograd.grad`` of
    ``loss`` on the same rows, at the same network; the plain gradient taken
    twice gives the card's own run-to-run spread. At world size 1 the
    rank's ``flat`` is the whole trajectory, which the plain rows index."""
    from tacex_tpu_torch.parallel import mesh

    assert group.world_size == 1
    plain.net.load_state_dict(sharded.net.state_dict())
    total = flat[1].shape[0]
    n_mb = min(sharded.cfg.mini_batches, total)
    mb = total // n_mb
    rows = mesh.local_minibatch_rows(perm[None], n_mb, mb, group, sharded.device)[0]
    obs, *rest = flat
    worst = dict(grad=0.0, loss=0.0, kl=0.0, spread=0.0)
    for i, local in enumerate(rows):
        grads, loss, kl = sharded.minibatch_grads(flat, local, mb)
        idx = perm[i * mb : (i + 1) * mb].to(sharded.device)
        batch = ({k: v[idx] for k, v in obs.items()}, *(x[idx] for x in rest))
        refs = []
        for _ in range(2):
            ref_loss, (_, _, _, ref_kl) = plain.loss(batch)
            refs.append((torch.autograd.grad(ref_loss, plain.params), ref_loss.detach(), ref_kl.detach()))
        (g_ref, l_ref, k_ref), (g_again, _, _) = refs
        for key, d in (("grad", _relative(grads, g_ref)), ("loss", _relative([loss], [l_ref])),
                       ("kl", _relative([kl], [k_ref])), ("spread", _relative(g_again, g_ref))):
            worst[key] = max(worst[key], d)
    worst["minibatches"], worst["rows"] = n_mb, mb
    return worst


def parallel_phase(device) -> dict:
    """Env-axis data parallelism on the one card (NCCL refuses two ranks on
    one GPU): a 1-rank NCCL group in this process runs the flagship's PPO at
    NUM_ENVS envs under its tuned config through the sharded path (host
    permutations, the flattened-gradient all-reduce, the global curriculum,
    advantage and metric reductions), a warm iteration then one under
    sync-debug "error"; each minibatch of that iteration's first epoch held
    to the plain PPO's gradient of the same rows, and the whole iteration to
    the plain PPO's from the same state and the same permutations, within
    the spread of two plain iterations; the curriculum env stepped with its all-reduce under
    sync-debug "error"; one sharded SAC train step on the privileged task;
    then ``torchrun --nproc_per_node 1 scripts/train_torch.py --shard``."""
    import subprocess

    import torch.distributed as dist
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.parallel import close_env_parallel, init_env_parallel
    from tacex_tpu_torch.rl import PPO, SAC
    from tacex_tpu_torch.rl.agents import agent_cfg_for

    nccl = dist.is_nccl_available()
    print(f"parallel: torch.distributed {'has' if nccl else 'lacks'} NCCL")
    if not nccl:
        raise AssertionError("torch.distributed has no NCCL backend")
    # cuDNN's default convolution algorithms sum in an order that changes
    # from run to run: two plain iterations from one state parted by 4e-7 to
    # 5e-5 in the loss, a one-pair spread too noisy to bound the sharded
    # one by. With its deterministic algorithms the sharded and the plain
    # PPO, one arithmetic, are equal to the bit (measured on the card), so
    # the bounds below hold them to equality.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    group = init_env_parallel(NUM_ENVS, device, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    spans, all_reduce = [], dist.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):  # CUDA events around each all-reduce the port issues
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = all_reduce(tensor, *args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    dist.all_reduce = timed_all_reduce
    try:
        cfg = agent_cfg_for(ENV_ID, "ppo")
        sharded = PPO(envs.make(ENV_ID, num_envs=group.local_envs, device=group.device), cfg, group=group)
        sharded.init(0)
        perms, draw, kept, update = [], sharded.permutations, {}, sharded.update
        sharded.permutations = lambda total: perms.append(draw(total)) or perms[-1]
        sharded.update = lambda flat, p: kept.update(flat=flat) or update(flat, p)  # the last trajectory
        t0 = time.perf_counter()
        sharded.train_step()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        start = _ppo_snapshot(sharded)
        spans.clear()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = sharded.train_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        reduces, reduce_ms = len(spans), sum(a.elapsed_time(b) for a, b in spans)

        def plain_run():
            """The plain PPO's iteration from the sharded one's starting state."""
            plain = PPO(envs.make(ENV_ID, num_envs=NUM_ENVS, device=device), cfg)
            plain.init(0)
            _ppo_restore(plain, start)
            plain.permutations = lambda total: perms[-1].to(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(plain.train_step()["loss"])
            return plain, loss, time.perf_counter() - t0

        def gap(a, la, b, lb):
            d = max(float((x.detach() - y.detach()).abs().max()) for x, y in zip(a.params, b.params))
            return d, abs(la - lb) / max(abs(lb), 1e-12)

        plain, plain_loss, plain_s = plain_run()
        loss = float(metrics["loss"])
        d_param, d_loss = gap(sharded, loss, plain, plain_loss)
        again, again_loss, _ = plain_run()
        s_param, s_loss = gap(again, again_loss, plain, plain_loss)
        del again
        mbc = _minibatch_check(sharded, plain, kept.pop("flat"), perms[-1][0], group)
        grad_bound = max(PARALLEL_GRAD_RTOL, PARALLEL_SPREAD_FACTOR * mbc["spread"])
        print(f"parallel: PPO on {ENV_ID} at {NUM_ENVS} envs, 1-rank NCCL group: iteration {sharded_s:.3f} s "
              f"(warm-up {warm_s:.3f} s; under sync-debug \"error\"), plain PPO {plain_s:.3f} s; {reduces} all-reduces "
              f"an iteration, {reduce_ms:.3f} ms of device time (CUDA events)")
        print(f"parallel: the {mbc['minibatches']} minibatches of {mbc['rows']} rows of the iteration's first epoch at "
              f"its final network, the all-reduced gradient vs the plain PPO's autograd.grad of the same rows: "
              f"gradient {mbc['grad']:.3e}, loss {mbc['loss']:.3e}, KL {mbc['kl']:.3e} (relative, the largest over the "
              f"minibatches); two plain gradients part by {mbc['spread']:.3e} (bound {grad_bound:.3e}: the larger of "
              f"{PARALLEL_GRAD_RTOL:g} and {PARALLEL_SPREAD_FACTOR:g}x that)")
        print(f"parallel: the whole iteration vs the plain PPO's from the same state and permutations: parameters "
              f"{d_param:.3e}, loss {loss:.6f} vs {plain_loss:.6f} (rel {d_loss:.2e}); two plain iterations from that "
              f"state part by {s_param:.3e}, loss rel {s_loss:.2e} (bound {PARALLEL_SPREAD_FACTOR:g}x that)")
        if not (np.isfinite(loss) and all(mbc[k] <= grad_bound for k in ("grad", "loss", "kl"))):
            raise AssertionError("a minibatch of the 1-rank sharded PPO disagrees with the plain PPO's")
        if not (d_param <= PARALLEL_SPREAD_FACTOR * s_param and d_loss <= PARALLEL_SPREAD_FACTOR * s_loss):
            raise AssertionError("the 1-rank sharded PPO iteration parts from the plain PPO's beyond the card's "
                                 "run-to-run spread")
        if sharded.steps != 2 * cfg.rollouts * NUM_ENVS or plain.steps != sharded.steps:
            raise AssertionError(f"parallel: {sharded.steps} and {plain.steps} env steps")

        # the curriculum env steps with its all-reduce and no host sync
        env, state, obs = sharded.env, sharded.env_state, sharded.obs
        spans.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(PARALLEL_CURRICULUM_STEPS):
                state, obs, reward, *_ = env.step(state, sharded.act(obs))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        _check_finite("parallel curriculum", {"state": state, "reward": reward})
        if len(spans) != PARALLEL_CURRICULUM_STEPS:
            raise AssertionError(f"{len(spans)} all-reduces in {PARALLEL_CURRICULUM_STEPS} curriculum steps")
        print(f"parallel: {PARALLEL_CURRICULUM_STEPS} flagship steps under sync-debug \"error\", one all-reduce of "
              f"the curriculum's mean each ({sum(a.elapsed_time(b) for a, b in spans):.3f} ms of device time)")
        del sharded, plain, env, state, obs

        # one SAC train step (past the warm-up) on the privileged task
        sac_group = group.for_envs(PARALLEL_SAC_ENVS)
        sac_cfg = agent_cfg_for(PRIVILEGED_ID, "sac", warmup_steps=0)
        sac = SAC(envs.make(PRIVILEGED_ID, num_envs=sac_group.local_envs, device=device), sac_cfg, group=sac_group)
        sac.init(0)
        sac.train_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sac_metrics = sac.train_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sac_s = time.perf_counter() - t0
        sac_metrics = {k: float(v) for k, v in sac_metrics.items()}
        added = 2 * sac_cfg.rollout_steps * PARALLEL_SAC_ENVS
        if not all(np.isfinite(v) for v in sac_metrics.values()) or sac.buffer.size != min(added, sac_cfg.buffer_size):
            raise AssertionError(f"parallel SAC: metrics {sac_metrics}, buffer size {sac.buffer.size}")
        print(f"parallel: SAC on {PRIVILEGED_ID} at {PARALLEL_SAC_ENVS} envs, 1-rank group: a train step {sac_s:.3f} s "
              f"under sync-debug \"error\", buffer {sac.buffer.size} rows, critic loss {sac_metrics['critic_loss']:.4f}")
        del sac
    finally:
        dist.all_reduce = all_reduce
        close_env_parallel()
        torch.backends.cudnn.deterministic = deterministic

    # the launcher a user runs, in its own process (the kernels' library is built)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           str(REPO / "scripts" / "train_torch.py"), "--shard", "--iterations", str(PARALLEL_TORCHRUN_ITERATIONS),
           "--num_envs", str(PARALLEL_TORCHRUN_ENVS)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    torchrun_s = time.perf_counter() - t0
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    steps = PARALLEL_TORCHRUN_ITERATIONS * cfg.rollouts * PARALLEL_TORCHRUN_ENVS
    if out.returncode != 0 or [line["iter"] for line in lines] != list(range(PARALLEL_TORCHRUN_ITERATIONS)) \
            or lines[-1]["env_steps"] != steps:
        raise AssertionError(f"torchrun train_torch.py --shard: rc {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    print(f"parallel: {' '.join(cmd[1:])}: exit 0 in {torchrun_s:.1f} s, {len(lines)} JSON lines "
          f"(steps_per_sec {[line['steps_per_sec'] for line in lines]}), {lines[-1]['env_steps']} env steps")
    return dict(iteration_s=sharded_s, warmup_s=warm_s, plain_iteration_s=plain_s, all_reduces=reduces,
                all_reduce_ms=reduce_ms, minibatch=mbc, param_diff=d_param, loss_rel_diff=d_loss,
                plain_spread_param=s_param, plain_spread_loss_rel=s_loss, sac_step_s=sac_s,
                torchrun_s=torchrun_s, torchrun_steps_per_sec=[line["steps_per_sec"] for line in lines])


def env_phase(device) -> None:
    """The other five ball-rolling ids at 256 envs: ``reset_all`` and 5 steps
    with no host sync, observation shapes, and the IK resets against the same
    solve on the CPU."""
    from tacex_tpu_torch import envs

    for env_id, vision in OTHER_IDS.items():
        env = envs.make(env_id, num_envs=OTHER_ENVS, device=device)
        action = torch.zeros((OTHER_ENVS, env.cfg.action_space), device=device)
        action[:, 2] = -0.1
        state, obs = env.reset_all(env.init_state())
        env.step(state, action)  # the first call of each op may set up its library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, obs = env.reset_all(env.init_state())
            reset_state = state
            for _ in range(5):
                state, obs, reward, term, trunc, info = env.step(state, action)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        shapes = {k: tuple(v.shape) for k, v in obs.items()}
        expect = {"proprio_obs": (OTHER_ENVS, 14)}
        if vision is not None:
            expect["vision_obs"] = (OTHER_ENVS,) + vision
        if shapes != expect:
            raise AssertionError(f"{env_id}: obs shapes {shapes}, expected {expect}")
        _check_finite(env_id, {"state": state, "obs": obs, "reward": reward})
        line = f"env: {env_id}, {OTHER_ENVS} envs: reset_all + 5 steps with no host sync; obs {shapes}"
        if env.cfg.reset_mode != "default_joints":
            cpu = envs.make(env_id, num_envs=OTHER_ENVS, device="cpu")
            target = reset_state.ball_pos.cpu() + cpu._ik_reset_offset
            q_cpu = cpu._ik_reset_joints(cpu._q0.expand(OTHER_ENVS, 7), target)
            d_q = float((reset_state.arm.q.cpu() - q_cpu).abs().max())
            tool, _ = env._tool_pose(reset_state.arm.q)
            dist = float(torch.linalg.vector_norm(tool.cpu() - target, dim=-1).max())
            line += f"; IK reset ({env.cfg.reset_mode}): joints cuda vs cpu {d_q:.2e} rad, tool to target {dist:.2e} m"
            if not d_q <= 1e-4:
                raise AssertionError(f"{env_id}: the card's IK reset disagrees with the CPU's by {d_q} rad")
        print(line)


def _shading_frame(calib, shifted) -> dict:
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    deformed, mask = optical.compute_gel_deformation(calib, shifted)
    deformed_px = deformed / calib.sensor_params.pixmm
    grad_mag, grad_dir = optical.generate_normals(calib, -deformed_px)
    return dict(deformed_px=deformed_px, mask=mask, grad_mag=grad_mag, grad_dir=grad_dir,
                raw=optical.shade(calib, grad_mag, grad_dir), bins=optical.lut_bins(calib, grad_mag, grad_dir))


def _host_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def shading_phase(device) -> dict:
    """The shadow, bilinear and compact shading paths at 320x240 on 16 pressed
    envs, the card against the CPU from the same height maps."""
    from _torch_bins import assert_bin_rule, lut_spread
    from tacex_tpu_torch.ops import lut_shade as K2
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    n = SHADING_ENVS
    sensor = GelSightSensor(gelsight_mini_cfg(with_markers=False), num_envs=n, device=device)
    _, out = sensor.update(sensor.init_state(), _press_depth(n, device))
    shifted = optical.shift_height_map(out["height_map"], out["indentation_depth"])
    cal_g, cal_c = sensor.calib, sensor.calib.to("cpu")
    shifted_c = shifted.cpu()
    nb = cal_c.sensor_params.num_bins
    spread = lut_spread(cal_c.poly_lut.numpy(), cal_c.features.numpy(), nb)
    fg, fc = _shading_frame(cal_g, shifted), _shading_frame(cal_c, shifted_c)
    gm_c, gd_c = fc["grad_mag"].numpy(), fc["grad_dir"].numpy()
    bins_g, bins_c = [b.cpu().numpy() for b in fg["bins"]], [b.numpy() for b in fc["bins"]]
    rule = dict(bins_t=bins_g, bins_j=bins_c, edge_bins=EDGE_BINS)

    # shadow: the frames agree under the bin rule (the dense shade), and the
    # shadow stage on the card, given the CPU's frame, gives the CPU's image
    held = assert_bin_rule(fg["raw"].cpu().numpy(), fc["raw"].numpy(), gm_c, gd_c, nb, spread, **rule)
    stage = ("raw", "deformed_px", "mask", "grad_dir")
    shadow_c = optical.shadowed_image(cal_c, *(fc[k] for k in stage))
    shadow_g = optical.shadowed_image(cal_g, *(fc[k].to(device) for k in stage))
    d_stage = float((shadow_g.cpu() - shadow_c).abs().max())
    composite = optical._shadow_pass_compact(cal_c, *(fc[k] for k in stage))
    cast = float((composite != fc["raw"]).any(dim=-1).float().mean())
    img_g = optical.render(cal_g, shifted, with_shadow=True)
    img_c = optical.render(cal_c, shifted_c, with_shadow=True)
    d_img = (img_g.cpu() - img_c).abs()
    if not (bool(torch.isfinite(img_g).all()) and d_stage <= 1e-5 and cast > 0.001 and float(d_img.max()) <= spread + 1e-4):
        raise AssertionError(f"shadow: stage {d_stage}, shadowed share {cast}, image max {float(d_img.max())}")
    shadow_ms = _host_ms(lambda: optical.render(cal_g, shifted, with_shadow=True))
    dense_ms = _host_ms(lambda: optical.render(cal_g, shifted))
    print(f"shading: 320x240, {n} envs; dense frame cuda vs cpu: {held:.4f} of pixels held to 1e-4 under the bin "
          f"rule; shadow stage on the CPU's frame, cuda vs cpu: {d_stage:.2e} (atol 1e-5), {cast:.4f} of pixels "
          f"darkened by a cast shadow; render(with_shadow=True) cuda vs cpu: mean {float(d_img.mean()):.2e}, "
          f"max {float(d_img.max()):.3e} (LUT spread {spread:.3f}); {shadow_ms:.3f} ms per render, "
          f"dense render {dense_ms:.3f} ms")

    # bilinear: continuous in the gradients, so the CPU's gradients on both
    bil_c = optical.shade(cal_c, fc["grad_mag"], fc["grad_dir"], interp="bilinear")
    bil_g = optical.shade(cal_g, fc["grad_mag"].to(device), fc["grad_dir"].to(device), interp="bilinear")
    d_bil = float((bil_g.cpu() - bil_c).abs().max())
    if not d_bil <= 1e-5:
        raise AssertionError(f"bilinear shade: cuda vs cpu {d_bil}")
    bil_ms = _host_ms(lambda: optical.shade(cal_g, fg["grad_mag"], fg["grad_dir"], interp="bilinear"))
    print(f"shading: shade(interp='bilinear') cuda vs cpu {d_bil:.2e} (atol 1e-5); {bil_ms:.3f} ms per call")

    # compact: K2 over the 125-row subtable, then the 16,384 highest-numbered
    # contact pixels from the full table. A contact of this size overflows
    # the capacity, so a pixel is covered on both devices only if both count
    # the same contact pixels above it: the others are set aside.
    _reset_counters()
    comp_g = optical.render(cal_g, shifted, compact_capacity=COMPACT_CAPACITY)
    compact_launches = _read_counters()
    if compact_launches["lut_shade"] != 2:
        raise AssertionError("the compact shade path did not launch the shading kernel twice (halo, contact rows)")
    comp_c = optical.render(cal_c, shifted_c, compact_capacity=COMPACT_CAPACITY)

    def covered(idx_mag):
        contact = torch.as_tensor(idx_mag >= 1).reshape(n, -1)
        above = contact.flip(1).cumsum(1).flip(1)  # contact pixels at or above each pixel
        return (contact & (above <= COMPACT_CAPACITY)).reshape(idx_mag.shape).numpy()

    cov_g, cov_c = covered(bins_g[0]), covered(bins_c[0])
    aside = cov_g != cov_c
    contact_px = int((bins_c[0] >= 1).reshape(n, -1).sum(1).max())
    rgb_g = np.where(aside[..., None], comp_c.numpy(), comp_g.cpu().numpy())
    held_c = assert_bin_rule(rgb_g, comp_c.numpy(), gm_c, gd_c, nb, spread, **rule)
    if aside.mean() > 0.01:
        raise AssertionError(f"compact: {aside.mean():.4f} of pixels are covered on one device only")
    full_g = optical.shade(cal_g, fg["grad_mag"], fg["grad_dir"], compact_capacity=240 * 320)
    d_full = float((full_g - fg["raw"]).abs().max())
    if not d_full <= 1e-5:
        raise AssertionError(f"compact shade at full capacity differs from the dense shade by {d_full}")
    comp_ms = _host_ms(lambda: optical.render(cal_g, shifted, compact_capacity=COMPACT_CAPACITY))
    print(f"shading: render(compact_capacity={COMPACT_CAPACITY}) cuda vs cpu: {held_c:.4f} of pixels held to 1e-4 "
          f"under the bin rule, {int(aside.sum())} pixels covered on one device only set aside (up to {contact_px} "
          f"contact pixels an env, over the capacity); at capacity h*w it equals the dense shade to {d_full:.2e}; "
          f"{comp_ms:.3f} ms per render")

    # the bf16 table: the dense render cuda vs cpu under the bin rule, and
    # the compact render counted (the halo on the f32 subtable, the contact
    # rows through K2's bf16 entry), that entry held to its plain version
    bf_g = optical.render(cal_g, shifted, lut_dtype=torch.bfloat16)
    bf_c = optical.render(cal_c, shifted_c, lut_dtype=torch.bfloat16)
    held_bf = assert_bin_rule(bf_g.cpu().numpy(), bf_c.numpy(), gm_c, gd_c, nb, spread, **rule)
    _reset_counters()
    optical.render(cal_g, shifted, compact_capacity=COMPACT_CAPACITY, lut_dtype=torch.bfloat16)
    compact_bf16 = {**_read_counters(), **_bf16_launches()}
    if compact_bf16["lut_shade"] != 1 or compact_bf16["lut_shade_bf16"] != 1:
        raise AssertionError(f"render(compact_capacity, lut_dtype=bfloat16) launches {compact_bf16}")
    _, rows, feats = optical.compact_rows(cal_g, *(b for b in fg["bins"]), COMPACT_CAPACITY)
    table = cal_g.poly_lut.reshape(nb * nb, 18).to(torch.bfloat16)
    compact_entry = {"lut bf16 compact contact rows": _lut_entry(f"{tuple(rows.shape)} bf16 compact", rows, feats, table)}
    print(f"shading: render(lut_dtype=bfloat16) cuda vs cpu: {held_bf:.4f} of pixels held to 1e-4 under the bin "
          f"rule; compact render with the bf16 table launches {compact_bf16}")

    # the original Taxim height-map format: gel_map_shift - hm, on both devices
    orig = cal_g.gel_map_shift - shifted
    back = cal_g.gel_map_shift - orig
    orig_g = optical.render(cal_g, orig, orig_hm_fmt=True)
    orig_c = optical.render(cal_c, orig.cpu(), orig_hm_fmt=True)
    if not torch.equal(orig_g, optical.render(cal_g, back)):
        raise AssertionError("render(orig_hm_fmt=True) is not the render of the processed map it stands for")
    fb_g, fb_c = _shading_frame(cal_g, back), _shading_frame(cal_c, back.cpu())
    held_o = assert_bin_rule(orig_g.cpu().numpy(), orig_c.numpy(), fb_c["grad_mag"].numpy(), fb_c["grad_dir"].numpy(),
                             nb, spread, bins_t=[b.cpu().numpy() for b in fb_g["bins"]],
                             bins_j=[b.numpy() for b in fb_c["bins"]], edge_bins=EDGE_BINS)
    print(f"shading: render(orig_hm_fmt=True) at 320x240 on {n} envs cuda vs cpu: {held_o:.4f} of pixels held to "
          "1e-4 under the bin rule; equal to the render of gel_map_shift - (gel_map_shift - hm)")

    # K1 differentiates on the card (the grad phase holds its backward kernel); K2 has no backward kernel
    feats = torch.zeros((6, 8), device=device, requires_grad=True)
    try:
        K2.lut_shade(torch.zeros((1, 8), dtype=torch.int32, device=device), feats, torch.zeros((5, 18), device=device))
    except RuntimeError as err:
        if "no backward kernel" not in str(err):
            raise
    else:
        raise AssertionError("lut_shade took a CUDA input that requires grad")
    return dict(shadow_ms=shadow_ms, dense_ms=dense_ms, bilinear_ms=bil_ms, compact_ms=comp_ms,
                compact_launches=compact_launches, compact_bf16=compact_bf16, kernels=compact_entry)


def _factory_action(n: int, device) -> torch.Tensor:
    """A steady push down with a small, seeded sideways wobble."""
    g = torch.Generator(device=device).manual_seed(3)
    action = (torch.rand((n, 6), generator=g, device=device) - 0.5) * 0.4
    action[:, 2] = -0.5
    return action


def _launch_count(fn) -> tuple[int, float]:
    """CUDA device activities (kernels, memsets, copies) of one call of
    ``fn`` and their summed device time in ms (torch.profiler). They are
    read from the profiler's raw events: ``prof.events()`` gives the same
    count and time but builds a Python object an event, ~70 s for the
    ~0.5M activities of a CG step of the ABD pile (measured on the card)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    return len(device), sum(e.duration_ns() for e in device) / 1e6


def factory_phase(device) -> dict:
    """The three Factory tasks at their default 128 envs: reset, a warm-up
    step, then FACTORY_STEPS steps with no host sync, each launching K1 and
    K2 exactly once on the 2N = 256 finger images; then K1 (warp design,
    32x32) and K2 on PegInsert's frame against their plain versions, and one
    PegInsert step on the card against the CPU from the same state."""
    from tacex_tpu_torch import envs

    out = {"steps": {}}
    for env_id in FACTORY_IDS:
        env = envs.make(env_id, device=device)
        n = env.cfg.num_envs
        action = _factory_action(n, device)
        state, obs = env.reset_all(env.init_state())
        state, obs, *_ = env.step(state, action)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            for _ in range(FACTORY_STEPS):
                state, obs, reward, term, trunc, info = env.step(state, action)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / FACTORY_STEPS
        launches = _read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if launches != {"deformation_pyramid": FACTORY_STEPS, "lut_shade": FACTORY_STEPS}:
            raise AssertionError(f"{env_id}: kernel launches {launches} in {FACTORY_STEPS} steps, expected one each a step")
        _check_finite(env_id, {"state": state, "obs": obs, "reward": reward, "log": info["log"]})
        shapes = {k: tuple(v.shape) for k, v in obs.items()}
        if shapes != {"proprio_obs": (n, 19), "vision_obs": (n, 32, 32, 6)}:
            raise AssertionError(f"{env_id}: obs shapes {shapes}")
        kernels, device_ms = _launch_count(lambda: env.step(state, action))
        log = {k: float(v) for k, v in info["log"].items()}
        print(f"factory: {env_id}, {n} envs, {FACTORY_STEPS} steps with no host sync: {step_ms:.3f} ms/step "
              f"(host clock, synchronised), {kernels} CUDA kernels a step taking {device_ms:.3f} ms of device time "
              f"(torch.profiler), K1/K2 launches {launches}, peak memory {peak_gb:.3f} GB; log {log}")
        out["steps"][env_id] = dict(step_ms=step_ms, kernels_per_step=kernels, device_ms_per_step=device_ms,
                                    launches=launches, peak_gb=peak_gb)
        if env_id == FACTORY_IDS[0]:
            out["launches"] = launches
            out["kernels"] = _factory_kernels(env, state)
            out["reference"] = _factory_reference(env, state, action)
        del env, state, obs
    return out


def _factory_kernels(env, state) -> dict:
    """K1 and K2 on the Factory frame of ``state``: the 2N finger images."""
    depth = env._finger_depths(state.arm, state.held)
    joined, mask, sigmas, idx, _ = _depth_frame(env.sensor, depth)
    calib = env.sensor.calib
    nb = calib.sensor_params.num_bins
    entries = {
        "pyramid warp 32x32": _pyramid_entry(f"{joined.shape[0]}x32x32", joined, mask, sigmas, "warp"),
        "lut full table 256x1024": _lut_entry(f"{idx.shape[0]}x{idx.shape[1]}", idx, calib.features,
                                             calib.poly_lut.reshape(nb * nb, 18)),
    }
    _print_entries(entries)
    return entries


def _factory_reference(env, state, action) -> dict:
    """One PegInsert step at 128 envs on the card and on the CPU from the
    same state, held to ``tests/test_torch_factory.py``'s tolerances. Each
    side renders its fingers from its own poses, which differ by f32 noise,
    so a pixel centre on a silhouette edge may fall either way: the depth
    maps are held by their share of pixels within 1e-6 m, and the sensor is
    held on the CPU's depth maps, card against CPU, under the bin rule."""
    from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, bin_coords, lut_spread
    from tacex_tpu_torch import envs

    cpu = envs.make(FACTORY_IDS[0], device="cpu")
    st_c = _state_to(state, "cpu")
    st_g, obs_g, rew_g, *_ = env.step(state, action)
    st_c, obs_c, rew_c, *_ = cpu.step(st_c, action.cpu())
    diffs = {}
    for name, a, b, rates in (
        ("arm.q", st_g.arm.q, st_c.arm.q, False), ("held.pos", st_g.held.pos, st_c.held.pos, False),
        ("held.quat", st_g.held.quat, st_c.held.quat, False), ("arm.qd", st_g.arm.qd, st_c.arm.qd, True),
        ("held.linvel", st_g.held.linvel, st_c.held.linvel, True),
        ("held.angvel", st_g.held.angvel, st_c.held.angvel, True),
        ("proprio", obs_g["proprio_obs"], obs_c["proprio_obs"], False), ("reward", rew_g, rew_c, False),
    ):
        d = float((a.cpu() - b).abs().max())
        limit = 1e-4 * max(1.0, float(b.abs().max())) if rates else 1e-5
        diffs[name] = d
        if not d <= limit:
            raise AssertionError(f"factory reference: {name} differs by {d} (limit {limit})")
    depth_c = cpu._finger_depths(st_c.arm, st_c.held)
    depth_near = float(((env._finger_depths(st_g.arm, st_g.held).cpu() - depth_c).abs() <= 1e-6).float().mean())
    if depth_near < 0.99:
        raise AssertionError(f"factory reference: only {depth_near} of depth pixels agree to 1e-6 m")
    _, out_g = env.sensor.update(env.sensor.init_state(), depth_c.to(env.device))
    _, out_c = cpu.sensor.update(cpu.sensor.init_state(), depth_c)
    _, _, _, bins_g = _sensor_frame(env.sensor, out_g)
    _, gm, gd, bins_c = _sensor_frame(cpu.sensor, out_c)
    calib = cpu.sensor.calib
    nb = calib.sensor_params.num_bins
    bt, bc = [b.cpu().numpy() for b in bins_g], [b.numpy() for b in bins_c]
    # as in the sensor phase, the devices round the depth's m -> mm -> m
    # arithmetic differently, so gradients within EDGE_BINS of a bin edge
    # may switch bins; this prints how near an edge the switched ones lie
    t_mag, t_dir = bin_coords(gm.numpy(), gd.numpy(), nb)
    edge = np.minimum(np.abs(t_mag - np.round(t_mag)), np.abs(t_dir - np.round(t_dir)))
    moved = ((bt[0] != bc[0]) | (bt[1] != bc[1])) & (np.tan(gm.numpy().astype(np.float64)) >= FINGER_NOISE_FLOOR)
    worst_edge = float(edge[moved].max(initial=0.0))
    print(f"factory reference (cuda vs cpu, {FACTORY_IDS[0]}, {env.cfg.num_envs} envs): "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
          + f"; {depth_near:.4f} of finger depth pixels within 1e-6 m; the sensor on the CPU's depth maps: "
          f"{int(moved.sum())} pixels above the noise floor take another LUT row, the farthest {worst_edge:.2e} bins "
          f"from an edge (margin {EDGE_BINS})")
    held = assert_bin_rule(out_g["tactile_rgb"].cpu().numpy(), out_c["tactile_rgb"].numpy(), gm.numpy(), gd.numpy(), nb,
                           lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb), bins_t=bt, bins_j=bc,
                           edge_bins=EDGE_BINS, noise_floor=FINGER_NOISE_FLOOR)
    print(f"factory reference: {held:.4f} of pixels take the same LUT rows on both devices and agree to 1e-4")
    return dict(diffs, depth_share_1e_6=depth_near, tactile_held=held, worst_edge_bins=worst_edge)


def factory_train_phase(device) -> dict:
    """One PPO iteration on PegInsert at 128 envs under its tuned config
    (4 epochs x 32 minibatches) cut to FACTORY_TRAIN_ROLLOUTS rollout steps
    (its 128 took ~108 s of the script's budget), on the (32, 32, 6) finger
    images: K1 and K2 launch once per rollout step."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl import PPO
    from tacex_tpu_torch.rl.agents import agent_cfg_for

    env_id = FACTORY_IDS[0]
    cfg = agent_cfg_for(env_id, "ppo").replace(rollouts=FACTORY_TRAIN_ROLLOUTS)
    env = envs.make(env_id, device=device)
    ppo = PPO(env, cfg)
    ppo.init(0)
    before = [p.detach().clone() for p in ppo.params]
    rollouts, updates = [], []
    ppo.rollout, ppo.update = _event_timed(ppo.rollout, rollouts), _event_timed(ppo.update, updates)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    metrics = ppo.train_step()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _read_counters()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["reward_per_step"])):
        raise AssertionError(f"factory train: metrics {metrics}")
    if not all(bool((a != b).any()) for a, b in zip(ppo.params, before)):
        raise AssertionError("factory train: a parameter tensor did not change")
    if launches != {"deformation_pyramid": cfg.rollouts, "lut_shade": cfg.rollouts}:
        raise AssertionError(f"factory train: launches {launches}, expected {cfg.rollouts} each")
    rollout_s, update_s = rollouts[0][0].elapsed_time(rollouts[0][1]) / 1e3, updates[0][0].elapsed_time(updates[0][1]) / 1e3
    steps = cfg.rollouts * env.cfg.num_envs
    print(f"factory train: {env_id}, {env.cfg.num_envs} envs, rollouts {cfg.rollouts}, {cfg.learning_epochs} epochs x "
          f"{cfg.mini_batches} minibatches, vision obs {tuple(ppo.obs['vision_obs'].shape[1:])}: {sec:.3f} s/iteration "
          f"(the first, host clock) = {steps / sec:.1f} env-steps/s; rollout {rollout_s:.3f} s, update {update_s:.3f} s "
          f"(CUDA events); launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          f"loss {metrics['loss']:.5f}, reward/step {metrics['reward_per_step']:.5f}")
    return dict(launches=launches, sec_per_iter=sec, rollout_s=rollout_s, update_s=update_s,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def pole_phase(device) -> dict:
    """Pole balancing at its default 1024 envs: reset and POLE_STEPS steps
    with no host sync."""
    from tacex_tpu_torch import envs

    env = envs.make(POLE_ID, device=device)
    n = env.cfg.num_envs
    action = torch.zeros((n, 6), device=device)
    state, obs = env.reset_all(env.init_state())
    env.step(state, action)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        state, obs = env.reset_all(env.init_state())
        for _ in range(POLE_STEPS):
            state, obs, reward, term, trunc, info = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / POLE_STEPS
    _check_finite(POLE_ID, {"state": state, "obs": obs, "reward": reward})
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    if shapes != {"proprio_obs": (n, 14), "vision_obs": (n, 32, 32, 1)}:
        raise AssertionError(f"{POLE_ID}: obs shapes {shapes}")
    seen = float((obs["vision_obs"] < env.cfg.sensor_clipping[1]).float().mean())
    print(f"pole: {POLE_ID}, {n} envs, reset + {POLE_STEPS} steps with no host sync: {step_ms:.3f} ms/step (reset "
          f"included, host clock, synchronised); obs {shapes}; {seen:.4f} of depth pixels see the pole; "
          f"reward {float(reward.mean()):.4f}")
    return dict(step_ms=step_ms)


def _sac_run(env_id, num_envs, device, guarded: int, unguarded: int) -> dict:
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl import SAC
    from tacex_tpu_torch.rl.agents import agent_cfg_for

    cfg = agent_cfg_for(env_id, "sac")
    sac = SAC(envs.make(env_id, num_envs=num_envs, device=device), cfg)
    sac.init(0)
    before = [p.detach().clone() for p in sac.actor_params]
    for _ in range(unguarded):
        sac.train_step()
    torch.cuda.synchronize()
    if sac.steps < cfg.warmup_steps:
        raise AssertionError(f"sac: {sac.steps} env steps have not crossed warmup_steps {cfg.warmup_steps}")
    _reset_counters()
    torch.cuda.set_sync_debug_mode("error" if guarded else "default")
    t0 = time.perf_counter()
    try:
        for _ in range(max(guarded, 1)):
            metrics = sac.train_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / max(guarded, 1)
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()) or metrics["critic_loss"] <= 0.0:
        raise AssertionError(f"sac {env_id}: metrics {metrics}")
    if not all(bool((a != b).any()) for a, b in zip(sac.actor_params, before)):
        raise AssertionError(f"sac {env_id}: an actor parameter did not change")
    return dict(cfg=cfg, sec_per_step=sec, metrics=metrics, launches=_read_counters(), buffer=sac.buffer.size)


def sac_phase(device) -> dict:
    """SAC: the privileged task at 512 envs under the config of
    ``logs/sac_privileged_r05/config.json`` (one train step crosses
    ``warmup_steps``, then SAC_GUARDED_STEPS with no host sync), and the
    tactile Taxim-Fots task at 4096 envs under its SAC config."""
    out = {}
    for env_id, n, guarded, unguarded in ((PRIVILEGED_ID, SAC_PRIVILEGED_ENVS, SAC_GUARDED_STEPS, 1),
                                          (ENV_ID, NUM_ENVS, 0, SAC_VISION_STEPS - 1)):
        r = _sac_run(env_id, n, device, guarded, unguarded)
        c, m = r.pop("cfg"), r["metrics"]
        print(f"sac: {env_id}, {n} envs, batch {c.batch_size}, buffer {c.buffer_size} ({r['buffer']} filled), "
              f"rollout {c.rollout_steps} x {c.grad_steps} grad steps, warmup {c.warmup_steps}: {r['sec_per_step']:.4f} "
              f"s/train-step ({'no host sync, ' if guarded else ''}host clock, synchronised); critic loss "
              f"{m['critic_loss']:.5f}, actor loss {m['actor_loss']:.5f}, alpha {m['alpha']:.5f}; launches {r['launches']}")
        out[env_id] = r
    return out


def _uipc_action(n: int, device) -> torch.Tensor:
    """A steady press of the gel onto the ball (-z): ~0.4 mm deeper a step."""
    action = torch.zeros((n, 6), device=device)
    action[:, 2] = UIPC_PRESS
    return action


def _gel_displacement(env, state) -> torch.Tensor:
    """(N,) largest distance (m) of a gel vertex from its rest place at the
    tool's pose: the gel's deformation, without its rigid motion."""
    rest = env._gel_world_rest_state(state.base).x
    return torch.linalg.vector_norm(state.gel.x - rest, dim=-1).amax(-1)


def _uipc_run(env, steps: int) -> dict:
    """``reset_all``, a warm-up step, then ``steps`` steps with no host sync
    (sync-debug "error"), the launch counters reset just before them; then
    the CUDA kernels of one more step (torch.profiler)."""
    n = env.cfg.num_envs
    action = _uipc_action(n, env.device)
    state, obs = env.reset_all(env.init_state())
    state, obs, *_ = env.step(state, action)
    gc.collect()  # the peak below should count this env's tensors, not an earlier phase's garbage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        for _ in range(steps):
            state, obs, reward, term, trunc, info = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = _read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"deformation_pyramid": steps, "lut_shade": steps}:
        raise AssertionError(f"uipc: kernel launches {launches} in {steps} steps, expected one each a step")
    _check_finite("uipc", {"state": state, "obs": obs, "reward": reward, "info": info})
    vh, vw, vc = env.cfg.vision_obs_shape
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    if shapes != {"proprio_obs": (n, 14), "vision_obs": (n, vh, vw, vc)}:
        raise AssertionError(f"uipc: obs shapes {shapes}")
    if tuple(info["marker_flow"].shape) != (n, 2, 128, 2):
        raise AssertionError(f"uipc: marker flow {tuple(info['marker_flow'].shape)}")
    contact = int((info["indentation_depth"] > 0).sum())
    disp = _gel_displacement(env, state)
    if contact < n or float(disp.min()) < 1e-4:
        raise AssertionError(f"uipc: {contact} of {n} envs in contact, gel displacement {disp.tolist()}")
    kernels, device_ms = _launch_count(lambda: env.step(state, action))
    # the IPC solve alone (SoftBodyModel.step), at the step's scene and targets
    from tacex_tpu_torch.core import maths

    tool_pos, tool_quat = env._tool_pose(state.base.arm.q)
    aim = maths.transform_points(env._gel_top_rest, tool_pos, tool_quat)
    scene = env._scene(state.base.ball_pos, env._planes)
    solve_ms = _host_ms(lambda: env.gel.step(state.gel, scene, aim), iters=2)
    return dict(state=state, obs=obs, info=info, step_ms=step_ms, kernels_per_step=kernels,
                device_ms_per_step=device_ms, solve_ms=solve_ms, launches=launches,
                peak_gb=peak_gb, in_contact=contact, indentation_mm=[float(info["indentation_depth"].min()),
                float(info["indentation_depth"].max())], gel_max_displacement_m=float(disp.max()))


def _uipc_print(tag: str, env, r: dict, steps: int) -> None:
    print(f"uipc: {tag}, {env.cfg.num_envs} envs, gel {env.gel_mesh.num_vertices} vertices / {len(env.gel_mesh.tets)} "
          f"tets, {steps} steps with no host sync: {r['step_ms']:.3f} ms/step (host clock, synchronised; the IPC solve "
          f"alone {r['solve_ms']:.3f} ms), "
          f"{r['kernels_per_step']} CUDA kernels a step taking {r['device_ms_per_step']:.3f} ms of device time "
          f"(torch.profiler), K1/K2 launches {r['launches']}, peak memory "
          f"{r['peak_gb']:.3f} GB; {r['in_contact']} envs in contact, indentation {r['indentation_mm'][0]:.3f}-"
          f"{r['indentation_mm'][1]:.3f} mm, gel max displacement {r['gel_max_displacement_m']:.3e} m")


def _uipc_kernels(env, state) -> dict:
    """K1 and K2 on the UIPC frame of ``state``: the depth of the deformed
    gel's contact surface, resampled to the 32x24 sensor."""
    tool_pos, tool_quat = env._tool_pose(state.base.arm.q)
    depth = env.contact_surface(state.gel.x, tool_pos, tool_quat)[-1]
    joined, mask, sigmas, idx, _ = _depth_frame(env.sensor, depth)
    calib = env.sensor.calib
    nb = calib.sensor_params.num_bins
    n, h, w = joined.shape
    entries = {
        f"pyramid warp {n}x{h}x{w}": _pyramid_entry(f"{n}x{h}x{w}", joined, mask, sigmas, "warp"),
        f"lut full table {n}x{h * w}": _lut_entry(f"{n}x{h * w}", idx, calib.features,
                                                  calib.poly_lut.reshape(nb * nb, 18)),
    }
    _print_entries(entries)
    return entries


def _uipc_reference(device) -> dict:
    """2 envs of the registered UIPC id on the card and on the CPU: pressed
    on the card, carried over, one step on each. The gel and the ball are
    held to the parity tests' tolerances (``tests/_torch_uipc.py``: the gel
    within the drift of two f32 CG solves), and the tactile image of the
    CPU's gel, card against CPU, under the bin rule."""
    from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, bin_coords, lut_spread
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.envs.ball_rolling.env import BallRollingEnvCfg

    events = {**BallRollingEnvCfg().events_cfg, "enabled": False}
    kw = dict(num_envs=2, action_noise=0.0, obs_noise_std=0.0, events_cfg=events)
    gpu, cpu = envs.make(UIPC_IDS[0], device=device, **kw), envs.make(UIPC_IDS[0], device="cpu", **kw)
    action = _uipc_action(2, device)
    st_g, _ = gpu.reset_all(gpu.init_state())
    for _ in range(2):
        st_g, *_ = gpu.step(st_g, action)
    st_c = _state_to(st_g, "cpu")
    st_g, obs_g, rew_g, term_g, trunc_g, info_g = gpu.step(st_g, action)
    st_c, obs_c, rew_c, term_c, trunc_c, info_c = cpu.step(st_c, action.cpu())
    if bool((term_c | trunc_c).any()) or not torch.equal(term_g.cpu(), term_c):
        raise AssertionError("uipc reference: an env finished")
    # tests/_torch_uipc.py GEL_ATOL (m) and tests/test_torch_env.py's ATOL and
    # TOL: the ball's spin relative to its size, its quaternion half a step of
    # that. The indentation (mm) is the contact surface's depth, so it moves
    # with the gel's vertices: up to 1e3 x the gel's tolerance
    gel_atol, atol = 1.5e-5, 1e-5
    ang_tol = 2e-3 * max(1.0, float(st_c.base.ball_ang.abs().max()))
    diffs, limits = {}, {}
    for name, a, b, limit in (
        ("gel.x", st_g.gel.x, st_c.gel.x, gel_atol), ("gel.v", st_g.gel.v, st_c.gel.v, 60.0 * gel_atol),
        ("ball_pos", st_g.base.ball_pos, st_c.base.ball_pos, atol),
        ("ball_quat", st_g.base.ball_quat, st_c.base.ball_quat, atol + 0.5 / 60.0 * ang_tol),
        ("ball_lin", st_g.base.ball_lin, st_c.base.ball_lin, atol),
        ("ball_ang", st_g.base.ball_ang, st_c.base.ball_ang, ang_tol),
        ("reward", rew_g, rew_c, atol),
        ("indentation_mm", info_g["indentation_depth"], info_c["indentation_depth"], 1e3 * gel_atol),
    ):
        diffs[name], limits[name] = float((a.cpu() - b).abs().max()), limit
    print("uipc reference (cuda vs cpu, 2 envs, one step from a carried-over pressed state): "
          + ", ".join(f"{k} {v:.2e} (limit {limits[k]:.1e})" for k, v in diffs.items()))
    bad = {k: v for k, v in diffs.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"uipc reference: the card's step disagrees with the CPU's: {bad}")

    tool_pos, tool_quat = cpu._tool_pose(st_c.base.arm.q)
    depth_c = cpu.contact_surface(st_c.gel.x, tool_pos, tool_quat)[-1]
    _, out_g = gpu.sensor.update(gpu.sensor.init_state(), depth_c.to(device))
    _, out_c = cpu.sensor.update(cpu.sensor.init_state(), depth_c)
    _, _, _, bins_g = _sensor_frame(gpu.sensor, out_g)
    _, gm, gd, bins_c = _sensor_frame(cpu.sensor, out_c)
    calib = cpu.sensor.calib
    nb = calib.sensor_params.num_bins
    bt, bc = [b.cpu().numpy() for b in bins_g], [b.numpy() for b in bins_c]
    t_mag, t_dir = bin_coords(gm.numpy(), gd.numpy(), nb)
    edge = np.minimum(np.abs(t_mag - np.round(t_mag)), np.abs(t_dir - np.round(t_dir)))
    moved = ((bt[0] != bc[0]) | (bt[1] != bc[1])) & (np.tan(gm.numpy().astype(np.float64)) >= FINGER_NOISE_FLOOR)
    worst_edge = float(edge[moved].max(initial=0.0))
    held = assert_bin_rule(out_g["tactile_rgb"].cpu().numpy(), out_c["tactile_rgb"].numpy(), gm.numpy(), gd.numpy(),
                           nb, lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb), bins_t=bt, bins_j=bc,
                           edge_bins=EDGE_BINS, noise_floor=FINGER_NOISE_FLOOR)
    print(f"uipc reference: tactile_rgb of the CPU's gel, cuda vs cpu: {held:.4f} of pixels take the same LUT rows and "
          f"agree to 1e-4; {int(moved.sum())} pixels above the noise floor take another row, the farthest "
          f"{worst_edge:.2e} bins from an edge (margin {EDGE_BINS})")
    return dict(diffs, tactile_held=held, worst_edge_bins=worst_edge)


def uipc_phase(device) -> dict:
    """The soft FEM gel pad: ``TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0`` at its
    registered 16 envs (UIPC_STEPS steps, K1 and K2 once a step, both held to
    their plain versions on its frame), 2 envs held to the CPU, the textured
    id at 16 envs (its filmed dots move under the press) and the embedded
    dense contact surface at 64 envs."""
    from tacex_tpu_torch import envs

    out = {}
    env = envs.make(UIPC_IDS[0], device=device)
    r = _uipc_run(env, UIPC_STEPS)
    _uipc_print(UIPC_IDS[0], env, r, UIPC_STEPS)
    kernels = _uipc_kernels(env, r["state"])
    out[UIPC_IDS[0]] = {k: v for k, v in r.items() if k not in ("state", "obs", "info")}
    out["launches"] = r["launches"]
    del env, r
    out["reference"] = _uipc_reference(device)

    env = envs.make(UIPC_IDS[1], device=device)
    r = _uipc_run(env, UIPC_TEXTURED_STEPS)
    _uipc_print(UIPC_IDS[1], env, r, UIPC_TEXTURED_STEPS)
    state = r["state"]
    tool_pos, tool_quat = env._tool_pose(state.base.arm.q)
    film = env._film_texture_frame(env.contact_surface(state.gel.x, tool_pos, tool_quat)[3])
    rest = env._gel_world_rest_state(state.base).x
    film_rest = env._film_texture_frame(env.contact_surface(rest, tool_pos, tool_quat)[3])
    moved = float(((film - film_rest).abs().amax(-1) > 0.05).float().mean())
    dots = float((film < 0.3).float().mean())
    print(f"uipc: {UIPC_IDS[1]}: filmed frame {tuple(film.shape)}, {dots:.4f} of texels on a dot, {moved:.4f} of "
          "pixels changed by more than 0.05 against the rest gel at the same tool pose")
    if not (bool(torch.isfinite(film).all()) and dots > 0.0 and moved > 0.0):
        raise AssertionError("uipc textured: the filmed frame is not finite, shows no dots, or no dot moved")
    out[UIPC_IDS[1]] = dict({k: v for k, v in r.items() if k not in ("state", "obs", "info")},
                            film_dot_share=dots, film_moved_share=moved)
    del env, r, state

    env = envs.make(UIPC_IDS[0], num_envs=UIPC_EMBED_ENVS, gel_resolution="low", gel_embed_surface="extremely_high",
                    device=device)
    r = _uipc_run(env, UIPC_EMBED_STEPS)
    _uipc_print(f"{UIPC_IDS[0]}, gel 'low' + embedded 'extremely_high' surface {env.embed.shape}", env, r,
                UIPC_EMBED_STEPS)
    kernels.update(_uipc_kernels(env, r["state"]))
    out["embedded_64"] = {k: v for k, v in r.items() if k not in ("state", "obs", "info")}
    out["kernels"] = kernels
    return out


def _coupled_pressed(env, state):
    """The pressed start of the coupled parity tests (``tests/_torch_coupled.py``):
    each pad moved 0.6 mm toward the free body (0.4 mm from its faces, inside
    the 1 mm barrier reach), the squeeze set to match, the body at a fixed
    small offset from the gripper's centre."""
    n = env.cfg.num_envs
    grasp = hasattr(state, "cube")
    body = state.cube if grasp else state.peg
    xy = torch.tensor([2e-4, -1e-4], device=env.device).expand(n, 2) + (0.0 if grasp else state.mount[:, :2])
    q = torch.cat([xy[:, None, :], body.q[..., 2:]], -1)
    sgn = torch.sign(env.rig.rest_points[:, 0])
    x = state.gel.x - COUPLED_PRESS * torch.stack([sgn, torch.zeros_like(sgn), torch.zeros_like(sgn)], -1)
    body = dataclasses.replace(body, q=q)
    state = dataclasses.replace(state, gel=dataclasses.replace(state.gel, x=x),
                                squeeze=torch.full((n,), COUPLED_PRESS, device=env.device))
    return dataclasses.replace(state, **({"cube": body} if grasp else {"peg": body}))


def _coupled_action(env) -> torch.Tensor:
    """Squeeze (Grasp-Lift: [1, 0.3], a slow lift; Factory-UIPC: down 0.3
    and squeeze)."""
    n, a = env.cfg.num_envs, env.cfg.action_space
    action = torch.zeros((n, a), device=env.device)
    if a == 2:
        action[:, 0], action[:, 1] = 1.0, 0.3
    else:
        action[:, 2], action[:, 3] = -0.3, 1.0
    return action


def _coupled_frame(env, state):
    """K1 and K2's inputs on the tactile Grasp-Lift frame of ``state``: the
    2N pad-major 32x32 images."""
    depth = env._pad_sensor_depth(env._pad_compression(state.gel.x, state.squeeze))
    return _depth_frame(env.sensor, depth)


def _coupled_steps(env, state, action, steps: int, guarded: bool):
    """``steps`` steps, the launch counters reset just before them; under
    sync-debug "error" when ``guarded``. Returns (state, outputs, ms a step,
    launches)."""
    torch.cuda.synchronize()
    _reset_counters()
    if guarded:
        torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        for _ in range(steps):
            state, obs, reward, term, trunc, info = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    return state, (obs, reward, term, trunc, info), step_ms, _read_counters()


def _coupled_reference(device) -> dict:
    """2 envs of the tactile Grasp-Lift id on the card and on the CPU at the
    parity tests' iterations (``tests/_torch_coupled.py``: 2 Newton x 8 CG)
    and velocity_tol = 0 (the stop is a float-noise decision): pressed and
    stepped once on the card, carried over, one step on each. The gel and
    the cube's q are held to the parity tests' tolerances, the reward
    through its slopes, and the tactile image of the CPU's gel, card against
    CPU, under the bin rule. At the registered 6 Newton x 24 CG the solve
    is too sensitive to its inputs' rounding for that: a 2e-9 m jolt of the
    gel (two f32 steps) moves the CPU's own step, which this prints."""
    from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, lut_spread
    from tacex_tpu_torch import envs

    kw = dict(num_envs=2, stagger_initial_episodes=False)
    iters = dict(newton_iters=REF_NEWTON_ITERS, cg_iters=REF_CG_ITERS)
    gpu, cpu = envs.make(GRASP_IDS[0], device=device, **kw, **iters), envs.make(GRASP_IDS[0], device="cpu", **kw, **iters)
    full = envs.make(GRASP_IDS[0], device="cpu", **kw)
    for e in (gpu, cpu, full):
        e.world.fem.cfg.velocity_tol = 0.0
    action = _coupled_action(gpu)
    st_g, _ = gpu.reset_all(gpu.init_state())
    st_g, *_ = gpu.step(_coupled_pressed(gpu, st_g), action)
    st_c = _state_to(st_g, "cpu")
    jolted = dataclasses.replace(st_c, gel=dataclasses.replace(st_c.gel, x=st_c.gel.x + 2e-9))
    t0 = time.perf_counter()
    a_full = full.step(st_c, action.cpu())[0]
    full_ms = 1e3 * (time.perf_counter() - t0)
    b_full = full.step(jolted, action.cpu())[0]
    jolt = {name: float((a - b).abs().max()) for name, a, b in (
        ("gel.x", a_full.gel.x, b_full.gel.x), ("cube.t", a_full.cube.q[..., :3], b_full.cube.q[..., :3]),
        ("cube.A", a_full.cube.q[..., 3:], b_full.cube.q[..., 3:]))}
    print(f"coupled reference: at the registered {full.cfg.newton_iters} Newton x {full.cfg.cg_iters} CG (the CPU "
          f"step {full_ms:.0f} ms), a 2e-9 m jolt of the gel moves the CPU's step by "
          + ", ".join(f"{k} {v:.2e}" for k, v in jolt.items()))

    st_g, obs_g, rew_g, term_g, trunc_g, info_g = gpu.step(st_g, action)
    st_c, obs_c, rew_c, term_c, trunc_c, info_c = cpu.step(st_c, action.cpu())
    if bool((term_c | trunc_c).any()) or not torch.equal(term_g.cpu(), term_c):
        raise AssertionError("coupled reference: an env finished")
    c = cpu.cfg
    gel_atol = q_atol = 1.5e-5
    rew_atol = c.w_grip / c.grip_target_mm * 1e3 * gel_atol + c.w_lift / c.lift_target * q_atol + 1e-6
    diffs, limits = {}, {}
    for name, a, b, limit in (
        ("gel.x", st_g.gel.x, st_c.gel.x, gel_atol), ("gel.v", st_g.gel.v, st_c.gel.v, gel_atol / c.sim_dt),
        ("cube.q", st_g.cube.q, st_c.cube.q, q_atol), ("cube.qd", st_g.cube.qd, st_c.cube.qd, q_atol / c.sim_dt),
        ("reward", rew_g, rew_c, rew_atol), ("grip_mm", info_g["grip"], info_c["grip"], 1e3 * gel_atol),
    ):
        diffs[name], limits[name] = float((a.cpu() - b).abs().max()), limit
    print(f"coupled reference (cuda vs cpu, 2 envs at {REF_NEWTON_ITERS} Newton x {REF_CG_ITERS} CG, one step from a "
          "carried-over pressed state): " + ", ".join(f"{k} {v:.2e} (limit {limits[k]:.1e})" for k, v in diffs.items()))
    bad = {k: v for k, v in diffs.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"coupled reference: the card's step disagrees with the CPU's: {bad}")
    if not bool((info_c["grip"] > 0.05).all()):
        raise AssertionError(f"coupled reference: the pads do not press the cube: grip {info_c['grip'].tolist()}")

    depth_c = cpu._pad_sensor_depth(cpu._pad_compression(st_c.gel.x, st_c.squeeze))
    _, out_g = gpu.sensor.update(gpu.sensor.init_state(), depth_c.to(device))
    _, out_c = cpu.sensor.update(cpu.sensor.init_state(), depth_c)
    _, _, _, bins_g = _sensor_frame(gpu.sensor, out_g)
    _, gm, gd, bins_c = _sensor_frame(cpu.sensor, out_c)
    calib = cpu.sensor.calib
    nb = calib.sensor_params.num_bins
    bt, bc = [b.cpu().numpy() for b in bins_g], [b.numpy() for b in bins_c]
    held = assert_bin_rule(out_g["tactile_rgb"].cpu().numpy(), out_c["tactile_rgb"].numpy(), gm.numpy(), gd.numpy(),
                           nb, lut_spread(calib.poly_lut.numpy(), calib.features.numpy(), nb), bins_t=bt, bins_j=bc,
                           edge_bins=EDGE_BINS, noise_floor=FINGER_NOISE_FLOOR)
    marked = float((np.tan(gm.numpy().astype(np.float64)) > 1e-2).mean())
    print(f"coupled reference: tactile_rgb of the CPU's gel (2N = 4 pad images of 32x32), cuda vs cpu: {held:.4f} of "
          f"pixels take the same LUT rows and agree to 1e-4; {marked:.4f} of pixels carry the cube's mark")
    if marked <= 0.0:
        raise AssertionError("coupled reference: the cube leaves no mark on the pads' images")
    return dict(diffs, tactile_held=held, full_cpu_step_ms=full_ms, jolt=jolt)


def coupled_phase(device) -> dict:
    """The coupled FEM+ABD world: the tactile Grasp-Lift id at its registered
    16 envs from a pressed start (a warm step, COUPLED_STEPS steps under
    sync-debug "error" with K1 and K2 once a step, torch.profiler's
    activities and device time of one more step, one coupled solve alone,
    K1 and K2 held to their plain versions on its frame); 2 envs card
    against CPU; a scripted squeeze of -Uipc-v0 that must hold the cube; and
    COUPLED_OTHER_STEPS steps of -Uipc-Depth-v0 and both Factory-UIPC ids."""
    from tacex_tpu_torch import envs

    out = {}
    env = envs.make(GRASP_IDS[0], device=device)
    n = env.cfg.num_envs
    action = _coupled_action(env)
    state, obs = env.reset_all(env.init_state())
    state = _coupled_pressed(env, state)
    t0 = time.perf_counter()
    state, *_ = env.step(state, action)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    state, (obs, reward, term, trunc, info), step_ms, launches = _coupled_steps(env, state, action, COUPLED_STEPS,
                                                                               guarded=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"deformation_pyramid": COUPLED_STEPS, "lut_shade": COUPLED_STEPS}:
        raise AssertionError(f"coupled: kernel launches {launches} in {COUPLED_STEPS} steps, expected one each a step")
    _check_finite("coupled", {"state": state, "obs": obs, "reward": reward, "info": info})
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    if shapes != {"proprio_obs": (n, 6), "vision_obs": (n, 32, 32, 6)}:
        raise AssertionError(f"coupled: obs shapes {shapes}")
    if tuple(info["tactile_rgb"].shape) != (n, 2, 32, 32, 3) or tuple(info["marker_motion"].shape)[:2] != (n, 2):
        raise AssertionError("coupled: the tactile outputs are not (N, 2, ...) per pad")
    grip = info["grip"]
    if not bool((grip > 0.05).all()):
        raise AssertionError(f"coupled: the pads do not press the cube: grip {grip.tolist()}")
    kernels, device_ms = _launch_count(lambda: env.step(state, action))
    aim = env._aim_positions(state.squeeze, state.lift)
    solve_ms = _host_ms(lambda: env.world.step(state.gel, state.cube, env.scene, aim_pos=aim), iters=1)
    log = {k: float(v) for k, v in info["log"].items()}
    print(f"coupled: {GRASP_IDS[0]}, {n} envs, gel {env.gel.mesh.num_vertices} vertices, {COUPLED_STEPS} steps with no "
          f"host sync: {step_ms:.1f} ms/step (host clock, synchronised; the warm step {warm_ms:.1f} ms; one coupled "
          f"solve alone {solve_ms:.1f} ms, {env.cfg.decimation} a step), {kernels} device activities a step taking "
          f"{device_ms:.1f} ms of device time (torch.profiler; {100.0 * device_ms / step_ms:.1f}% busy), "
          f"K1/K2 launches {launches}, peak memory {peak_gb:.3f} GB; grip {float(grip.min()):.3f}-"
          f"{float(grip.max()):.3f} mm; log {log}")
    out[GRASP_IDS[0]] = dict(step_ms=step_ms, warm_ms=warm_ms, solve_ms=solve_ms, kernels_per_step=kernels,
                             device_ms_per_step=device_ms, device_busy=device_ms / step_ms, peak_gb=peak_gb,
                             launches=launches, log=log)
    out["launches"] = launches
    joined, mask, sigmas, idx, _ = _coupled_frame(env, state)
    calib = env.sensor.calib
    nb = calib.sensor_params.num_bins
    kernel_rows = {
        "pyramid warp 32x32x32": _pyramid_entry("32x32x32", joined, mask, sigmas, "warp"),
        "lut full table 32x1024": _lut_entry("32x1024", idx, calib.features, calib.poly_lut.reshape(nb * nb, 18)),
    }
    _print_entries(kernel_rows)
    out["kernels"] = kernel_rows
    del env, state, obs, info
    out["reference"] = _coupled_reference(device)

    # the scripted squeeze of tests/test_grasp_lift.py: the cube must be held
    env = envs.make(GRASP_IDS[1], device=device, squeeze_rate=4e-3, episode_length_s=3.0,
                    stagger_initial_episodes=False)
    state, _ = env.reset_all(env.init_state())
    squeeze = torch.zeros((env.cfg.num_envs, 2), device=device)
    squeeze[:, 0] = 1.0
    t0 = time.perf_counter()
    cube_z = []
    for _ in range(SQUEEZE_STEPS):
        state, obs, reward, term, trunc, info = env.step(state, squeeze)
        cube_z.append(info["cube_z"])
    torch.cuda.synchronize()
    sq_ms = 1e3 * (time.perf_counter() - t0) / SQUEEZE_STEPS
    cube_z = torch.stack(cube_z)
    z_min = float(cube_z.min())
    print(f"coupled: scripted squeeze of {GRASP_IDS[1]} ([1, 0], {env.cfg.num_envs} envs, {SQUEEZE_STEPS} steps, "
          f"{sq_ms:.1f} ms/step): cube z {z_min * 1e3:.3f} mm at its lowest (limit -3 mm), "
          f"{float(cube_z[-1].mean()) * 1e3:.3f} mm at the end; grip {float(info['grip'].mean()):.3f} mm")
    if not (bool(torch.isfinite(cube_z).all()) and z_min > -0.003):
        raise AssertionError(f"coupled: the squeeze does not hold the cube: lowest z {z_min}")
    out["squeeze"] = dict(steps=SQUEEZE_STEPS, step_ms=sq_ms, cube_z_min_m=z_min)
    del env, state

    for env_id in (GRASP_IDS[2],) + FACTORY_UIPC_IDS:
        env = envs.make(env_id, device=device)
        state, obs = env.reset_all(env.init_state())
        state, (obs, reward, term, trunc, info), ms, _ = _coupled_steps(env, state, _coupled_action(env),
                                                                       COUPLED_OTHER_STEPS, guarded=True)
        _check_finite(env_id, {"state": state, "obs": obs, "reward": reward, "log": info["log"]})
        shapes = {k: tuple(v.shape) for k, v in obs.items()}
        print(f"coupled: {env_id}, {env.cfg.num_envs} envs, {COUPLED_OTHER_STEPS} steps with no host sync: "
              f"{ms:.1f} ms/step; obs {shapes}; log {({k: round(float(v), 4) for k, v in info['log'].items()})}")
        out[env_id] = dict(step_ms=ms, obs_shapes=shapes)
        del env, state, obs, info
    return out


def _tool(rel: str) -> dict:
    """The namespace of a script under ``scripts/`` (its ``main`` and helpers)."""
    import runpy

    return runpy.run_path(str(REPO / "scripts" / rel))


def _counted(fn):
    """``fn()`` with the launch counters reset just before it: (its result,
    host ms to a synchronise after it, launches)."""
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, 1e3 * (time.perf_counter() - t0), _read_counters()


def _expect_launches(tag: str, launches: dict, n: int) -> None:
    if launches != {"deformation_pyramid": n, "lut_shade": n}:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected {n} of each")


def _tool_kernels(calib, shifted) -> dict:
    """K1 (cluster design) and K2 held to their plain versions and timed on
    the optical frame of (n, 240, 320) shifted height maps (mm)."""
    joined, mask, sigmas, idx, _ = _height_frame(calib, shifted)
    n, h, w = joined.shape
    nb = calib.sensor_params.num_bins
    entries = {
        f"pyramid cluster {n}x{h}x{w}": _pyramid_entry(f"{n}x{h}x{w}", joined, mask, sigmas, "cluster"),
        f"lut full table {n}x{h * w}": _lut_entry(f"{n}x{h * w}", idx, calib.features,
                                                  calib.poly_lut.reshape(nb * nb, 18)),
    }
    _print_entries(entries)
    return entries


def _library_phase(device) -> dict:
    """``check_taxim_sim_torch.render_library`` on the 26 shapes at 240x320
    (one K1 and one K2 launch), TOOLS_CPU_SHAPES of them held to the CPU's
    render under the bin rule, and K1/K2 timed on the frame."""
    from _torch_bins import FINGER_NOISE_FLOOR, assert_bin_rule, lut_spread
    from tacex_tpu_torch.assets.shapes import SHAPE_LIBRARY, shape_height_map
    from tacex_tpu_torch.sensors.gelsight import taxim
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    render_library = _tool("demos/check_taxim_sim_torch.py")["render_library"]
    names = list(SHAPE_LIBRARY)
    calib = taxim.load_calib()
    imgs, ms, launches = _counted(lambda: render_library(calib, names, TOOLS_RES, 1.0, False, device))
    _expect_launches("check_taxim_26", launches, 1)
    if tuple(imgs.shape) != (len(names),) + TOOLS_RES + (3,) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"check_taxim_26: images {tuple(imgs.shape)} are not finite (26, 240, 320, 3)")
    k = TOOLS_CPU_SHAPES
    cpu = render_library(calib, names[:k], TOOLS_RES, 1.0, False, "cpu")
    hms = torch.as_tensor(np.stack([shape_height_map(nm, TOOLS_RES) for nm in names]))
    cal_g, cal_c = calib.at_resolution(TOOLS_RES).to(device), calib.at_resolution(TOOLS_RES)
    shifted = optical.shift_height_map(hms.to(device), torch.ones(len(names), device=device))
    _, _, bins_g = _optical_bins(cal_g, shifted[:k])
    gm_c, gd_c, bins_c = _optical_bins(cal_c, shifted[:k].cpu())
    nb = cal_c.sensor_params.num_bins
    held = assert_bin_rule(imgs[:k].cpu().numpy(), cpu.numpy(), gm_c.numpy(), gd_c.numpy(), nb,
                           lut_spread(cal_c.poly_lut.numpy(), cal_c.features.numpy(), nb),
                           bins_t=[b.cpu().numpy() for b in bins_g], bins_j=[b.numpy() for b in bins_c],
                           edge_bins=EDGE_BINS, noise_floor=FINGER_NOISE_FLOOR)
    print(f"tools: check_taxim_sim render_library, {len(names)} shapes at {TOOLS_RES[0]}x{TOOLS_RES[1]} in one render: "
          f"{ms:.3f} ms (host clock, synchronised, the first call), launches {launches}; {k} shapes held to the "
          f"CPU's render under the bin rule, {held:.4f} of pixels to 1e-4")
    return dict(render_ms=ms, launches=launches, cpu_pixels_held=held, kernels=_tool_kernels(cal_g, shifted))


def _pressed_frame(n: int, device):
    """The default sensor's shifted height maps of the verify recipe's
    pressed 4 mm sphere on ``n`` envs: the (n, 240, 320) frame the sensor
    updates of the follow-goal and pick-up demos give K1 and K2."""
    from tacex_tpu_torch.sensors.gelsight.sensor import GelSightSensor
    from tacex_tpu_torch.sensors.gelsight.sensor_cfg import gelsight_mini_cfg
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    sensor = GelSightSensor(gelsight_mini_cfg(), num_envs=n, device=device)
    hm = sensor.height_map_from_depth(_press_depth(n, device))
    return sensor.calib, optical.shift_height_map(hm, sensor.compute_indentation_depth(hm))


def _play_round_trip(device, root: Path) -> dict:
    """``train_torch.py`` (PLAY_ITERATIONS PPO iterations of the flagship at
    PLAY_ENVS envs, the dashboard and a checkpoint each iteration), then
    ``play_torch.py`` (PLAY_STEPS steps with --save_frames): the played
    policy's first action is the trained net's."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    ckpt, viz, frames = root / "ckpt", root / "viz", root / "frames"
    trainer, train_ms, train_launches = _counted(lambda: _tool("train_torch.py")["main"]([
        "--task", ENV_ID, "--num_envs", str(PLAY_ENVS), "--iterations", str(PLAY_ITERATIONS),
        "--checkpoint_dir", str(ckpt), "--checkpoint_interval", "1", "--viz_dir", str(viz), "--viz_interval", "1",
        "--device", str(device)]))
    made = sorted(q.name for q in viz.iterdir())
    if not {"metrics.jsonl", "metrics.png", "tactile_obs_strip.png"} <= set(made):
        raise AssertionError(f"train_torch --viz_dir wrote {made}")
    res, play_ms, play_launches = _counted(lambda: _tool("play_torch.py")["main"]([
        "--task", ENV_ID, "--num_envs", str(PLAY_ENVS), "--steps", str(PLAY_STEPS), "--checkpoint_dir", str(ckpt),
        "--save_frames", str(frames), "--device", str(device)]))
    with torch.no_grad():
        mean, _, _ = trainer.net(res["first_obs"])
    err = float((res["first_action"] - mean).abs().max())
    written = len(list(frames.glob("frame_*.png")))
    print(f"tools: train_torch -> play_torch, {ENV_ID} at {PLAY_ENVS} envs: {PLAY_ITERATIONS} iterations in "
          f"{train_ms:.1f} ms (K1/K2 launches {train_launches}), restored {res['checkpoint'].name}; {PLAY_STEPS} played "
          f"steps in {res['loop_s'] * 1e3:.1f} ms ({res['loop_s'] * 1e3 / PLAY_STEPS:.3f} ms a step with the frames "
          f"written; the whole script {play_ms:.1f} ms, launches {play_launches}), {written} frames; first action "
          f"vs the trained net {err:.2e}; mean return {res['mean_return']:.4f}")
    if res["checkpoint"].name != f"ckpt_{PLAY_ITERATIONS - 1}.pt" or not err <= 1e-6 or written != PLAY_STEPS:
        raise AssertionError(f"play: checkpoint {res['checkpoint']}, first action off by {err}, {written} frames")
    if play_launches["deformation_pyramid"] < PLAY_STEPS or play_launches["lut_shade"] < PLAY_STEPS:
        raise AssertionError(f"play: kernel launches {play_launches} in {PLAY_STEPS} steps")
    return dict(train_ms=train_ms, play_step_ms=res["loop_s"] * 1e3 / PLAY_STEPS, play_ms=play_ms,
                first_action_err=err, mean_return=res["mean_return"], launches=play_launches)


def tools_phase(device) -> dict:
    """The user-facing tools on the card, each through its script's entry
    point: the 26-shape Taxim library, the follow-goal, rigid and FEM-gel
    pick-up and ManiSkill-marker demos, a train -> play round trip and the
    non-RL benchmark; K1 and K2 held to their plain versions and timed at
    the demos' frames."""
    t_phase = time.perf_counter()
    out = _library_phase(device)
    kernels = out.pop("kernels")

    # follow-goal: the 320x240 sensor on 1 env every step
    r, ms, launches = _counted(lambda: _tool("demos/follow_goal_torch.py")["run"](FOLLOW_GOAL_STEPS, 1 / 30, device))
    _expect_launches("follow_goal_1", launches, FOLLOW_GOAL_STEPS)
    errors, step_ms = r["errors"], 1e3 * r["seconds"] / FOLLOW_GOAL_STEPS
    print(f"tools: follow_goal, {FOLLOW_GOAL_STEPS} steps of 4 IK iterations and one 320x240 sensor update: "
          f"{step_ms:.3f} ms a step (the loop; the whole run with set-up {ms:.1f} ms); tracking error mean "
          f"{errors.mean() * 1e3:.3f} mm, final {errors[-1] * 1e3:.3f} mm (limit {FOLLOW_GOAL_MAX_ERROR * 1e3} mm "
          f"after step 10); {len(r['frames'])} in-contact frames, deepest {float(r['indentation'].max()):.3f} mm; "
          f"launches {launches}")
    if not (np.isfinite(errors).all() and errors[10:].mean() < FOLLOW_GOAL_MAX_ERROR and r["frames"]):
        raise AssertionError("follow_goal: the arm does not track the goal onto the sphere")
    out["follow_goal"] = dict(step_ms=step_ms, run_ms=ms, mean_error_mm=float(errors.mean() * 1e3),
                              final_error_mm=float(errors[-1] * 1e3), launches=launches)
    kernels.update(_tool_kernels(*_pressed_frame(1, device)))

    # the rigid pick-up: 2 finger sensors, one update at the end of each phase
    r, ms, launches = _counted(lambda: _tool("demos/pick_up/pick_up_rigid_torch.py")["run"](PICK_UP_RIGID_STEPS, device))
    _expect_launches("pick_up_rigid_2", launches, 4)
    step_ms = 1e3 * r["seconds"] / (4 * PICK_UP_RIGID_STEPS)
    print(f"tools: pick_up_rigid, 4 x {PICK_UP_RIGID_STEPS} steps: {step_ms:.3f} ms a step (the loop; the whole "
          f"run with set-up {ms:.1f} ms); ball lifted {r['lifted'] * 100:.2f} cm (limit {PICK_UP_RIGID_MIN_LIFT * 100:.0f} cm); grip "
          f"{r['log'][-1]['grip']:.3f} N; launches {launches}")
    if not r["lifted"] >= PICK_UP_RIGID_MIN_LIFT:
        raise AssertionError(f"pick_up_rigid: the ball rose {r['lifted']} m")
    out["pick_up_rigid"] = dict(step_ms=step_ms, run_ms=ms, lifted_m=r["lifted"], launches=launches)
    kernels.update(_tool_kernels(*_pressed_frame(2, device)))

    # the ManiSkill marker flow on the batched FEM gel (no kernel)
    r, ms, launches = _counted(lambda: _tool("demos/check_mani_skill_marker_torch.py")["run"](MANI_SKILL_STEPS, device))
    _expect_launches("check_mani_skill_marker", launches, 0)
    final = r["flows"][-1]
    disp = np.linalg.norm(final[:, 1] - final[:, 0], axis=-1)
    step_ms = 1e3 * r["seconds"] / MANI_SKILL_STEPS
    print(f"tools: check_mani_skill_marker, {MANI_SKILL_STEPS} steps of the 2-env FEM gel: "
          f"{step_ms:.3f} ms a step (the loop; the whole run with set-up {ms:.1f} ms); mean marker displacement press {disp[0].mean():.3f} px, shear "
          f"{disp[1].mean():.3f} px")
    if not (np.isfinite(final).all() and disp[0].mean() > 0.5 and disp[1].mean() > 0.5):
        raise AssertionError(f"check_mani_skill_marker: markers moved {disp.mean(-1)} px")
    out["mani_skill_marker"] = dict(step_ms=step_ms, run_ms=ms, press_px=float(disp[0].mean()),
                                    shear_px=float(disp[1].mean()))

    # the FEM-gel pick-up, cut to PICK_UP_UIPC_STEPS a phase
    r, ms, launches = _counted(lambda: _tool("demos/pick_up/pick_up_uipc_torch.py")["run"](PICK_UP_UIPC_STEPS, device))
    _expect_launches("pick_up_uipc_2", launches, 4)
    last, step_ms = r["log"][-1], 1e3 * r["seconds"] / (4 * PICK_UP_UIPC_STEPS)
    # at 5 steps a phase the fingers stay ~0.36 m above the ball: the pads'
    # indentation is the gels' own sag, and contact and lift are the
    # demo's full 4 x 100 run's (PERF.md)
    print(f"tools: pick_up_uipc, 4 x {PICK_UP_UIPC_STEPS} steps: {step_ms:.3f} ms a step (the loop; the whole run "
          f"with set-up {ms:.1f} ms); ball z {last['ball_z']:.4f} m, grip {last['grip']:.3f} N (ball contact: "
          f"{any(e['grip'] > 0 for e in r['log'])}), pad indentation {last['indent'].tolist()} mm; launches {launches}")
    if not (bool(torch.isfinite(r["gel_x"]).all()) and all(np.isfinite(e["indent"]).all() for e in r["log"])):
        raise AssertionError("pick_up_uipc: non-finite gel or tactile output")
    out["pick_up_uipc"] = dict(step_ms=step_ms, run_ms=ms, steps_per_phase=PICK_UP_UIPC_STEPS,
                               ball_z_m=last["ball_z"], launches=launches)

    out["play"] = _play_round_trip(device, REPO / "build" / "chip_smoke_tools")

    kpi, ms, launches = _counted(lambda: _tool("benchmarking/benchmark_non_rl_example_torch.py")["main"](
        ["--num_envs", str(NON_RL_ENVS), "--num_frames", str(NON_RL_FRAMES), "--device", str(device)]))
    _expect_launches("benchmark_non_rl", launches, NON_RL_FRAMES + 1)
    out["non_rl"] = kpi
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tools: the phase took {out['seconds']:.1f} s")
    out["kernels"] = kernels
    gc.collect()
    return out


def _state_to(state, device):
    """A copy of a port state on ``device``."""
    if dataclasses.is_dataclass(state):
        return type(state)(**{f.name: _state_to(getattr(state, f.name), device) for f in dataclasses.fields(state)})
    return state.to(device)


def uipc_union_scene(device, n: int):
    """The full-width union scene of the UIPC scene API: two ``TetMeshCfg()``
    gel pads (20 x 25 x 4.5 mm at (8, 10, 3) cells, 396 vertices each) at
    the UIPC ids' solver settings (dt 1/60, 4 Newton x 16 CG x 8 line-search
    trials, d_hat 0.5 mm, kappa 2e4) with self and edge-edge contact at
    K = 4 and no gravity: the bottom pad held by its bottom face, the top
    one 0.6 mm above it (0.3 / 0.2 mm off in x / y, clear of the exactly
    aligned grids) driven down by its top-face attachment, ``drop["d"]``
    times 0.8-1.2 (env by env) below its rest. Returns (sim, bottom, top,
    drop)."""
    from tacex_tpu_torch.uipc import StableNeoHookeanCfg, UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import TetMeshCfg

    cfg = UipcSimCfg(num_envs=n, dt=1 / 60, gravity=(0.0, 0.0, 0.0), newton=UipcSimCfg.Newton(max_iter=4),
                     linear_system=UipcSimCfg.LinearSystem(max_iter=16),
                     contact=UipcSimCfg.Contact(d_hat=5e-4, resistance=2e4, self_contact_k=4, ee_contact_k=4))
    sim = UipcSim(cfg, device=device)
    h = TetMeshCfg().size[2]
    bottom = UipcObject(UipcObjectCfg(mesh_cfg=TetMeshCfg(center=(0.0, 0.0, 0.0)), constitution=StableNeoHookeanCfg()),
                        sim)
    top = UipcObject(UipcObjectCfg(mesh_cfg=TetMeshCfg(center=(3e-4, 2e-4, h + 6e-4)),
                                   constitution=StableNeoHookeanCfg()), sim)
    z_b, z_t = bottom.mesh.points[:, 2], top.mesh.points[:, 2]
    bot_ids = np.where(z_b < z_b.min() + 1e-6)[0]
    top_ids = np.where(z_t > z_t.max() - 1e-6)[0]
    dev = sim.device
    rest_b = torch.as_tensor(bottom.mesh.points[bot_ids], device=dev).expand(n, len(bot_ids), 3)
    rest_t = torch.as_tensor(top.mesh.points[top_ids], device=dev).expand(n, len(top_ids), 3)
    down = torch.as_tensor(np.linspace(0.8, 1.2, UIPC_API_ENVS, dtype=np.float32)[:n], device=dev).view(n, 1, 1) * \
        torch.tensor([0.0, 0.0, -1.0], device=dev)
    drop = {"d": 0.0}
    bottom.set_attachments(bot_ids, aim_provider=lambda: rest_b)
    top.set_attachments(top_ids, aim_provider=lambda: rest_t + drop["d"] * down)
    sim.setup_sim()
    return sim, bottom, top, drop


def _union_reference(sim, drop, state, step_x) -> float:
    """Carry envs 0-1 of the card's union state to the same scene on the CPU,
    take the same step there and return the largest difference to the
    card's envs 0-1 after its step (``step_x``)."""
    from tacex_tpu_torch.physics.soft.ipc import SoftBodyState

    ref, _, _, ref_drop = uipc_union_scene("cpu", 2)
    ref._union_state = SoftBodyState(x=state.x[:2].cpu(), v=state.v[:2].cpu())
    ref._refresh_union_slices()
    ref_drop["d"] = drop["d"]
    ref.step()
    return float((ref._union_state.x - step_x[:2].cpu()).abs().max())


def _step_n_scene(device):
    """``tests/test_torch_uipc_worlds.py``'s FEM scene at 16 envs: a (3, 3, 2)
    gel hung by its mount without a provider, and a (2, 2, 1) one falling
    onto the ground, each with its own model (3 Newton x 8 CG)."""
    from tacex_tpu_torch.physics.soft.mesh import box_tet_mesh
    from tacex_tpu_torch.uipc import StableNeoHookeanCfg, UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg

    sim = UipcSim(UipcSimCfg(dt=1 / 60, num_envs=UIPC_API_ENVS, enable_ground=True,
                             newton=UipcSimCfg.Newton(max_iter=3), linear_system=UipcSimCfg.LinearSystem(max_iter=8)),
                  device=device)
    con = UipcObjectCfg(constitution=StableNeoHookeanCfg(youngs_modulus=0.1))
    hung = UipcObject(con, sim, mesh=box_tet_mesh((0.03, 0.03, 0.01), (3, 3, 2), center=(0, 0, 0.05)))
    hung.set_attachments(np.where(hung.mesh.points[:, 2] > 0.055 - 1e-9)[0].astype(np.int32))
    UipcObject(con, sim, mesh=box_tet_mesh((0.02, 0.02, 0.01), (2, 2, 1), center=(0.1, 0, 0.006)))
    sim.setup_sim()
    return sim


def uipc_api_phase(device) -> dict:
    """The UIPC scene API (no K1/K2 on its path): the six example scenes at
    their own envs and meshes, their steps cut (``UIPC_EXAMPLES``); the
    full-width union scene at 16 envs (``uipc_union_scene``), its steps
    under sync-debug "error", with ms a step and a solve, the profiler's
    device activities and busy share, peak memory, the broad-phase counts,
    penetration and force checks, and envs 0-1 held to the CPU after one
    step; ``step_n`` against ``step``; a save/replay round trip; and the CCD
    envelope script inside and outside the envelope."""
    import runpy

    t_phase = time.perf_counter()
    out = {"examples": {}}
    for script, steps in UIPC_EXAMPLES.items():
        t0 = time.perf_counter()
        r = runpy.run_path(str(REPO / script))["main"](["--steps", str(steps), "--device", str(device)])
        x = r["x"]
        if not np.isfinite(x).all():
            raise AssertionError(f"uipc_api: {script} positions are not finite")
        name = Path(script).stem
        out["examples"][name] = dict(ms_per_step=r["ms_per_step"], steps=steps, shape=list(x.shape),
                                     seconds=time.perf_counter() - t0)
        if "overflow" in r:
            out["examples"][name]["overflow"] = {k: v.tolist() for k, v in r["overflow"].items()}
        print(f"uipc_api: {name} {tuple(x.shape)}: {steps} steps, {r['ms_per_step']:.1f} ms a step "
              f"(whole run {time.perf_counter() - t0:.1f} s)")

    n = UIPC_API_ENVS
    sim, bottom, top, drop = uipc_union_scene(device, n)
    drop["d"] = UIPC_API_DROP
    sim.step()  # warm-up
    _reset_counters()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2, UIPC_API_STEPS + 1):
            drop["d"] = UIPC_API_DROP * i
            if i == UIPC_API_REF_AFTER + 1:
                state_before = sim._union_state
            sim.step()
            if i == UIPC_API_REF_AFTER + 1:
                step_x = sim._union_state.x
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (UIPC_API_STEPS - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if _read_counters() != {"deformation_pyramid": 0, "lut_shade": 0}:
        raise AssertionError(f"uipc_api: the scene API launched {_read_counters()}, expected no kernel")
    ref_drop = drop["d"]
    drop["d"] = UIPC_API_DROP * (UIPC_API_REF_AFTER + 1)
    ref_err = _union_reference(sim, drop, state_before, step_x)
    drop["d"] = ref_drop
    if ref_err > UIPC_API_ATOL:
        raise AssertionError(f"uipc_api: envs 0-1 of the union step differ from the CPU by {ref_err:.3g} m")
    u = sim._union_state
    if not bool(torch.isfinite(u.x).all()):
        raise AssertionError("uipc_api: the union state is not finite")
    model = sim._union_model
    aim = sim._union_aim()
    scene = sim._scene(None)
    solve_ms = _host_ms(lambda: model.step(u, scene, aim), iters=1)
    activities, device_ms = _launch_count(lambda: sim.step())
    xb, xt = bottom.state.x, top.state.x
    face = torch.as_tensor(bottom.mesh.points[:, 2] > bottom.mesh.points[:, 2].max() - 1e-6, device=xb.device)
    rest_face_z = float(bottom.mesh.points[:, 2].max())
    descent = float((rest_face_z - xb[:, face, 2]).amax())
    gap = float((xt[..., 2].amin(-1) - xb[:, face, 2].amax(-1)).min())
    if descent < 1e-5:
        raise AssertionError(f"uipc_api: the top pad's force does not reach the bottom pad (descent {descent:.3g} m)")
    if gap < -1e-4:
        raise AssertionError(f"uipc_api: the pads interpenetrate (gap {gap:.3g} m)")
    overflow = {k: v.tolist() for k, v in sim.check_health().items()}
    print(f"uipc_api: union of two TetMeshCfg() pads, {n} envs, {model.mesh.num_vertices} vertices, self and edge-edge "
          f"contact K=4, {UIPC_API_STEPS - 1} steps with no host sync: {step_ms:.1f} ms a step (host clock, "
          f"synchronised; one solve alone {solve_ms:.1f} ms), {activities} device activities a step taking "
          f"{device_ms:.1f} ms of device time (torch.profiler; {100.0 * device_ms / step_ms:.1f}% busy), peak memory "
          f"{peak_gb:.3f} GB; bottom face pushed {1e3 * descent:.3f} mm, smallest pad gap {1e3 * gap:.3f} mm; "
          f"envs 0-1 vs the CPU after one step {ref_err:.3g} m; broad-phase drops {overflow}")
    out["union"] = dict(envs=n, vertices=model.mesh.num_vertices, step_ms=step_ms, solve_ms=solve_ms,
                        device_activities=activities, device_ms=device_ms, device_busy=device_ms / step_ms,
                        peak_gb=peak_gb, descent_mm=1e3 * descent, gap_mm=1e3 * gap, cpu_max_err=ref_err,
                        overflow=overflow)

    # save_frame / replay_frame: a later step and vertex write leave the snapshot as it was
    frame = sim.save_frame()
    saved = (bottom.state.x.clone(), top.state.x.clone())
    sim.step()
    top.write_vertex_positions_to_sim(top.init_vertex_pos)
    sim.replay_frame(frame)
    if not (torch.equal(bottom.state.x, saved[0]) and torch.equal(top.state.x, saved[1])):
        raise AssertionError("uipc_api: replay_frame did not restore the saved frame")
    del sim, bottom, top, u, model

    # step_n(n) against n steps, in deterministic mode (atomic sums would
    # otherwise order the HVPs' additions differently between the two runs)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = _step_n_scene(device), _step_n_scene(device)
        for _ in range(STEP_N_STEPS):
            a.step()
        b.step_n(STEP_N_STEPS)
        step_n_err = max(float((oa.state.x - ob.state.x).abs().max()) for oa, ob in zip(a.objects, b.objects))
    finally:
        torch.use_deterministic_algorithms(False)
    if step_n_err > 1e-6:
        raise AssertionError(f"uipc_api: step_n({STEP_N_STEPS}) differs from {STEP_N_STEPS} steps by {step_n_err:.3g} m")
    moved = float((a.objects[0].state.x - torch.as_tensor(a.objects[0].init_vertex_pos, device=device)).abs().max())
    print(f"uipc_api: step_n({STEP_N_STEPS}) vs {STEP_N_STEPS} steps at {UIPC_API_ENVS} envs: max difference "
          f"{step_n_err:.3g} m (the hung gel moved {1e3 * moved:.3f} mm); save/replay restored the frame exactly")
    out["step_n_max_err"] = step_n_err

    ccd = runpy.run_path(str(REPO / "scripts/benchmarking/ccd_envelope_torch.py"))["run"]
    rows = [ccd(1 / 60, vel, 1, device) for vel in (0.8, 1.6)]
    if rows[0]["tunneled"] or not rows[1]["tunneled"]:
        raise AssertionError(f"uipc_api: the CCD envelope rows are not inside / outside: {rows}")
    print("uipc_api: ccd_envelope", json.dumps(rows))
    out["ccd_envelope"] = rows
    out["seconds"] = time.perf_counter() - t_phase
    print(f"uipc_api: phase {out['seconds']:.1f} s")
    return out


def _abd_stack(n: int, bodies: int = 8, seed: int = 5):
    """numpy (q, qd) of the pile's cubes stacked in contact: each 0.6 mm over
    the ground or the cube below (inside d_hat = 1 mm), turned by a seeded
    5-20 mrad rotation, shifted up to 6 mm in x and y, falling at 5 cm/s."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, bodies, 12), np.float32)
    for e in range(n):
        for b in range(bodies):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
            a = rng.uniform(0.005, 0.02)
            q[e, b, 3:] = (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K).reshape(-1)
            q[e, b, :2] = rng.uniform(-0.006, 0.006, 2)
            q[e, b, 2] = 0.03 + 0.0006 + b * 0.0606
    qd = np.zeros_like(q)
    qd[..., 2] = -0.05
    return q, qd


def _abd_pile_run(solver: str, device) -> dict:
    """The pile at ABD_ENVS envs with one solver: a warm step, then
    ABD_STEPS steps: the first profiled, the others timed under sync-debug
    "error"; then envs 0-1 taken one more step on the card and on the CPU
    at ABD_REF_CFG."""
    import runpy

    from tacex_tpu_torch.physics.soft.abd import AbdState

    pile = runpy.run_path(str(REPO / "scripts/benchmarking/benchmark_abd_pile_torch.py"))["pile"]
    model, st, scene = pile(solver, ABD_ENVS, device=device)
    st = model.step(st, scene)  # warm-up
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    box = {}
    activities, device_ms = _launch_count(lambda: box.update(st=model.step(st, scene)))
    st = box["st"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(ABD_STEPS - 1):
            st = model.step(st, scene)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / (ABD_STEPS - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(st.q).all()):
        raise AssertionError(f"abd: the {solver} pile is not finite")
    x = model.world_points(st.q)
    lowest = float(scene.sdf(x).min())
    if lowest < -1e-3:
        raise AssertionError(f"abd: the {solver} pile went {-1e3 * lowest:.3f} mm into the ground")
    overflow = {k: int(v.sum()) for k, v in model.broad_phase_overflow(x).items()}
    # envs 0-1 one more step at the parity tests' iterations, on the card and on the CPU
    card, _, card_scene = pile(solver, 2, device=device, **ABD_REF_CFG)
    cpu, _, cpu_scene = pile(solver, 2, device="cpu", **ABD_REF_CFG)
    two = AbdState(q=st.q[:2].clone(), qd=st.qd[:2].clone())
    q_card = card.step(two, card_scene).q.cpu()
    q_cpu = cpu.step(_state_to(two, "cpu"), cpu_scene).q
    ref_err = float((q_card - q_cpu).abs().max())
    moved = float((q_cpu - two.q.cpu()).abs().max())
    if ref_err > ABD_REF_ATOL[solver]:
        raise AssertionError(f"abd: envs 0-1 of the {solver} pile differ from the CPU by {ref_err:.3g}")
    # the same in contact (``_abd_stack``), against the CPU step's own response
    # to a 1e-7 jolt of its input (a stiff stack amplifies f32 rounding)
    q0, qd0 = _abd_stack(2)
    jolt = np.random.default_rng(1).normal(0, 1e-7, q0.shape).astype(np.float32)
    steps = [cpu.step(AbdState(q=torch.from_numpy(q0 + d), qd=torch.from_numpy(qd0)), cpu_scene).q
             for d in (0.0, jolt)]
    noise = float((steps[1] - steps[0]).abs().max())
    stack_card = card.step(AbdState(q=torch.from_numpy(q0).to(device), qd=torch.from_numpy(qd0).to(device)),
                           card_scene).q.cpu()
    stack_err = float((stack_card - steps[0]).abs().max())
    stack_moved = float((steps[0] - torch.from_numpy(q0)).abs().max())
    if stack_err > max(ABD_REF_ATOL[solver], 4.0 * noise):
        raise AssertionError(f"abd: the {solver} stack in contact differs from the CPU by {stack_err:.3g} "
                             f"(the CPU's response to a 1e-7 jolt: {noise:.3g})")
    print(f"abd: pile of 8 cubes, {solver}, {ABD_ENVS} envs, {ABD_STEPS} steps (the first profiled, {ABD_STEPS - 1} "
          f"timed with no host sync): {step_ms:.1f} ms a step (host clock, synchronised), {activities} device "
          f"activities a step taking "
          f"{device_ms:.1f} ms of device time (torch.profiler; {100.0 * device_ms / step_ms:.1f}% busy), peak memory "
          f"{peak_gb:.3f} GB; lowest vertex {1e3 * lowest:.3f} mm over the ground; broad-phase drops {overflow}; "
          f"envs 0-1 vs the CPU after one step at {ABD_REF_CFG}: {ref_err:.3g} (the step moved q by {moved:.3g}); "
          f"stacked in contact: {stack_err:.3g} (moved {stack_moved:.3g}; the CPU's response to a 1e-7 jolt "
          f"{noise:.3g})")
    return dict(envs=ABD_ENVS, steps=ABD_STEPS, step_ms=step_ms, device_activities=activities, device_ms=device_ms,
                device_busy=device_ms / step_ms, peak_gb=peak_gb, lowest_mm=1e3 * lowest, overflow=overflow,
                cpu_max_err=ref_err, cpu_step_moved=moved, stack_cpu_max_err=stack_err, stack_moved=stack_moved,
                stack_cpu_jolt=noise)


def abd_phase(device) -> dict:
    """The standalone ABD solve (no K1/K2 on its path): the 8-cube pile at
    ABD_ENVS envs with the dense and the CG solve (``_abd_pile_run``), then
    the split ABD world of ``wrecking_balls`` and the thread contact of
    ``screw_and_nut`` at ABD_SAMPLE_STEPS steps, with their broad-phase
    counts."""
    import runpy

    t_phase = time.perf_counter()
    _reset_counters()
    out = {solver: _abd_pile_run(solver, device) for solver in ("dense", "cg")}
    for name in ("wrecking_balls", "screw_and_nut"):
        t0 = time.perf_counter()
        script = REPO / f"examples/libuipc_samples/{name}_torch.py"
        r = runpy.run_path(str(script))["main"](["--steps", str(ABD_SAMPLE_STEPS), "--device", str(device)])
        values = r["x"] if "x" in r else r["q"]
        if not np.isfinite(values).all():
            raise AssertionError(f"abd: {name} is not finite")
        overflow = {k: v.tolist() for k, v in r["overflow"].items()}
        out[name] = dict(steps=ABD_SAMPLE_STEPS, ms_per_step=r["ms_per_step"], overflow=overflow,
                         seconds=time.perf_counter() - t0)
        if name == "screw_and_nut":
            out[name]["dz_mm"] = 1e3 * r["dz"]
        print(f"abd: {name}: {ABD_SAMPLE_STEPS} steps, {r['ms_per_step']:.1f} ms a step (whole run "
              f"{time.perf_counter() - t0:.1f} s); broad-phase drops {overflow}"
              + (f"; screw advanced {1e3 * r['dz']:+.4f} mm" if name == "screw_and_nut" else ""))
    if _read_counters() != {"deformation_pyramid": 0, "lut_shade": 0}:
        raise AssertionError(f"abd: the ABD solve launched {_read_counters()}, expected no kernel")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"abd: phase {out['seconds']:.1f} s")
    return out


def _shell_start(n: int, seed: int = 7):
    """numpy (points (N, V, 3), static soup (Ts, 3, 3)) of the shell phase's
    scene: ``grid_cloth()``'s 20 x 20 cloth of 2 m (400 vertices, 722
    triangles) over an icosphere soup of radius 0.5 m whose top vertex lies
    SHELL_SOUP_GAP under the cloth, each env's cloth shifted by up to 2 cm
    in x and y (seeded)."""
    from tacex_tpu_torch.assets.meshes import icosphere
    from tacex_tpu_torch.physics.soft.shell import grid_cloth

    P, T = grid_cloth()
    soup = np.asarray(icosphere(0.5, 2), np.float32)
    soup[..., 2] += np.float32(P[0, 2] - SHELL_SOUP_GAP - soup[..., 2].max())
    shift = np.random.default_rng(seed).uniform(-0.02, 0.02, (n, 1, 3)).astype(np.float32)
    shift[..., 2] = 0.0
    return P[None] + shift, T, soup


def _shell_model(device, **cfg):
    """The phase's ``ShellModel`` (the bunny-cloth sample's constitution,
    ``ShellSolverCfg`` defaults unless ``cfg`` says otherwise) and its scene
    (the ground) for n envs."""
    from tacex_tpu_torch.physics.soft.ipc import RigidSdfScene
    from tacex_tpu_torch.physics.soft.shell import ShellModel, ShellSolverCfg

    pts, tris, soup = _shell_start(1)
    model = ShellModel(pts[0], tris, youngs_modulus=1e4, poisson_ratio=0.3, thickness=0.001, mass_density=200.0,
                       bending_stiffness=10.0, cfg=ShellSolverCfg(**cfg), static_tris=soup, device=device)

    def scene(n):
        sc = RigidSdfScene.empty(n, device=device)
        planes = torch.zeros_like(sc.planes)
        planes[..., 2] = 1.0
        return dataclasses.replace(sc, planes=planes)

    return model, scene


def _shell_clearance(model, x) -> float:
    """The cloth's least distance to its K nearest soup triangles (m)."""
    from tacex_tpu_torch.physics.soft.ipc import _nearest, _sq_dist

    cand = _nearest(_sq_dist(x, model.static_cent[None]), model.cfg.static_contact_k)[1]
    return float(model._static_distances(x, model.static_tris[cand]).min())


def shell_phase(device) -> dict:
    """Shells (no K1/K2 on their path): the standalone ``ShellModel`` on the
    20 x 20 cloth over the soup and the ground at SHELL_ENVS envs (a warm
    step, then SHELL_STEPS under sync-debug "error": the first profiled,
    the others timed), envs 0-1
    one more step on the card and on the CPU at SHELL_REF_CFG; the two cloth
    scenes at SHELL_SCENE_STEPS steps; a lone cloth with self contact
    through the union at SHELL_UNION_ENVS envs, SHELL_UNION_STEPS steps,
    with its broad-phase counts."""
    import runpy

    from tacex_tpu_torch.physics.soft.ipc import SoftBodyState

    t_phase = time.perf_counter()
    _reset_counters()
    out = {}
    model, scene_of = _shell_model(device)
    pts, _, _ = _shell_start(SHELL_ENVS)
    x0 = torch.as_tensor(pts, device=device)
    st, scene = SoftBodyState(x=x0.clone(), v=torch.zeros_like(x0)), scene_of(SHELL_ENVS)
    st = model.step(st, scene)  # warm-up
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    box = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        activities, device_ms = _launch_count(lambda: box.update(st=model.step(st, scene)))
        st = box["st"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHELL_STEPS - 1):
            st = model.step(st, scene)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    step_ms = 1e3 * (time.perf_counter() - t0) / (SHELL_STEPS - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not bool(torch.isfinite(st.x).all()):
        raise AssertionError("shell: the cloth is not finite")
    clearance = _shell_clearance(model, st.x)
    fell = float((x0[..., 2] - st.x[..., 2]).mean())
    if clearance <= 0.0 or fell <= 0.0:
        raise AssertionError(f"shell: clearance to the soup {clearance:.3g} m, mean fall {fell:.3g} m")
    # envs 0-1 one more step at the parity tests' iterations, on the card and on the CPU
    card, _ = _shell_model(device, **SHELL_REF_CFG)
    cpu, cpu_scene_of = _shell_model("cpu", **SHELL_REF_CFG)
    two = SoftBodyState(x=st.x[:2].clone(), v=st.v[:2].clone())
    x_card = card.step(two, scene_of(2)).x.cpu()
    two_cpu = _state_to(two, "cpu")
    x_cpu = cpu.step(two_cpu, cpu_scene_of(2)).x
    ref_err = float((x_card - x_cpu).abs().max())
    moved = float((x_cpu - two_cpu.x).abs().max())
    # the CPU step's own response to a 1e-7 m jolt of its input: the float noise of the solve
    jolt = torch.from_numpy(np.random.default_rng(1).normal(0, 1e-7, tuple(two_cpu.x.shape)).astype(np.float32))
    noise = float((cpu.step(SoftBodyState(x=two_cpu.x + jolt, v=two_cpu.v), cpu_scene_of(2)).x - x_cpu).abs().max())
    if ref_err > max(SHELL_REF_ATOL, 4.0 * noise):
        raise AssertionError(f"shell: envs 0-1 differ from the CPU by {ref_err:.3g} m (the CPU's response to a "
                             f"1e-7 m jolt: {noise:.3g} m)")
    out["standalone"] = dict(envs=SHELL_ENVS, vertices=model.num_vertices, triangles=int(model.tris.shape[0]),
                             steps=SHELL_STEPS, step_ms=step_ms, device_activities=activities, device_ms=device_ms,
                             device_busy=device_ms / step_ms, peak_gb=peak_gb, clearance_mm=1e3 * clearance,
                             cpu_max_err=ref_err, cpu_step_moved=moved, cpu_jolt=noise)
    print(f"shell: standalone ShellModel, {model.num_vertices} vertices, {int(model.tris.shape[0])} triangles, "
          f"{SHELL_ENVS} envs, {SHELL_STEPS} steps with no host sync (the first profiled, {SHELL_STEPS - 1} timed): "
          f"{step_ms:.1f} ms a step (host clock, "
          f"synchronised), {activities} device activities a step taking {device_ms:.1f} ms of device time "
          f"(torch.profiler; {100.0 * device_ms / step_ms:.1f}% busy), peak memory {peak_gb:.3f} GB; clearance to "
          f"the soup {1e3 * clearance:.3f} mm; envs 0-1 vs the CPU after one step at {SHELL_REF_CFG}: {ref_err:.3g} m "
          f"(the step moved {moved:.3g} m; the CPU's response to a 1e-7 m jolt {noise:.3g} m)")
    for rel in ("examples/cloth_trampoline_torch.py", "examples/libuipc_samples/bunny_cloth_torch.py"):
        t0 = time.perf_counter()
        r = runpy.run_path(str(REPO / rel))["main"](["--steps", str(SHELL_SCENE_STEPS), "--device", str(device)])
        if not np.isfinite(r["x"]).all():
            raise AssertionError(f"shell: {rel} is not finite")
        name = Path(rel).stem
        out[name] = dict(steps=SHELL_SCENE_STEPS, ms_per_step=r["ms_per_step"], seconds=time.perf_counter() - t0)
        print(f"shell: {name}: {SHELL_SCENE_STEPS} steps, {r['ms_per_step']:.1f} ms a step (whole run "
              f"{time.perf_counter() - t0:.1f} s)")
    out["union"] = _shell_union_run(device)
    if _read_counters() != {"deformation_pyramid": 0, "lut_shade": 0}:
        raise AssertionError(f"shell: the shell solves launched {_read_counters()}, expected no kernel")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"shell: phase {out['seconds']:.1f} s")
    return out


def _shell_union_run(device) -> dict:
    """A lone 20 x 20 cloth of 0.4 m with self contact (K = 4) over the
    bunny-cloth sample's kinematic icosphere: ``UipcSim`` routes it through
    the union model, the body its static soup. SHELL_UNION_STEPS steps at
    SHELL_UNION_ENVS envs, ms a step and the broad-phase counts."""
    from tacex_tpu_torch.assets.meshes import icosphere, weld_soup
    from tacex_tpu_torch.physics.soft.shell import grid_cloth
    from tacex_tpu_torch.uipc import UipcObject, UipcObjectCfg, UipcSim, UipcSimCfg
    from tacex_tpu_torch.uipc.objects import AffineBodyConstitutionCfg, NeoHookeanShellCfg

    sim = UipcSim(UipcSimCfg(num_envs=SHELL_UNION_ENVS, dt=0.01, enable_ground=True,
                             contact=UipcSimCfg.Contact(d_hat=0.004, self_contact_k=4)), device=device)
    bp, bt = weld_soup(icosphere(0.1, 1))
    UipcObject(UipcObjectCfg(constitution=AffineBodyConstitutionCfg(kinematic=True)), sim,
               points=bp + np.array([0.0, 0.0, 0.1], np.float32), triangles=bt)
    cp, ct = grid_cloth(20, 20, size=0.4, z=0.21)
    cloth = UipcObject(UipcObjectCfg(constitution=NeoHookeanShellCfg(), mass_density=200.0), sim,
                       points=cp, triangles=ct)
    sim.setup_sim()
    if cloth._union_range is None:
        raise AssertionError("shell: the self-contact cloth did not join the union")
    t0 = time.perf_counter()
    for _ in range(SHELL_UNION_STEPS):
        sim.step()
    step_ms = 1e3 * (time.perf_counter() - t0) / SHELL_UNION_STEPS
    x = cloth.nodal_pos_w
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("shell: the union cloth is not finite")
    overflow = {k: int(v.sum()) for k, v in sim.broad_phase_overflow().items()}
    print(f"shell: a lone cloth with self contact through the union, 400 vertices, {SHELL_UNION_ENVS} envs, "
          f"{SHELL_UNION_STEPS} steps: {step_ms:.1f} ms a step (host clock, synchronised); broad-phase drops "
          f"{overflow}")
    return dict(envs=SHELL_UNION_ENVS, steps=SHELL_UNION_STEPS, step_ms=step_ms, overflow=overflow)


def _grad_height_maps(n: int, hw, device):
    """(n, h, w) height maps (mm, 0 = gel top) of a 4 mm sphere pressed
    0.6-1.0 mm into the gel, its centre moved per env, and the ring weights
    of render's loss: 1 where a pixel lies 0.4-1.2 contact radii from its
    press's centre."""
    h, w = hw
    pixmm = 0.0295 * 640 / w
    i = torch.arange(n, device=device, dtype=torch.float32)
    # centres off the pixel grid: on a press's axis of symmetry the slope's
    # direction sits exactly on a LUT bin edge, where the bilinear shade's
    # derivative jumps and float noise picks the side
    cy = h / 2.0 + (i % 7 - 3.0) * h / 48.0 + 0.31
    cx = w / 2.0 + (torch.div(i, 7, rounding_mode="floor") % 7 - 3.0) * w / 64.0 + 0.37
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    r = torch.sqrt((yy - cy[:, None, None]) ** 2 + (xx - cx[:, None, None]) ** 2) * pixmm
    radius = 4.0
    z = torch.where(r < radius, radius - torch.sqrt(torch.clamp(radius * radius - r * r, min=0.0)), radius)
    press = 0.6 + 0.1 * (i % 5)
    contact = torch.sqrt(2.0 * radius * press - press * press)[:, None, None]
    ring = ((r > 0.4 * contact) & (r < 1.2 * contact)).to(torch.float32)
    return z - press[:, None, None], ring


def _render_weights(calib, hm, ring):
    """The weights of render's loss: the ring, less the pixels whose slope
    lies within EDGE_BINS of a LUT bin edge (there the bilinear shade's
    derivative jumps, and the card's and the CPU's float noise may take
    either side), times a fixed weight a channel."""
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    with torch.no_grad():
        deformed, _ = optical.compute_gel_deformation(calib, hm)
        grad_mag, grad_dir = optical.generate_normals(calib, -deformed / calib.sensor_params.pixmm)
    nb = calib.sensor_params.num_bins
    t_mag, t_dir = grad_mag / (0.5 * np.pi / (nb - 1)), (grad_dir + np.pi) / (2.0 * np.pi / (nb - 1))
    edge = torch.minimum((t_mag - torch.round(t_mag)).abs(), (t_dir - torch.round(t_dir)).abs())
    return (ring * (edge > EDGE_BINS))[..., None] * torch.tensor([0.7, 1.0, 1.3], device=ring.device)


def _render_grad(calib, hm, weights):
    """render(interp="bilinear")'s gradient in the height map of the loss
    sum(weights x image)."""
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    hm = hm.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((weights * optical.render(calib, hm, interp="bilinear")).sum(), hm)
    return g


def _pyramid_backward_entry(label, grad_out, mask, sigmas) -> dict:
    """K1's backward held to its plain adjoint (relative BACKWARD_RTOL) and
    timed; its bound is the forward's: the same taps, or the cotangent, the
    mask and the gradient once each."""
    from tacex_tpu_torch.ops import pyramid as K1

    out = K1.deformation_pyramid_backward(grad_out, mask, sigmas)
    ref = K1.deformation_pyramid_backward_plain(grad_out, mask, sigmas)
    torch.cuda.synchronize()
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    print(f"kernel deformation_pyramid_backward[{label}]: max_abs_err {err:.3e} of max |plain| {scale:.3e} "
          f"(rtol {BACKWARD_RTOL})")
    if not (bool(torch.isfinite(out).all()) and err <= BACKWARD_RTOL * scale and scale > 0):
        raise AssertionError(f"deformation_pyramid_backward[{label}] disagrees with its plain adjoint: {err} of {scale}")
    return dict(shape=list(grad_out.shape), design="global", max_abs_err=err,
                **_timing(lambda: K1.deformation_pyramid_backward(grad_out, mask, sigmas),
                          lambda: K1.deformation_pyramid_backward_plain(grad_out, mask, sigmas),
                          pyramid_bound(grad_out.shape, sigmas)))


def _gel_grad_inputs(env, steps: int):
    """The UIPC env pressed ``steps`` steps from its reset -> the gel's
    (model, state, scene, aim) of the next solve."""
    from tacex_tpu_torch.core import maths

    action = _uipc_action(env.cfg.num_envs, env.device)
    state, _ = env.reset_all(env.init_state())
    for _ in range(steps):
        state, *_ = env.step(state, action)
    tool_pos, tool_quat = env._tool_pose(state.base.arm.q)
    aim = maths.transform_points(env._gel_top_rest, tool_pos, tool_quat)
    return env.gel, state.gel, env._scene(state.base.ball_pos, env._planes), aim


def _gel_grad(model, state, scene, aim, weights):
    """One differentiable gel step -> the gradient of sum(weights x
    displacement) in (x, aim, the spheres)."""
    from tacex_tpu_torch.physics.soft import ipc

    x = state.x.detach().clone().requires_grad_(True)
    a = aim.detach().clone().requires_grad_(True)
    sph = scene.spheres.detach().clone().requires_grad_(True)
    out = model.step(ipc.SoftBodyState(x=x, v=state.v), dataclasses.replace(scene, spheres=sph), a)
    return torch.autograd.grad((weights * (out.x - x)).sum(), (x, a, sph))


def _timed_peak(fn) -> tuple[float, float]:
    """(host ms, peak GB of device memory) of one synchronised call."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), torch.cuda.max_memory_allocated() / 1e9


def grad_phase(device) -> dict:
    """Gradients on the card. K1's backward kernel at the flagship's, the
    sensor's and the calibration frame's shapes: each launched once by
    render's backward (counted), then held to its plain adjoint and timed;
    render(interp="bilinear")'s height-map gradient at 320x240 on
    GRAD_RENDER_ENVS envs against the CPU's; the UIPC gel's one-step
    gradient at its registered 16 envs (forward and backward under
    sync-debug "error", device ms, activities and peak memory beside the
    no-grad step's), and on 2 envs against the CPU's."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.ops import pyramid as K1
    from tacex_tpu_torch.sensors.gelsight.taxim import calib as tcalib
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    out, kernels, launches = {}, {}, {}
    full = tcalib.load_calib()
    g = torch.Generator(device=device).manual_seed(0)
    for n, h, w in GRAD_KERNEL_SHAPES:
        calib = full.at_resolution((h, w)).to(device)
        hm, ring = _grad_height_maps(n, (h, w), device)
        if bool((hm == calib.gel_map).any()):
            raise AssertionError("grad: a height equals the gel surface, where minimum's tie splits the gradient")
        _reset_counters()
        grad = _render_grad(calib, hm, ring[..., None].expand(n, h, w, 3))
        torch.cuda.synchronize()
        label = f"{n}x{h}x{w}"
        launches[label] = {**_read_counters(), "deformation_pyramid_backward": K1.deformation_pyramid.backward_launches}
        if launches[label] != {"deformation_pyramid": 1, "lut_shade": 0, "deformation_pyramid_backward": 1}:
            raise AssertionError(f"grad: render's gradient at {label} launched {launches[label]}")
        if not (bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0):
            raise AssertionError(f"grad: render's height-map gradient at {label} is not finite or zero")
        _, mask, sigmas = optical.deformation_inputs(calib, hm)
        cot = torch.randn((n, h, w), generator=g, device=device)
        kernels[f"pyramid backward {label}"] = _pyramid_backward_entry(label, cot, mask.contiguous(), sigmas)
        del calib, hm, ring, grad, mask, cot
    _print_entries(kernels)

    # render's height-map gradient, card against CPU, with no host sync on the card
    calib = full.at_resolution((240, 320))
    hm, ring = _grad_height_maps(GRAD_RENDER_ENVS, (240, 320), "cpu")
    weights = _render_weights(calib, hm, ring)
    cal_g, hm_g, w_g = calib.to(device), hm.to(device), weights.to(device)
    _render_grad(cal_g, hm_g, w_g)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_card = _render_grad(cal_g, hm_g, w_g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g_cpu = _render_grad(calib, hm, weights)
    rel = float(torch.linalg.vector_norm(g_card.cpu() - g_cpu) / torch.linalg.vector_norm(g_cpu))
    print(f"grad: render(interp='bilinear') height-map gradient at {GRAD_RENDER_ENVS}x240x320, cuda vs cpu: "
          f"relative {rel:.3e} (limit {GRAD_RENDER_RTOL}), ||g|| {float(torch.linalg.vector_norm(g_cpu)):.4e}")
    if not rel <= GRAD_RENDER_RTOL:
        raise AssertionError(f"grad: the card's render gradient disagrees with the CPU's: {rel}")
    out["render_320x240_rel"] = rel
    out["render_320x240_grad_ms"] = _host_ms(lambda: _render_grad(cal_g, hm_g, w_g), iters=3)
    del cal_g, hm_g, w_g, g_card

    # the gel at its registered 16 envs: no-grad step, then forward and backward
    env = envs.make(UIPC_IDS[0], device=device)
    model, state, scene, aim = _gel_grad_inputs(env, GRAD_GEL_PRESS_STEPS)
    n = env.cfg.num_envs
    weights = torch.randn(state.x.shape, generator=g, device=device)

    def plain_step():
        with torch.no_grad():
            return model.step(state, scene, aim)

    def grad_step():
        return _gel_grad(model, state, scene, aim, weights)

    plain_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = grad_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in grads) or float(grads[2].abs().max()) <= 0:
        raise AssertionError("grad: the gel's gradient is not finite, or the ball does not move the solve")
    gel = {}
    for tag, fn in (("no_grad", plain_step), ("grad", grad_step)):
        activities, device_ms = _launch_count(fn)
        host_ms, peak_gb = _timed_peak(fn)
        gel[tag] = dict(activities=activities, device_ms=device_ms, host_ms=host_ms, peak_gb=peak_gb)
        print(f"grad: gel step {tag} at {n} envs ({model.cfg.newton_max_iter} Newton x {model.cfg.cg_iters} CG): "
              f"{gel[tag]['host_ms']:.1f} ms host clock, {activities} device activities taking "
              f"{device_ms:.3f} ms of device time (torch.profiler), peak memory {gel[tag]['peak_gb']:.3f} GB")
    out["gel_16"] = gel

    # 2 envs, card against CPU, at GRAD_GEL_REF_CFG
    cpu = envs.make(UIPC_IDS[0], num_envs=2, device="cpu").gel
    registered = model.cfg
    def two(x, dev="cpu"):
        """The first 2 envs of a tensor or a dataclass of them, on ``dev``."""
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: two(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
        return None if x is None else x[:2].detach().to(dev)

    state_c, scene_c = two(state), two(scene)
    cpu.cfg = cpu.cfg.replace(**GRAD_GEL_REF_CFG)
    model.cfg = registered.replace(**GRAD_GEL_REF_CFG)
    try:
        g_card = _gel_grad(model, two(state, device), two(scene, device), aim[:2], weights[:2])
    finally:
        model.cfg = registered
    g_cpu = _gel_grad(cpu, state_c, scene_c, two(aim), two(weights))
    rels = {name: float(torch.linalg.vector_norm(a.cpu() - b) / torch.linalg.vector_norm(b))
            for name, a, b in zip(("x", "aim", "spheres"), g_card, g_cpu)}
    print(f"grad: gel one-step gradient, 2 envs at {GRAD_GEL_REF_CFG}, cuda vs cpu: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + f" (limit {GRAD_GEL_RTOL})")
    if not all(v <= GRAD_GEL_RTOL for v in rels.values()):
        raise AssertionError(f"grad: the card's gel gradient disagrees with the CPU's: {rels}")
    out["gel_reference_rel"] = rels
    out["launches"] = launches
    out["kernels"] = kernels
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not (REPO / "tacex_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} does not hold the tacex_tpu_torch package")
    sys.path[:0] = [str(REPO), str(REPO / "tests")]  # the port, and the bin rule of tests/_torch_bins.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tacex_tpu_torch.utils.profiling import device_label

    gpu = device_label("cuda")
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from tacex_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl.networks import ActorCritic

    device = torch.device("cuda")
    env = envs.make(ENV_ID, num_envs=NUM_ENVS, device=device)
    state, obs = env.reset_all(env.init_state())
    policy = ActorCritic(14, env.cfg.vision_obs_shape, env.cfg.action_space, device=device)
    policy.init_(torch.Generator(device=device).manual_seed(0))
    state, obs, *_ = env.step(state, _policy_action(policy, obs))

    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {seconds[name]} s")
        return result

    sensor = phase("sensor", sensor_phase, device)
    kernels, bf16 = phase("kernel", kernel_phase, env, state, device, sensor.pop("frame"), sensor.pop("lut"))
    calib = phase("calib", calib_frame_phase, device)
    kernels.update(calib.pop("kernels"))
    run = phase("slice", slice_phase, env, state, obs, policy)
    phase("reference", reference_phase, device)
    del env, state, obs, policy
    train = phase("train", train_phase, device)
    privileged = phase("privileged_train", privileged_train_phase, device)
    parallel = phase("parallel", parallel_phase, device)
    phase("env", env_phase, device)
    shading = phase("shading", shading_phase, device)
    factory = phase("factory", factory_phase, device)
    factory_train = phase("factory_train", factory_train_phase, device)
    pole = phase("pole", pole_phase, device)
    sac = phase("sac", sac_phase, device)
    uipc = phase("uipc", uipc_phase, device)
    tools = phase("tools", tools_phase, device)
    coupled = phase("coupled", coupled_phase, device)
    uipc_api = phase("uipc_api", uipc_api_phase, device)
    abd = phase("abd", abd_phase, device)
    shell = phase("shell", shell_phase, device)
    grad = phase("grad", grad_phase, device)

    kernels.update(shading.pop("kernels"))
    kernels.update(factory.pop("kernels"))
    kernels.update(uipc.pop("kernels"))
    kernels.update(coupled.pop("kernels"))
    kernels.update(tools.pop("kernels"))
    kernels.update(grad.pop("kernels"))
    sources = {
        "deformation_pyramid": ("tacex_tpu_torch/csrc/pyramid.cu", "tacex_tpu/ops/pallas_pyramid.py:61"),
        "lut_shade": ("tacex_tpu_torch/csrc/lut_shade.cu", "tacex_tpu/ops/pallas_lut.py:63"),
        "lut_shade_bf16": ("tacex_tpu_torch/csrc/lut_shade.cu", "tacex_tpu/ops/pallas_lut.py:63"),
        # the gradient of K1 (the TPU package has no backward kernel: XLA differentiates its plain blur)
        "deformation_pyramid_backward": ("tacex_tpu_torch/csrc/pyramid.cu", "tacex_tpu/ops/pallas_pyramid.py:61"),
    }
    # (kernel, entry, the main path that runs it at that shape, its launches there)
    rows = (
        ("deformation_pyramid", "pyramid warp 24x32", "ppo_train_4096", train["launches"]),
        ("deformation_pyramid", "pyramid warp 32x32", "factory_step_128", factory["launches"]),
        ("deformation_pyramid", "pyramid cluster 240x320", "sensor_320x240_256", sensor["launches"]),
        ("lut_shade", "lut full table 4096x768", "ppo_train_4096", train["launches"]),
        ("lut_shade", "lut subtable 4096x768", "compact_render_320x240_16", shading["compact_launches"]),
        ("lut_shade", "lut full table 256x1024", "factory_step_128", factory["launches"]),
        ("lut_shade", "lut full table 256x76800", "sensor_320x240_256", sensor["launches"]),
        ("deformation_pyramid", "pyramid warp 16x24x32", "uipc_step_16", uipc["launches"]),
        ("lut_shade", "lut full table 16x768", "uipc_step_16", uipc["launches"]),
        ("deformation_pyramid", "pyramid warp 64x24x32", "uipc_embedded_step_64", uipc["embedded_64"]["launches"]),
        ("lut_shade", "lut full table 64x768", "uipc_embedded_step_64", uipc["embedded_64"]["launches"]),
        ("deformation_pyramid", "pyramid global 480x640", "sensor_640x480_4", calib["launches"]),
        ("deformation_pyramid", "pyramid warp 32x32x32", "grasp_lift_tactile_step_16", coupled["launches"]),
        ("lut_shade", "lut full table 32x1024", "grasp_lift_tactile_step_16", coupled["launches"]),
        ("deformation_pyramid", "pyramid cluster 26x240x320", "check_taxim_26", tools["launches"]),
        ("lut_shade", "lut full table 26x76800", "check_taxim_26", tools["launches"]),
        ("deformation_pyramid", "pyramid cluster 1x240x320", "follow_goal_1", tools["follow_goal"]["launches"]),
        ("lut_shade", "lut full table 1x76800", "follow_goal_1", tools["follow_goal"]["launches"]),
        ("deformation_pyramid", "pyramid cluster 2x240x320", "pick_up_rigid_2", tools["pick_up_rigid"]["launches"]),
        ("lut_shade", "lut full table 2x76800", "pick_up_rigid_2", tools["pick_up_rigid"]["launches"]),
        ("deformation_pyramid", "pyramid cluster 2x240x320", "pick_up_uipc_2", tools["pick_up_uipc"]["launches"]),
        ("lut_shade", "lut full table 2x76800", "pick_up_uipc_2", tools["pick_up_uipc"]["launches"]),
        ("lut_shade_bf16", "lut bf16 full table 4096x768", "render_bf16_24x32_4096", bf16["render_bf16_24x32_4096"]),
        ("lut_shade_bf16", "lut bf16 full table 256x76800", "render_bf16_320x240_256", sensor["bf16_launches"]),
        ("lut_shade_bf16", "lut bf16 compact contact rows", "compact_render_bf16_320x240_16", shading["compact_bf16"]),
    ) + tuple(
        ("deformation_pyramid_backward", f"pyramid backward {n}x{h}x{w}", f"render_grad_{n}x{h}x{w}",
         grad["launches"][f"{n}x{h}x{w}"])
        for n, h, w in GRAD_KERNEL_SHAPES
    )
    report = {
        "kernels": [
            dict(name=f"{name}[{label}]", route="cuda", source=sources[name][0], replaces=sources[name][1],
                 launches=launches[name], path=path, **kernels[label])
            for name, label, path, launches in rows
        ],
        "gpu": gpu,
        "num_envs": NUM_ENVS,
        "steps": STEPS,
        "env_steps_per_s": run["env_steps_per_s"],
        "step_ms": run["step_ms"],
        "peak_memory_gb": run["peak_gb"],
        "sensor_320x240_update_ms": sensor["update_ms"],
        "sensor_envs": SENSOR_ENVS,
        "sensor_worst_edge_bins": sensor["worst_edge_bins"],
        "train": {k: v for k, v in train.items() if k != "launches"},
        "privileged_train": privileged,
        "shading_320x240_16_ms": {k: v for k, v in shading.items() if k not in ("compact_launches", "compact_bf16")},
        "parallel": parallel,
        "factory": factory,
        "factory_train": factory_train,
        "pole": pole,
        "sac": sac,
        "uipc": {k: v for k, v in uipc.items() if k != "launches"},
        "coupled": {k: v for k, v in coupled.items() if k != "launches"},
        "tools": tools,
        "sensor_640x480_update_ms": calib["update_ms"],
        "uipc_api": uipc_api,
        "abd": abd,
        "shell": shell,
        "grad": {k: v for k, v in grad.items() if k != "launches"},
        "phase_seconds": seconds,
    }
    print(json.dumps(report))
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": card}))


if __name__ == "__main__":
    main()
