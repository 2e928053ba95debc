#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: the flagship env step,
PPO training on it, the other ball-rolling tasks and every shading path.

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
     (``embedding_bag``, timed here only: the port never calls it);
  5. runs ``TacEx-Ball-Rolling-Taxim-Fots-v0`` at 4096 envs with the
     actor-critic's mean action (plus -0.1 on z, so the gel presses the
     ball) in the loop; the steady steps run under
     ``torch.cuda.set_sync_debug_mode("error")``, so any host sync raises;
     checks every output is finite, that the gel is pressed, and that both
     kernels were launched on every step;
  6. steps the env at 8 envs on the card (kernels) and on the CPU (plain
     versions) from one state and holds the two to each other;
  7. trains: ``PPO`` on the flagship at 4096 envs under its tuned config
     (rollouts of 64, 4 epochs of 32 minibatches of 8,192 samples), one
     warm-up iteration and two timed ones, the second under sync-debug
     "error"; checks that loss and reward are finite, every parameter
     moved, the step count, the learning rate's range and that both kernels
     ran once per rollout step; prints seconds per iteration, env-steps/s,
     the rollout/update split (CUDA events) and peak memory;
  8. trains ``TacEx-Ball-Rolling-Privileged-v0`` at 4096 envs under its state
     config for 10 iterations and prints each one's reward per step;
  9. resets and steps each of the other five ball-rolling ids at 256 envs
     under sync-debug "error", checks the observation shapes, and holds the
     two IK resets' joint angles to the same solve on the CPU (atol 1e-4);
 10. at 320x240 on 16 pressed envs, holds ``render(with_shadow=True)``,
     ``shade(interp="bilinear")`` and ``render(compact_capacity=16384)`` on
     the card to the same calls on the CPU, times each, checks the compact
     call launched the shading kernel, and that the pyramid wrapper refuses
     a CUDA input that requires grad.

The second-to-last line is a JSON object with each kernel's launches on
each path, its error against the plain version, its times, bound and share
of the bound; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
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
TRAIN_ITERATIONS = 3  # one warm-up, two timed
PRIVILEGED_ITERATIONS = 10
OTHER_ENVS = 256
SHADING_ENVS = 16
COMPACT_CAPACITY = 16384
WARMUP_STEPS = 2
STEPS = 10
KERNEL_ATOL = 1e-5
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
    """The tactile frame of ``state`` up to the kernels' inputs: the pyramid's
    (joined, mask, sigmas) and, after the deformation, the LUT indices."""
    from tacex_tpu_torch.envs.ball_rolling.env import CAM_EXTENT
    from tacex_tpu_torch.render.depth_camera import SdfScene, render_depth_batch
    from tacex_tpu_torch.sensors.gelsight.taxim import optical

    c, sensor = env.cfg, env.sensor
    n = c.num_envs
    tool_pos, tool_quat = env._tool_pose(state.arm.q)
    cam_pos, cam_quat = env._camera_pose(tool_pos, tool_quat)
    radius = torch.full((n, 1), c.ball_radius, device=env.device)
    scene = SdfScene(torch.cat([state.ball_pos, radius], -1)[:, None], env._boxes, env._capsules, env._planes)
    depth = render_depth_batch(cam_pos, cam_quat, scene, tuple(c.camera_resolution), CAM_EXTENT, far=c.sensor_clipping[1])
    hm = sensor.height_map_from_depth(depth)
    shifted = optical.shift_height_map(hm, sensor.compute_indentation_depth(hm))
    joined, mask, sigmas = optical.deformation_inputs(sensor.calib, shifted)
    deformed, _ = optical.compute_gel_deformation(sensor.calib, shifted)
    grad_mag, grad_dir = optical.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm)
    idx_mag, idx_dir = optical.lut_bins(sensor.calib, grad_mag, grad_dir)
    nb = sensor.calib.sensor_params.num_bins
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


def lut_bound(n, p, rows) -> tuple[float, str]:
    """K2 reads the indices (i32), the features (6 x P f32) and the table
    (R x 18 f32) once and writes (n, P, 3) f32; 18 FMAs a pixel."""
    return _bound(4 * n * p + 24 * p + 72 * rows + 12 * n * p, 36.0 * n * p)


def _timing(fn, plain, nbytes_flops) -> dict:
    ms, host_ms = _timed_ms(fn)
    bound_ms, bound_by = nbytes_flops
    return dict(ms=ms, plain_ms=_timed_ms(plain)[0], bound_ms=bound_ms, bound_by=bound_by,
                pct_of_bound=100.0 * bound_ms / ms, host_ms=host_ms)


def _compare(name, out, ref) -> float:
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    finite = bool(torch.isfinite(out).all())
    print(f"kernel {name}: shape {tuple(out.shape)} max_abs_err {err:.3e} (atol {KERNEL_ATOL})")
    if not finite or not err <= KERNEL_ATOL:
        raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}, finite {finite}")
    return err


def kernel_phase(env, state, device, sensor_frame, sensor_lut) -> dict:
    """Each kernel against its plain version at the main path's shapes, and
    at the default sensor's (256, 240, 320) frame."""
    from tacex_tpu_torch.ops import lut_shade as K2
    from tacex_tpu_torch.ops import pyramid as K1

    calib = env.sensor.calib
    joined, mask, sigmas, idx, idir = _frame(env, state)

    # K1 on the frame (4096, 24, 32), on a ragged (5, 48, 64) batch, and on
    # the sensor's (256, 240, 320) frame
    err1 = _compare("deformation_pyramid", K1.deformation_pyramid(joined, mask, sigmas),
                    K1.deformation_pyramid_plain(joined, mask, sigmas))
    sig48 = sensor_sigmas((48, 64))
    g = torch.Generator(device=device).manual_seed(0)
    j48 = torch.rand((5, 48, 64), generator=g, device=device) * 3.0 - 1.0
    m48 = torch.rand((5, 48, 64), generator=g, device=device) < 0.2
    err48 = _compare("deformation_pyramid[5x48x64]", K1.deformation_pyramid(j48, m48, sig48),
                     K1.deformation_pyramid_plain(j48, m48, sig48))
    jb, mb, sb = sensor_frame
    errb = _compare("deformation_pyramid[256x240x320]", K1.deformation_pyramid(jb, mb, sb),
                    K1.deformation_pyramid_plain(jb, mb, sb))
    k1 = dict(shape=list(joined.shape), max_abs_err=max(err1, err48, errb),
              **_timing(lambda: K1.deformation_pyramid(joined, mask, sigmas),
                        lambda: K1.deformation_pyramid_plain(joined, mask, sigmas),
                        pyramid_bound(joined.shape, sigmas)),
              library_ms=None)
    k1["other_shapes"] = [dict(shape=list(jb.shape), max_abs_err=errb,
                               **_timing(lambda: K1.deformation_pyramid(jb, mb, sb),
                                         lambda: K1.deformation_pyramid_plain(jb, mb, sb),
                                         pyramid_bound(jb.shape, sb)))]

    # K2 with the full 15,625-row table at (4096, 768), then the 125-row
    # magnitude-bin-0 subtable through dir_row_shade (P = 768)
    nb = calib.sensor_params.num_bins
    table = calib.poly_lut.reshape(nb * nb, 18)
    feats = calib.features
    err2 = _compare("lut_shade", K2.lut_shade(idx, feats, table), K2.lut_shade_plain(idx, feats, table))
    tabs = torch.zeros((18, 128), device=device)
    tabs[:, :nb] = table[:nb].T
    err2 = max(err2, _compare("dir_row_shade", K2.dir_row_shade(idir, feats, tabs),
                              K2.lut_shade_plain(idir, feats, tabs.T)))
    # the library yardstick: one embedding_bag over bags of the pixel's six
    # 3-float LUT entries, weighted by its features (inputs built untimed)
    n, p = idx.shape
    bags = (idx.long()[..., None] * 6 + torch.arange(6, device=device)).reshape(n * p, 6)
    weights = feats.T.expand(n, p, 6).reshape(n * p, 6).contiguous()
    entries = table.reshape(-1, 3)
    library = lambda: torch.nn.functional.embedding_bag(bags, entries, per_sample_weights=weights, mode="sum")
    _compare("embedding_bag (library yardstick)", library().reshape(n, p, 3), K2.lut_shade_plain(idx, feats, table))
    k2 = dict(shape=[n, p, table.shape[0]], max_abs_err=err2,
              **_timing(lambda: K2.lut_shade(idx, feats, table), lambda: K2.lut_shade_plain(idx, feats, table),
                        lut_bound(n, p, table.shape[0])),
              library_ms=_timed_ms(library)[0])
    # K2 on the sensor frame's (256, 76800) pixels, 75 blocks of pixels wide
    ib, fb, tb = sensor_lut
    err2b = _compare("lut_shade[256x76800]", K2.lut_shade(ib, fb, tb), K2.lut_shade_plain(ib, fb, tb))
    k2["max_abs_err"] = max(err2, err2b)
    k2["other_shapes"] = [dict(shape=[*ib.shape, tb.shape[0]], max_abs_err=err2b,
                               **_timing(lambda: K2.lut_shade(ib, fb, tb), lambda: K2.lut_shade_plain(ib, fb, tb),
                                         lut_bound(*ib.shape, tb.shape[0])))]
    shown = (("deformation_pyramid", k1), ("deformation_pyramid", k1["other_shapes"][0]), ("lut_shade", k2),
             ("lut_shade", k2["other_shapes"][0]))
    for name, r in shown:
        lib = "" if r.get("library_ms") is None else f", library call {r['library_ms']:.4f} ms"
        print(f"kernel {name} {r['shape']}: {r['ms']:.4f} ms, plain PyTorch {r['plain_ms']:.4f} ms{lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['pct_of_bound']:.1f}% of bound; "
              f"host {r['host_ms']:.4f} ms a call")
    return {"deformation_pyramid": k1, "lut_shade": k2}


def _counters():
    from tacex_tpu_torch.ops import lut_shade as K2
    from tacex_tpu_torch.ops import pyramid as K1

    return K1.deformation_pyramid, K2.lut_shade


def _reset_counters() -> None:
    for fn in _counters():
        fn.launches = 0


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
    deformed, _ = optical.compute_gel_deformation(sensor.calib, shifted)
    grad_mag, grad_dir = optical.generate_normals(sensor.calib, -deformed / sensor.calib.sensor_params.pixmm)
    bins = optical.lut_bins(sensor.calib, grad_mag, grad_dir)
    return (joined.contiguous(), mask.contiguous(), sigmas), grad_mag, grad_dir, bins


def sensor_phase(device) -> dict:
    """The default GelSight Mini sensor (320x240 Taxim + FOTS) on 256 envs:
    one update counted, its time, and 2 envs held to the CPU's."""
    sys.path.insert(0, str(REPO / "tests"))
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
    return dict(launches=launches, update_ms=update_ms, frame=frame, lut=lut, worst_edge_bins=worst_edge)


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

    outputs = {"state": state, "obs": obs, "reward": reward, "indentation_depth": info["indentation_depth"]}
    for name, t in _tensors(outputs):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
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
        for name, t in _tensors({"state": state, "obs": obs, "reward": reward}):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{env_id}: {name} is not finite")
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
    from tacex_tpu_torch.ops import pyramid as K1
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
    before = K2.lut_shade.launches
    comp_g = optical.render(cal_g, shifted, compact_capacity=COMPACT_CAPACITY)
    if K2.lut_shade.launches != before + 1:
        raise AssertionError("the compact shade path did not launch the shading kernel")
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

    joined = torch.zeros((1, 24, 32), device=device, requires_grad=True)
    try:
        K1.deformation_pyramid(joined, torch.zeros((1, 24, 32), dtype=torch.bool, device=device), sensor_sigmas((24, 32)))
    except RuntimeError as err:
        if "no backward kernel" not in str(err):
            raise
    else:
        raise AssertionError("deformation_pyramid took a CUDA input that requires grad")
    return dict(shadow_ms=shadow_ms, dense_ms=dense_ms, bilinear_ms=bil_ms, compact_ms=comp_ms)


def _state_to(state, device):
    """A copy of a port state on ``device``."""
    if dataclasses.is_dataclass(state):
        return type(state)(**{f.name: _state_to(getattr(state, f.name), device) for f in dataclasses.fields(state)})
    return state.to(device)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not (REPO / "tacex_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} does not hold the tacex_tpu_torch package")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
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

    sensor = sensor_phase(device)
    kernels = kernel_phase(env, state, device, sensor["frame"], sensor["lut"])
    run = slice_phase(env, state, obs, policy)
    reference_phase(device)
    del env, state, obs, policy
    train = train_phase(device)
    privileged = privileged_train_phase(device)
    env_phase(device)
    shading = shading_phase(device)

    sources = {
        "deformation_pyramid": ("tacex_tpu_torch/csrc/pyramid.cu", "tacex_tpu/ops/pallas_pyramid.py:61"),
        "lut_shade": ("tacex_tpu_torch/csrc/lut_shade.cu", "tacex_tpu/ops/pallas_lut.py:63"),
    }
    report = {
        "kernels": [
            dict(name=name, route="cuda", source=src, replaces=rep, launches=train["launches"][name],
                 paths={"ppo_train_4096": train["launches"][name], "env_step_4096": run["launches"][name],
                        "sensor_320x240_256": sensor["launches"][name]},
                 **kernels[name])
            for name, (src, rep) in sources.items()
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
        "shading_320x240_16_ms": shading,
    }
    print(json.dumps(report))
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": card}))


if __name__ == "__main__":
    main()
