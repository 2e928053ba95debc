#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship env step once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and the repository's ``tacex_tpu_torch``
package beside this file; it imports nothing of JAX. In order it:

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the CUDA kernels from ``tacex_tpu_torch/csrc`` for sm_90a;
  3. holds each kernel against its plain PyTorch version at the main path's
     shapes (atol 1e-5: sums run in another order and nvcc contracts to FMA)
     and times both with CUDA events;
  4. runs ``TacEx-Ball-Rolling-Taxim-Fots-v0`` at 4096 envs with the
     actor-critic's mean action (plus -0.1 on z, so the gel presses the
     ball) in the loop; the steady steps run under
     ``torch.cuda.set_sync_debug_mode("error")``, so any host sync raises;
     checks every output is finite, that the gel is pressed, and that both
     kernels were launched on every step;
  5. steps the env at 8 envs on the card (kernels) and on the CPU (plain
     versions) from one state and holds the two to each other.

The second-to-last line is a JSON object with each kernel's launches on the
main path, its error against the plain version and both times; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ENV_ID = "TacEx-Ball-Rolling-Taxim-Fots-v0"
NUM_ENVS = 4096
WARMUP_STEPS = 2
STEPS = 10
KERNEL_ATOL = 1e-5
REPO = Path(__file__).resolve().parent


def _timed_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def kernel_phase(env, state, device) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from tacex_tpu_torch.ops import lut_shade as K2
    from tacex_tpu_torch.ops import pyramid as K1
    from tacex_tpu_torch.sensors.gelsight.taxim.params import load_params
    from tacex_tpu_torch.sensors.gelsight.taxim.calib import default_calib_folder

    calib = env.sensor.calib
    joined, mask, sigmas, idx, idir = _frame(env, state)
    results = {}

    def compare(name, out, ref):
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        print(f"kernel {name}: shape {tuple(out.shape)} max_abs_err {err:.3e} (atol {KERNEL_ATOL})")
        if not finite or not err <= KERNEL_ATOL:
            raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}, finite {finite}")
        return err

    # K1 on the frame (4096, 24, 32), then on a ragged (5, 48, 64) batch
    err1 = compare("deformation_pyramid", K1.deformation_pyramid(joined, mask, sigmas),
                   K1.deformation_pyramid_plain(joined, mask, sigmas))
    sim = load_params(default_calib_folder())[0]
    sig48 = list(sim.deform_pyramid_sigma((48, 64))) + [sim.deform_final_sigma((48, 64))]
    g = torch.Generator(device=device).manual_seed(0)
    j48 = torch.rand((5, 48, 64), generator=g, device=device) * 3.0 - 1.0
    m48 = torch.rand((5, 48, 64), generator=g, device=device) < 0.2
    err1 = max(err1, compare("deformation_pyramid[5x48x64]", K1.deformation_pyramid(j48, m48, sig48),
                             K1.deformation_pyramid_plain(j48, m48, sig48)))
    results["deformation_pyramid"] = dict(
        max_abs_err=err1,
        ms=_timed_ms(lambda: K1.deformation_pyramid(joined, mask, sigmas)),
        plain_ms=_timed_ms(lambda: K1.deformation_pyramid_plain(joined, mask, sigmas)),
    )

    # K2 with the full 15,625-row table at (4096, 768), then the 125-row
    # magnitude-bin-0 subtable through dir_row_shade (P = 768)
    nb = calib.sensor_params.num_bins
    table = calib.poly_lut.reshape(nb * nb, 18)
    feats = calib.features
    err2 = compare("lut_shade", K2.lut_shade(idx, feats, table), K2.lut_shade_plain(idx, feats, table))
    tabs = torch.zeros((18, 128), device=device)
    tabs[:, :nb] = table[:nb].T
    err2 = max(err2, compare("dir_row_shade", K2.dir_row_shade(idir, feats, tabs),
                             K2.lut_shade_plain(idir, feats, tabs.T)))
    results["lut_shade"] = dict(
        max_abs_err=err2,
        ms=_timed_ms(lambda: K2.lut_shade(idx, feats, table)),
        plain_ms=_timed_ms(lambda: K2.lut_shade_plain(idx, feats, table)),
    )
    for name, r in results.items():
        print(f"kernel {name}: {r['ms']:.4f} ms, plain PyTorch {r['plain_ms']:.4f} ms")
    return results


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
    from tacex_tpu_torch.ops import lut_shade as K2
    from tacex_tpu_torch.ops import pyramid as K1

    for _ in range(WARMUP_STEPS):
        state, obs, *_ = env.step(state, _policy_action(policy, obs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.deformation_pyramid.launches = 0
    K2.lut_shade.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEPS):
            state, obs, reward, term, trunc, info = env.step(state, _policy_action(policy, obs))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = {"deformation_pyramid": K1.deformation_pyramid.launches, "lut_shade": K2.lut_shade.launches}
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

    kernels = kernel_phase(env, state, device)
    run = slice_phase(env, state, obs, policy)
    reference_phase(device)

    sources = {
        "deformation_pyramid": ("tacex_tpu_torch/csrc/pyramid.cu", "tacex_tpu/ops/pallas_pyramid.py:61"),
        "lut_shade": ("tacex_tpu_torch/csrc/lut_shade.cu", "tacex_tpu/ops/pallas_lut.py:63"),
    }
    report = {
        "kernels": [
            dict(name=name, route="cuda", source=src, replaces=rep, launches=run["launches"][name], **kernels[name])
            for name, (src, rep) in sources.items()
        ],
        "gpu": gpu,
        "num_envs": NUM_ENVS,
        "steps": STEPS,
        "env_steps_per_s": run["env_steps_per_s"],
        "step_ms": run["step_ms"],
        "peak_memory_gb": run["peak_gb"],
    }
    print(json.dumps(report))
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": card}))


if __name__ == "__main__":
    main()
