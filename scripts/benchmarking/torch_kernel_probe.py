#!/usr/bin/env python3
"""Probe the PyTorch/CUDA port's two kernels on one NVIDIA GPU.

    python3 scripts/benchmarking/torch_kernel_probe.py [--baseline CSRC_DIR]

Needs one CUDA device and ``nvcc``; imports nothing of JAX. It prints, after
the card's name and power limit:

  * the deformation pyramid's cluster design at the default sensor's
    (256, 240, 320) frame (random input, the sensor's sigmas): its time, how
    many clusters the card holds at once, the time of each phase of the
    first CTA's run per level (from ``clock64``, in a copy of
    ``csrc/pyramid.cu`` that this script instruments) with the bytes its
    halo reads move, and the time for single levels and for fewer images;
  * the LUT shading at (4096, 768) with the 15,625-row table, on the indices
    of a flagship frame and on uniformly random rows, for each pair of
    envs-per-block and threads-per-block constants in a copy of
    ``csrc/lut_shade.cu`` (the shipped pair is 8 x 256);
  * with ``--baseline``, the kernels of another version of ``csrc``
    (``pyramid.cu`` and ``lut_shade.cu`` with the same C interface, e.g. a
    ``git archive`` of an earlier commit) beside this tree's, at the
    flagship shapes and at the Factory PegInsert frame (the 256 finger
    images of 32x32 at 128 envs), in the order baseline, this tree, this
    tree, baseline, each timed both ways below.

Times are device times from CUDA events around calls queued behind a spin on
the card (``chip_smoke._timed_ms``). The baseline comparison also gives the
back-to-back time: CUDA events around calls issued one after another, which
time the host whenever a call's host cost exceeds its kernel's.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tacex_tpu_torch.ops import _build  # noqa: E402
from tacex_tpu_torch.ops import lut_shade as K2  # noqa: E402
from tacex_tpu_torch.ops import pyramid as K1  # noqa: E402

PHASES = ("level start", "wait: bands final", "halo read (DSMEM)", "H pass", "W halo", "wait: reads done", "W pass")
ENVS_PER_BLOCK = (4, 8, 16, 32)
THREADS = (64, 128, 256)
PTR, I32 = ctypes.c_void_p, ctypes.c_int
PYRAMID_ARGS = [PTR, PTR, PTR, PTR, PTR, PTR, I32, I32, I32, I32, PTR]
LUT_ARGS = [PTR, PTR, PTR, PTR, I32, I32, I32, PTR]

# The cluster kernel's phase clocks and the occupancy query, added to a copy
# of csrc/pyramid.cu: PHASE() goes before each anchor line, in this order.
PHASE_ANCHORS = (
    "  extern __shared__ float4 smem4[];",
    "  // the band of joined (into pin)",
    "  cluster_arrive();  // this band is in place",
    "    // halo rows [rad - ry, rad)",
    "    const int per_row = wx / 4;",
    "    cluster_arrive_relaxed();  // this CTA has read",
    "    // the W pass's reflected halo",
    "    cluster_wait();  // no CTA reads this band",
    "    // W pass, then the re-pin, into the band",
    "    cluster_arrive();  // this band is final for the level",
    "  for (int i = tid; i < nk * w; i += nt) {",
)
PHASE_CLOCK = """
__device__ long long g_phase_clock[256];
#define PHASE()                                                                                   \\
  do {                                                                                            \\
    if (blockIdx.x == 0 && threadIdx.x == 0 && phase < 256) g_phase_clock[phase++] = clock64(); \\
  } while (0)

"""
PROBE_EXPORTS = """
// The phase clocks of the last cluster-design launch's first CTA.
extern "C" int tacex_deformation_pyramid_phase_clock(long long* out) {
  return cudaMemcpyFromSymbol(out, g_phase_clock, sizeof(g_phase_clock));
}

// How many clusters of the cluster design the card holds at once for an
// h x w image (0: not the cluster design; negative: a CUDA error).
extern "C" int tacex_deformation_pyramid_active_clusters(int h, int w, const float* taps, const int* ky,
                                                          const int* kx, int levels) {
  ClusterParams c{};
  if (!valid_taps(h, w, ky, kx, levels) || warp_path(h, w, ky, kx, levels) ||
      !cluster_params(h, w, taps, ky, kx, levels, &c))
    return 0;
  cudaError_t err = cudaFuncSetAttribute(pyramid_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(c.smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(c, 1024, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, pyramid_cluster_kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
"""


def _replace_once(text: str, old: str, new: str) -> str:
    """``text`` with its one occurrence of ``old`` replaced; raises unless
    ``old`` occurs exactly once, so an edit of the source cannot make the
    probe time an unchanged copy."""
    if text.count(old) != 1:
        raise RuntimeError(f"expected one {old!r} in the kernel source, found {text.count(old)}")
    return text.replace(old, new)


def instrumented_pyramid(text: str) -> str:
    """``csrc/pyramid.cu`` with the phase clocks and the occupancy query."""
    text = _replace_once(text, "__global__ void __launch_bounds__(kClusterMaxThreads)",
                         PHASE_CLOCK + "__global__ void __launch_bounds__(kClusterMaxThreads)")
    line = "  const int wx = c.wx, px = c.px, rad = c.rad, pitch = c.pitch;\n"
    text = _replace_once(text, line, line + "  int phase = 0;\n")
    for anchor in PHASE_ANCHORS:
        text = _replace_once(text, anchor, anchor[: len(anchor) - len(anchor.lstrip())] + "PHASE();\n" + anchor)
    return text + PROBE_EXPORTS


def _compile(sources: dict[str, str], out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Build each source text into its own library, all nvcc runs at once."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def _back_to_back_ms(fn, iters: int = 20) -> float:
    """Device ms of one call from CUDA events around calls issued back to
    back (no spin ahead of them)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_frame(device) -> dict:
    """The kernels' inputs at the flagship's 4096 envs, one policy step in."""
    from tacex_tpu_torch import envs
    from tacex_tpu_torch.rl.networks import ActorCritic

    env = envs.make(chip_smoke.ENV_ID, num_envs=4096, device=device)
    state, obs = env.reset_all(env.init_state())
    policy = ActorCritic(14, env.cfg.vision_obs_shape, env.cfg.action_space, device=device)
    policy.init_(torch.Generator(device=device).manual_seed(0))
    state, obs, *_ = env.step(state, chip_smoke._policy_action(policy, obs))
    joined, mask, sigmas, idx, _ = chip_smoke._frame(env, state)
    sigmas = tuple((float(sx), float(sy)) for sx, sy in sigmas)
    return dict(joined=joined, mask=mask, sigmas=sigmas, idx=idx, feats=env.sensor.calib.features,
                table=env.sensor.calib.poly_lut.reshape(-1, 18).contiguous())


def factory_frame(device) -> dict:
    """The kernels' inputs on PegInsert's 2N finger images, one step in."""
    from tacex_tpu_torch import envs

    env = envs.make(chip_smoke.FACTORY_IDS[0], device=device)
    state, _ = env.reset_all(env.init_state())
    state, *_ = env.step(state, chip_smoke._factory_action(env.cfg.num_envs, device))
    joined, mask, sigmas, idx, _ = chip_smoke._depth_frame(env.sensor, env._finger_depths(state.arm, state.held))
    sigmas = tuple((float(sx), float(sy)) for sx, sy in sigmas)
    return dict(joined=joined, mask=mask, sigmas=sigmas, idx=idx, feats=env.sensor.calib.features,
                table=env.sensor.calib.poly_lut.reshape(-1, 18).contiguous())


def pyramid_probe(work: Path, device) -> None:
    sim_sigmas = chip_smoke.sensor_sigmas((240, 320))
    taps, ky, kx = K1._packed_taps(sim_sigmas, 240, 320)
    args = (taps.ctypes.data, ky.ctypes.data, kx.ctypes.data, len(ky))
    g = torch.Generator(device=device).manual_seed(0)
    joined = torch.rand((256, 240, 320), generator=g, device=device) * 3.0 - 1.0
    mask = torch.rand((256, 240, 320), generator=g, device=device) < 0.3
    prof = _compile({"pyramid_profile": instrumented_pyramid((_build.CSRC / "pyramid.cu").read_text())},
                    work)["pyramid_profile"]
    prof.tacex_deformation_pyramid.argtypes = PYRAMID_ARGS
    prof.tacex_deformation_pyramid_phase_clock.argtypes = [PTR]
    prof.tacex_deformation_pyramid_active_clusters.argtypes = [I32, I32, PTR, PTR, PTR, I32]
    clusters = prof.tacex_deformation_pyramid_active_clusters(240, 320, *args)
    ms = chip_smoke._timed_ms(lambda: K1.deformation_pyramid(joined, mask, sim_sigmas), iters=10)[0]
    print(f"pyramid (256, 240, 320): {ms:.4f} ms; {clusters} clusters of "
          f"{_build.load_library().tacex_deformation_pyramid_plan(240, 320, *args)} CTAs resident at once")

    out = torch.empty_like(joined)
    stream = torch.cuda.current_stream().cuda_stream
    err = prof.tacex_deformation_pyramid(joined.data_ptr(), mask.data_ptr(), out.data_ptr(), *args, 256, 240, 320,
                                         stream)
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"instrumented pyramid launch failed: CUDA error {err}")
    clock = (ctypes.c_longlong * 256)()
    prof.tacex_deformation_pyramid_phase_clock(ctypes.addressof(clock))
    t = [v for v in clock if v > 0]
    total = t[-1] - t[0]
    print(f"pyramid phases of the first CTA (clock64 cycles; {total} in all):")
    print(f"  set-up (zero, taps) {t[1] - t[0]}, load band {t[2] - t[1]}, last wait {t[-1] - t[-2]}")
    levels = [(a, b) for a, b in zip(ky, kx) if a > 1 or b > 1]
    for n, (a, b) in enumerate(levels):
        d = [t[3 + 7 * n + i] - t[2 + 7 * n + i] for i in range(7)]
        halo = 2 * ((a - 1) // 2) * 320 * 4
        line = ", ".join(f"{name} {v}" for name, v in zip(PHASES, d))
        print(f"  level {n} ({a}+{b} taps): {line}; halo {halo} B = {halo / max(d[2], 1):.2f} B/clock")

    for sub in ((sim_sigmas[0],), (sim_sigmas[4],), ((0.01, 0.01),)):
        ms = chip_smoke._timed_ms(lambda: K1.deformation_pyramid(joined, mask, sub), iters=10)[0]
        print(f"pyramid (256, 240, 320) with only {sub}: {ms:.4f} ms")
    for n in (16, 32, 64, 128):
        ms = chip_smoke._timed_ms(lambda: K1.deformation_pyramid(joined[:n], mask[:n], sim_sigmas), iters=10)[0]
        print(f"pyramid ({n}, 240, 320): {ms:.4f} ms")


def lut_probe(work: Path, device, frame: dict) -> None:
    idx, feats, table = frame["idx"], frame["feats"], frame["table"]
    rows = torch.randint(0, table.shape[0], idx.shape, device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(0))
    print(f"lut_shade (4096, 768): {float((idx < 125).float().mean()):.3f} of the frame's pixels read "
          "magnitude-bin-0 rows")
    ref = K2.lut_shade_plain(idx, feats, table)

    text = (_build.CSRC / "lut_shade.cu").read_text()
    sources = {
        f"lut_{e}_{t}": _replace_once(
            _replace_once(text, "constexpr int kEnvsPerBlock = 8;", f"constexpr int kEnvsPerBlock = {e};"),
            "constexpr int kMaxThreads = 256;", f"constexpr int kMaxThreads = {t};")
        for e in ENVS_PER_BLOCK for t in THREADS
    }
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in _compile(sources, work).items():
        lib.tacex_lut_shade.argtypes = LUT_ARGS
        times = {}
        for what, ii in (("frame", idx), ("random rows", rows)):
            launch = lambda: lib.tacex_lut_shade(ii.data_ptr(), feats.data_ptr(), table.data_ptr(), out.data_ptr(),
                                                 4096, 768, table.shape[0], stream)
            times[what] = chip_smoke._timed_ms(launch, iters=50)[0]
        launch = lambda: lib.tacex_lut_shade(idx.data_ptr(), feats.data_ptr(), table.data_ptr(), out.data_ptr(),
                                             4096, 768, table.shape[0], stream)
        launch()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        _, e, t = name.split("_")
        print(f"lut_shade {e} envs a block x {t} threads: frame {times['frame']:.4f} ms, "
              f"random rows {times['random rows']:.4f} ms, max_abs_err {err:.2e}")


def baseline_probe(work: Path, frames: list[dict], baseline: Path) -> None:
    """Both kernels of ``baseline`` and of this tree on each frame, each
    launched as its wrapper does (a new output a call), timed queued behind
    a spin and back to back, and held to its plain version."""
    sources = {}
    for side, csrc in (("baseline", baseline), ("this tree", _build.CSRC)):
        for kernel in ("pyramid", "lut_shade"):
            sources[f"{'base' if side == 'baseline' else 'tree'}_{kernel}"] = (csrc / f"{kernel}.cu").read_text()
    libs = _compile(sources, work)
    for frame in frames:
        _baseline_frame(libs, frame)


def _baseline_frame(libs: dict, frame: dict) -> None:
    joined, mask, sigmas = frame["joined"], frame["mask"], frame["sigmas"]
    idx, feats, table = frame["idx"], frame["feats"], frame["table"]
    n, h, w = joined.shape
    taps, ky, kx = K1._packed_taps(sigmas, h, w)
    stream = torch.cuda.current_stream().cuda_stream

    def pyramid_call(lib):
        lib.tacex_deformation_pyramid.argtypes = PYRAMID_ARGS

        def call():
            out = torch.empty_like(joined)
            err = lib.tacex_deformation_pyramid(joined.data_ptr(), mask.data_ptr(), out.data_ptr(), taps.ctypes.data,
                                                ky.ctypes.data, kx.ctypes.data, len(ky), n, h, w, stream)
            if err != 0:
                raise RuntimeError(f"pyramid launch failed: CUDA error {err}")
            return out
        return call

    def lut_call(lib):
        lib.tacex_lut_shade.argtypes = LUT_ARGS

        def call():
            out = torch.empty((*idx.shape, 3), device=idx.device)
            err = lib.tacex_lut_shade(idx.data_ptr(), feats.data_ptr(), table.data_ptr(), out.data_ptr(),
                                      idx.shape[0], idx.shape[1], table.shape[0], stream)
            if err != 0:
                raise RuntimeError(f"lut_shade launch failed: CUDA error {err}")
            return out
        return call

    plain = {"pyramid": K1.deformation_pyramid_plain(joined, mask, sigmas), "lut_shade": K2.lut_shade_plain(idx, feats, table)}
    calls = {"pyramid": pyramid_call, "lut_shade": lut_call}
    shapes = {"pyramid": tuple(joined.shape), "lut_shade": tuple(idx.shape)}
    for side in ("base", "tree", "tree", "base"):
        for kernel in ("pyramid", "lut_shade"):
            fn = calls[kernel](libs[f"{side}_{kernel}"])
            err = float((fn() - plain[kernel]).abs().max())
            queued = chip_smoke._timed_ms(fn)[0]
            b2b = _back_to_back_ms(fn)
            print(f"{'baseline' if side == 'base' else 'this tree'} {kernel}.cu {shapes[kernel]}: queued {queued:.4f} ms, "
                  f"back to back {b2b:.4f} ms, max_abs_err {err:.2e}")
    for kernel, fn in (("deformation_pyramid", lambda: K1.deformation_pyramid(joined, mask, sigmas)),
                       ("lut_shade", lambda: K2.lut_shade(idx, feats, table))):
        print(f"this tree's wrapper {kernel}: queued {chip_smoke._timed_ms(fn)[0]:.4f} ms, "
              f"back to back {_back_to_back_ms(fn):.4f} ms")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, help="a csrc directory whose pyramid.cu and lut_shade.cu to time "
                        "beside this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    device = torch.device("cuda")
    _build.load_library()
    frame = flagship_frame(device)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        pyramid_probe(Path(work), device)
        lut_probe(Path(work), device, frame)
        if args.baseline is not None:
            baseline_probe(Path(work), [frame, factory_frame(device)], args.baseline.resolve())


if __name__ == "__main__":
    main()
