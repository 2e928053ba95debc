// Masked Gaussian deformation pyramid of the Taxim gel model.
//
// Replaces the TPU kernel deformation_pyramid_pallas
// (tacex_tpu/ops/pallas_pyramid.py), which applies each level as two dense
// band-matrix products on the MXU.
//
// What it computes, per image: x = joined; for every level l,
//   x <- Gy[l] (x) Gx[l]   (separable Gaussian, H pass then W pass, with
//                           single-reflection edges: -1 -> 1, n -> n - 2)
//   x <- mask ? joined : x (after every level but the last)
//
// What bounds it on Hopper: at the flagship's 24x32 images and 4096 envs the
// whole pyramid moves about 28 MB through device memory (one f32 read of the
// image, one byte of mask, one f32 write) and does under 0.1 GFLOP, so it is
// bound by latency and launch overhead, not by bandwidth or arithmetic.
//
// What the design does about it: one thread block owns one image for the
// whole pyramid. The image, its pinned copy, the mask and a ping-pong buffer
// live in shared memory (about 10 KB at 24x32), so device memory sees each
// image once in and once out, and all levels run in one launch. The taps come
// by value in the kernel parameters (a __grid_constant__ struct, read through
// the constant cache, uniform across the warp); the dense band matrices are
// not carried over: at 240x320 they alone would exceed shared memory.
// No fast-math: sums stay in f32 in tap order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 768;
constexpr int kThreads = 256;

struct PyramidTaps {
  int levels;
  int ky[kMaxLevels];
  int kx[kMaxLevels];
  // level l: ky[l] taps of the H pass, then kx[l] taps of the W pass
  float taps[kMaxTaps];
};

__device__ __forceinline__ int reflect(int j, int n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * (n - 1) - j;
  return j;
}

__global__ void __launch_bounds__(kThreads)
deformation_pyramid_kernel(const float* __restrict__ joined,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ out, int h, int w,
                           const __grid_constant__ PyramidTaps p) {
  extern __shared__ float smem[];
  const int hw = h * w;
  float* x = smem;
  float* tmp = smem + hw;
  float* pin = smem + 2 * hw;
  uint8_t* m = reinterpret_cast<uint8_t*>(smem + 3 * hw);
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;

  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float v = joined[base + i];
    x[i] = v;
    pin[i] = v;
    m[i] = mask[base + i];
  }
  __syncthreads();

  int off = 0;
  for (int l = 0; l < p.levels; ++l) {
    const int ky = p.ky[l];
    const int kx = p.kx[l];
    const float* ty = p.taps + off;
    const float* tx = ty + ky;
    off += ky + kx;

    const int py = (ky - 1) / 2;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const int r = i / w;
      const int c = i - r * w;
      float acc = 0.0f;
      for (int t = 0; t < ky; ++t) acc += ty[t] * x[reflect(r + t - py, h) * w + c];
      tmp[i] = acc;
    }
    __syncthreads();

    const int px = (kx - 1) / 2;
    const bool repin = l < p.levels - 1;
    for (int i = threadIdx.x; i < hw; i += blockDim.x) {
      const int r = i / w;
      const int c = i - r * w;
      float acc = 0.0f;
      for (int t = 0; t < kx; ++t) acc += tx[t] * tmp[r * w + reflect(c + t - px, w)];
      x[i] = (repin && m[i]) ? pin[i] : acc;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < hw; i += blockDim.x) out[base + i] = x[i];
}

}  // namespace

extern "C" size_t tacex_deformation_pyramid_smem(int h, int w) {
  const size_t hw = static_cast<size_t>(h) * w;
  return 3 * hw * sizeof(float) + hw;
}

// Returns the CUDA error of the launch (0 = cudaSuccess). Launches on
// `stream` and does not synchronise.
extern "C" int tacex_deformation_pyramid(const float* joined, const uint8_t* mask,
                                         float* out, const float* taps,
                                         const int* ky, const int* kx, int levels,
                                         int n, int h, int w, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n < 0 || h < 1 || w < 1)
    return cudaErrorInvalidValue;
  PyramidTaps p;
  p.levels = levels;
  int total = 0;
  for (int l = 0; l < levels; ++l) {
    if (ky[l] < 1 || kx[l] < 1 || (ky[l] - 1) / 2 > h - 1 || (kx[l] - 1) / 2 > w - 1)
      return cudaErrorInvalidValue;
    p.ky[l] = ky[l];
    p.kx[l] = kx[l];
    total += ky[l] + kx[l];
  }
  if (total > kMaxTaps) return cudaErrorInvalidValue;
  for (int i = 0; i < total; ++i) p.taps[i] = taps[i];
  if (n == 0) return cudaSuccess;

  const size_t smem = tacex_deformation_pyramid_smem(h, w);
  cudaError_t err = cudaFuncSetAttribute(deformation_pyramid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  deformation_pyramid_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      joined, mask, out, h, w, p);
  return cudaGetLastError();
}
