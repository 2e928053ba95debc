// Taxim quadratic shading from one LUT row per pixel.
//
// Replaces the TPU kernel dir_row_shade (tacex_tpu/ops/pallas_lut.py), which
// looks up rows of the 125-row magnitude-bin-0 subtable with an in-register
// lane shuffle. Here the same row-gather-and-quadratic takes a table of any
// row count, so it also serves the default dense shading with the full
// 15,625-row LUT (row = idx_mag * 125 + idx_dir):
//
//   out[n, p, c] = sum_{k < 6} feats[k, p] * table[idx[n, p], 3 k + c]
//
// What bounds it on Hopper: per pixel it reads a 4-byte index, 24 bytes of
// features (shared by the batch, so they stay in L1/L2) and one 72-byte table
// row, and writes 12 bytes; 18 FMAs. The full table is 1.1 MB and lives in
// the 50 MB L2, so the kernel is bound by the index reads and output writes
// (about 12 MB at 4096 x 768 pixels) and by the latency of the dependent row
// gather.
//
// What the design does about it: one thread per pixel, consecutive threads on
// consecutive pixels (coalesced index reads and output writes); rows and
// features go through the read-only cache. Everything stays f32 (no TF32, no
// bf16, no fast-math): the features reach 640^2 = 4.1e5 and the quadratic
// cancels. A row index outside the table writes NaN instead of reading out of
// bounds, since the kernel cannot raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lut_shade_kernel(const int32_t* __restrict__ idx, const float* __restrict__ feats,
                 const float* __restrict__ table, float* __restrict__ out,
                 int64_t total, int p, int rows) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int pix = static_cast<int>(g % p);
  const int row = __ldg(idx + g);
  float a0, a1, a2;
  if (row < 0 || row >= rows) {
    a0 = a1 = a2 = __int_as_float(0x7fc00000);
  } else {
    const float* r = table + static_cast<int64_t>(row) * 18;
    a0 = a1 = a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float f = __ldg(feats + static_cast<int64_t>(k) * p + pix);
      a0 += f * __ldg(r + 3 * k + 0);
      a1 += f * __ldg(r + 3 * k + 1);
      a2 += f * __ldg(r + 3 * k + 2);
    }
  }
  float* o = out + g * 3;
  o[0] = a0;
  o[1] = a1;
  o[2] = a2;
}

}  // namespace

// Returns the CUDA error of the launch (0 = cudaSuccess). Launches on
// `stream` and does not synchronise.
extern "C" int tacex_lut_shade(const int32_t* idx, const float* feats, const float* table,
                               float* out, int n, int p, int rows, void* stream) {
  if (n < 0 || p < 1 || rows < 1) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(n) * p;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  lut_shade_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(idx, feats, table, out, total, p,
                                                          rows);
  return cudaGetLastError();
}
