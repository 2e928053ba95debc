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
// What bounds it on Hopper: per pixel it reads a 4-byte index and writes 12
// bytes; the features (6 x P) are shared by the whole batch and the table
// (1.1 MB at 15,625 rows) lives in the 50 MB L2. At 4096 x 768 pixels that is
// ~51 MB of device memory traffic, 15 us at 3.35 TB/s; the 18 FMAs a pixel
// are far below the FP32 rate. So it is bound by bytes, and by the latency
// of the row gather that depends on each index load.
//
// What the design does about it:
//   * a 2-D grid: a block owns a tile of pixels (blockIdx.x) and loops over
//     a range of envs (blockIdx.y); each thread takes 4 consecutive pixels
//     and keeps their 24 features in registers across its envs, so features
//     are read once per block, not once per pixel, and no `% P` is taken;
//   * one 16-byte index load per thread and env, the next env's indices
//     loaded before the current env's rows are used;
//   * a row is 72 bytes, so it starts on a 16-byte boundary when its index
//     is even: an even row loads as four float4 then a float2, an odd row as
//     a float2 then four float4: 5 loads instead of 9; the gather's cost is
//     the L1 lookups of 32 lanes' different rows, so fewer, wider loads pay;
//   * all 20 row loads of a thread's 4 pixels are issued before any is
//     used, so they are in flight together;
//   * the 48 output bytes go out as three 16-byte stores;
//   * a ragged P (not a multiple of 4) takes scalar index loads and stores
//     and masks the last quad; a ragged env range is a shorter loop.
// The arithmetic stays f32 (no TF32, no fast-math): the features reach
// 640^2 = 4.1e5 and the quadratic cancels. A row index outside the table
// writes NaN instead of reading out of bounds, since the kernel cannot raise.
//
// A second entry, tacex_lut_shade_bf16, takes the table in bf16 (the JAX
// package's shade(lut_dtype=jnp.bfloat16): the table is rounded, the rows
// gathered, then widened to f32 for the same f32 feature dot). A bf16 row is
// 18 x 2 = 36 bytes, so it starts on a 4-byte boundary whatever its index
// and never on a 16-byte one for two rows running: it loads as nine 4-byte
// words, each holding two entries that widen to f32 by a shift (bf16 is the
// high half of an f32). Half the bytes of an f32 row, in 9 loads instead of 5.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kEnvsPerBlock = 8;

template <bool kVec>
__device__ __forceinline__ int4 load_idx(const int32_t* __restrict__ idx, int64_t at, int live) {
  if (kVec) return __ldg(reinterpret_cast<const int4*>(idx + at));
  int4 r = make_int4(0, 0, 0, 0);
  if (live > 0) r.x = __ldg(idx + at);
  if (live > 1) r.y = __ldg(idx + at + 1);
  if (live > 2) r.z = __ldg(idx + at + 2);
  if (live > 3) r.w = __ldg(idx + at + 3);
  return r;
}

// One 72-byte table row: a float2 and four float4, in the order the row's
// 16-byte alignment gives (odd: the float2 first).
struct Row {
  float2 e;
  float4 q[4];
  bool odd;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ table, int r) {
  Row row;
  const float* at = table + static_cast<int64_t>(r) * 18;
  row.odd = r & 1;
  row.e = __ldg(reinterpret_cast<const float2*>(at + (row.odd ? 0 : 16)));
  const float4* q = reinterpret_cast<const float4*>(at + (row.odd ? 2 : 0));
#pragma unroll
  for (int i = 0; i < 4; ++i) row.q[i] = __ldg(q + i);
  return row;
}

__device__ __forceinline__ float quad_at(const float4 (&q)[4], int i) {
  const float4 v = q[i >> 2];
  return (i & 3) == 0 ? v.x : (i & 3) == 1 ? v.y : (i & 3) == 2 ? v.z : v.w;
}

// Entry i of the row (i is a constant once unrolled).
__device__ __forceinline__ float coeff(const Row& row, int i) {
  const float even = i < 16 ? quad_at(row.q, i) : (i == 16 ? row.e.x : row.e.y);
  const float odd = i < 2 ? (i == 0 ? row.e.x : row.e.y) : quad_at(row.q, i - 2);
  return row.odd ? odd : even;
}

// The table as the kernel reads it: an f32 table of 72-byte rows ...
struct F32Table {
  using RowT = Row;
  const float* p;
  __device__ __forceinline__ RowT load(int r) const { return load_row(p, r); }
  __device__ __forceinline__ static float at(const RowT& row, int i) { return coeff(row, i); }
};

// ... or a bf16 table of 36-byte rows, read as nine 4-byte words. Entry 2j
// is the low half of word j (little-endian), entry 2j + 1 the high half.
struct Bf16Row {
  uint32_t w[9];
};

struct Bf16Table {
  using RowT = Bf16Row;
  const uint32_t* p;
  __device__ __forceinline__ RowT load(int r) const {
    RowT row;
    const uint32_t* at = p + static_cast<int64_t>(r) * 9;
#pragma unroll
    for (int i = 0; i < 9; ++i) row.w[i] = __ldg(at + i);
    return row;
  }
  __device__ __forceinline__ static float at(const RowT& row, int i) {
    const uint32_t w = row.w[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// kVec: P % 4 == 0 and 16-byte aligned idx and out, so index rows and output
// rows are 16-byte aligned and every quad is whole.
template <bool kVec, class Table>
__global__ void __launch_bounds__(kMaxThreads)
lut_shade_kernel(const int32_t* __restrict__ idx, const float* __restrict__ feats,
                 const Table table, float* __restrict__ out, int n, int p, int rows) {
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (p0 >= p) return;
  const int live = min(4, p - p0);
  const int n0 = blockIdx.y * kEnvsPerBlock;
  const int n1 = min(n, n0 + kEnvsPerBlock);

  float f[6][4];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) f[k][q] = q < live ? __ldg(feats + static_cast<int64_t>(k) * p + p0 + q) : 0.0f;
  }

  const float nan = __int_as_float(0x7fc00000);
  int4 next = load_idx<kVec>(idx, static_cast<int64_t>(n0) * p + p0, live);
  for (int e = n0; e < n1; ++e) {
    const int4 cur = next;
    if (e + 1 < n1) next = load_idx<kVec>(idx, static_cast<int64_t>(e + 1) * p + p0, live);
    const int r[4] = {cur.x, cur.y, cur.z, cur.w};
    bool bad[4];
    typename Table::RowT row[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bad[q] = r[q] < 0 || r[q] >= rows;
      row[q] = table.load(bad[q] ? 0 : r[q]);
    }
    float o[12];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a0 += f[k][q] * Table::at(row[q], 3 * k + 0);
        a1 += f[k][q] * Table::at(row[q], 3 * k + 1);
        a2 += f[k][q] * Table::at(row[q], 3 * k + 2);
      }
      o[3 * q + 0] = bad[q] ? nan : a0;
      o[3 * q + 1] = bad[q] ? nan : a1;
      o[3 * q + 2] = bad[q] ? nan : a2;
    }
    float* dst = out + (static_cast<int64_t>(e) * p + p0) * 3;
    if (kVec) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      d4[0] = make_float4(o[0], o[1], o[2], o[3]);
      d4[1] = make_float4(o[4], o[5], o[6], o[7]);
      d4[2] = make_float4(o[8], o[9], o[10], o[11]);
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i)
        if (i < 3 * live) dst[i] = o[i];
    }
  }
}

template <class Table>
int launch(const int32_t* idx, const float* feats, Table table, float* out, int n, int p, int rows,
           void* stream) {
  if (n < 0 || p < 1 || rows < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int quads = (p + 3) / 4;
  const int threads = min(kMaxThreads, (quads + 31) / 32 * 32);
  const dim3 grid((quads + threads - 1) / threads, (n + kEnvsPerBlock - 1) / kEnvsPerBlock);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    lut_shade_kernel<true, Table><<<grid, threads, 0, s>>>(idx, feats, table, out, n, p, rows);
  else
    lut_shade_kernel<false, Table><<<grid, threads, 0, s>>>(idx, feats, table, out, n, p, rows);
  return cudaGetLastError();
}

}  // namespace

// Each returns the CUDA error of the launch (0 = cudaSuccess). They launch on
// `stream` and do not synchronise. The f32 table must be 16-byte aligned,
// the bf16 table (raw 16-bit words) 4-byte aligned.
extern "C" int tacex_lut_shade(const int32_t* idx, const float* feats, const float* table,
                               float* out, int n, int p, int rows, void* stream) {
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return cudaErrorInvalidValue;
  return launch(idx, feats, F32Table{table}, out, n, p, rows, stream);
}

extern "C" int tacex_lut_shade_bf16(const int32_t* idx, const float* feats, const uint16_t* table,
                                    float* out, int n, int p, int rows, void* stream) {
  if (reinterpret_cast<uintptr_t>(table) % 4 != 0) return cudaErrorInvalidValue;
  return launch(idx, feats, Bf16Table{reinterpret_cast<const uint32_t*>(table)}, out, n, p, rows, stream);
}
