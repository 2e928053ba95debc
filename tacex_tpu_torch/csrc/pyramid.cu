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
// A pass with one tap is the identity (its tap is exactly 1.0); a level whose
// two passes both have one tap changes nothing, and its re-pin repeats the
// one before it, so it is skipped.
//
// Three designs, chosen per shape by tacex_deformation_pyramid_plan() below:
//
// 1. One warp per image (W <= 32, H = 24 or 32: the flagship's 24x32
//    tactile image and the Factory fingers' 32x32 ones). What bounds it:
//    device memory, one f32 read, one mask byte and one f32 write a pixel:
//    ~28 MB at 4096 images of 24x32, 8.4 us at 3.35 TB/s, and 2.4 MB at 256
//    images of 32x32, 0.7 us, less than a launch takes; the <= 15 taps a
//    pixel per pass are far below the FP32 rate. What the design does about
//    it: a block holds 8 images, one per warp; the warp moves its image in
//    and out with 16-byte loads and stores through a per-warp shared tile
//    (8 x H x 32 x 5 bytes a block: 30 KB at H = 24, 40 KB at H = 32, under
//    the 48 KB of static shared memory); lane = column, and each lane keeps
//    its whole column (x, the pinned copy and the mask bits) in registers. H
//    is a template parameter and each pass's tap count is dispatched to a
//    template, so the H pass is fully unrolled with reflected row indices
//    resolved at compile time (no divide, no branch, no shared memory); the
//    W pass reads the neighbouring columns with warp shuffles from lanes
//    reflected once per level. No block barrier: only __syncwarp around the
//    tile.
//
// 2. One thread-block cluster per image (every other shape, up to what
//    shared memory holds: 240x320 takes a cluster of 8). What bounds it: at
//    240x320 the seven levels do 266 taps a pixel, 10.5 GFLOP at 256 images,
//    156 us at 67 TFLOP/s, against 53 us of device memory traffic, so it is
//    bound by operations. What the design does about it: each CTA of the
//    cluster owns a band of rows in shared memory for the whole pyramid, so
//    device memory sees each image once in and once out. Before each level's
//    H pass a CTA reads the rows above and below its band (reflected at the
//    image edges) from the bands of its neighbours (DSMEM) into a halo. Two
//    cluster barriers a level order this, each split into arrive and wait
//    around work that does not need it (the passes), so their waits are short.
//    Each thread of the H pass owns 4 columns x 8 rows and each thread of
//    the W pass 8 columns of a row; both walk the taps 8 at a time over a
//    16-value sliding window in registers, so one 16-byte shared load feeds
//    8 to 32 FMAs and no tap branches (taps are zero-padded to a multiple of
//    8 on the host; the W pass reads a reflected halo written once per
//    level). The band of `joined` and of the mask stay in shared memory for
//    the re-pin. Loads go out 8 to 32 per thread before any is stored, so
//    their latency overlaps. scripts/benchmarking/torch_kernel_probe.py
//    times its phases in an instrumented copy of this file.
//
// 3. Global memory, for every image the cluster design cannot hold (the
//    calibration's own 480x640 frame with the sensor's sigmas: no cluster
//    of 8 CTAs holds the bands and halos of its 117-tap first level). Per
//    level one H-pass kernel into a scratch image and one W-pass kernel
//    back, with the re-pin fused in: two launches a level, one thread an
//    output pixel, the image read through L1/L2 tap by tap with the same
//    single reflection. What bounds it: at (4, 480, 640) the levels do ~480
//    taps a pixel in all, 1.2 GFLOP, 18 us at 67 TFLOP/s, against 11 MB of
//    image traffic a level; this simple design reads every tap from cache
//    and is far from either bound (PERF.md has its time). The caller gives
//    the scratch image (tacex_deformation_pyramid_global).
//
// The backward (tacex_deformation_pyramid_backward) is the explicit adjoint
// of the same computation, for the gradient in `joined`; the TPU package has
// no backward kernel (XLA differentiates its plain blur), so it replaces
// none. See section 4 below.
//
// No fast-math: sums stay in f32 in tap order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxTaps = 768;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use on Hopper

struct PyramidTaps {
  int levels;
  int ky[kMaxLevels];
  int kx[kMaxLevels];
  // level l: ky[l] taps of the H pass, then kx[l] taps of the W pass
  float taps[kMaxTaps];
};

__host__ __device__ constexpr int reflect(int j, int n) {
  return j < 0 ? -j : (j >= n ? 2 * (n - 1) - j : j);
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------- 1. warp per image
constexpr int kWarpMaxK = 15;
constexpr int kWarpsPerBlock = 8;

// t[r] = sum_k taps[k] * x[reflect(r + k - P)], all indices constant.
template <int H, int K>
__device__ __forceinline__ void blur_rows(const float (&x)[H], float (&t)[H], const float* taps) {
  constexpr int P = (K - 1) / 2;
  float tp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) tp[k] = taps[k];
#pragma unroll
  for (int r = 0; r < H; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc += tp[k] * x[reflect(r + k - P, H)];
    t[r] = acc;
  }
}

// x[r] = sum_k taps[k] * t[r] of lane reflect(lane + k - P, w).
template <int H, int K>
__device__ __forceinline__ void blur_cols(const float (&t)[H], float (&x)[H], const float* taps, int lane,
                                          int w) {
  constexpr int P = (K - 1) / 2;
  float tp[K];
  int src[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    tp[k] = taps[k];
    src[k] = reflect(lane + k - P, w);
  }
#pragma unroll
  for (int r = 0; r < H; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc += tp[k] * __shfl_sync(0xffffffffu, t[r], src[k]);
    x[r] = acc;
  }
}

#define TACEX_TAP_CASES(CALL) \
  CALL(1) CALL(3) CALL(5) CALL(7) CALL(9) CALL(11) CALL(13) CALL(15)

template <int H>
__device__ __forceinline__ void blur_rows_k(int k, const float (&x)[H], float (&t)[H], const float* taps) {
  switch (k) {
#define TACEX_CASE(K) \
  case K:             \
    blur_rows<H, K>(x, t, taps); \
    break;
    TACEX_TAP_CASES(TACEX_CASE)
#undef TACEX_CASE
  }
}

template <int H>
__device__ __forceinline__ void blur_cols_k(int k, const float (&t)[H], float (&x)[H], const float* taps,
                                            int lane, int w) {
  switch (k) {
#define TACEX_CASE(K) \
  case K:             \
    blur_cols<H, K>(t, x, taps, lane, w); \
    break;
    TACEX_TAP_CASES(TACEX_CASE)
#undef TACEX_CASE
  }
}

template <int H>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pyramid_warp_kernel(const float* __restrict__ joined, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int n, int w, const __grid_constant__ PyramidTaps p) {
  static_assert(H <= 32, "the column's mask bits live in one 32-bit word");
  static_assert(kWarpsPerBlock * H * 32 * 5 <= 48 * 1024, "the tiles exceed 48 KB of static shared memory");
  __shared__ float4 tile4[kWarpsPerBlock][H * 32 / 4];
  __shared__ uint4 mtile4[kWarpsPerBlock][H * 32 / 16];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int img = blockIdx.x * kWarpsPerBlock + warp;
  if (img >= n) return;  // the whole warp leaves; the block never synchronises
  const int hw = H * w;

  // every load of the image and its mask is issued before the first store
  constexpr int kVec = (H * 32 / 4 + 31) / 32, kMVec = (H * 32 / 16 + 31) / 32;
  const float4* src4 = reinterpret_cast<const float4*>(joined + static_cast<size_t>(img) * hw);
  const uint4* msrc4 = reinterpret_cast<const uint4*>(mask + static_cast<size_t>(img) * hw);
  float4 v[kVec];
  uint4 mv[kMVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (lane + 32 * u < hw / 4) v[u] = __ldg(src4 + lane + 32 * u);
#pragma unroll
  for (int u = 0; u < kMVec; ++u)
    if (lane + 32 * u < hw / 16) mv[u] = __ldg(msrc4 + lane + 32 * u);
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (lane + 32 * u < hw / 4) tile4[warp][lane + 32 * u] = v[u];
#pragma unroll
  for (int u = 0; u < kMVec; ++u)
    if (lane + 32 * u < hw / 16) mtile4[warp][lane + 32 * u] = mv[u];
  __syncwarp();

  const float* tile = reinterpret_cast<const float*>(tile4[warp]);
  const uint8_t* mt = reinterpret_cast<const uint8_t*>(mtile4[warp]);
  const int c = lane < w ? lane : w - 1;  // lanes past the image repeat its last column; dropped at the end
  float x[H], pin[H], t[H];
  unsigned bits = 0;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    pin[r] = x[r] = tile[r * w + c];
    bits |= (mt[r * w + c] ? 1u : 0u) << r;
  }

  int off = 0;
  for (int l = 0; l < p.levels; ++l) {
    const int ky = p.ky[l];
    const int kx = p.kx[l];
    const float* ty = p.taps + off;
    off += ky + kx;
    if (ky == 1 && kx == 1) continue;
    blur_rows_k<H>(ky, x, t, ty);
    blur_cols_k<H>(kx, t, x, ty + ky, lane, w);
    if (l < p.levels - 1) {
#pragma unroll
      for (int r = 0; r < H; ++r) x[r] = (bits >> r) & 1u ? pin[r] : x[r];
    }
  }

  __syncwarp();
  float* otile = reinterpret_cast<float*>(tile4[warp]);
  if (lane < w) {
#pragma unroll
    for (int r = 0; r < H; ++r) otile[r * w + lane] = x[r];
  }
  __syncwarp();
  float4* dst4 = reinterpret_cast<float4*>(out + static_cast<size_t>(img) * hw);
#pragma unroll
  for (int u = 0; u < kVec; ++u)
    if (lane + 32 * u < hw / 4) dst4[lane + 32 * u] = tile4[warp][lane + 32 * u];
}

// ------------------------------------------------------------- 2. cluster per image
constexpr int kClusterMaxThreads = 448;  // 65,536 registers / 448 = 146 a thread
constexpr int kStage = 4;   // groups of 8 columns a thread loads before it stores any
constexpr int kBatch = 8;   // DSMEM loads a thread issues before it stores any
// each pass's taps zero-padded to a multiple of 8, a W pass's after up to 3
// shift zeros: at most 768 + 8 levels x (7 + 10)
constexpr int kMaxPaddedTaps = kMaxTaps + kMaxLevels * 17;

// The cluster design's parameters, computed on the host. Shared memory of
// one CTA (floats unless noted); row pitches are 4 more than a multiple of
// 32 floats, so threads on consecutive rows reach different banks with
// their 16-byte accesses:
//   xs   rows_x x px    the band (rows [rad, rad + band)) with a halo of up
//                       to rad rows above and rad + band_pad - band + 8 below
//   ts   band_pad x pitch  the H pass's output; column c of a level with W
//                       radius rx at position round_up(rx, 4) + c, with the
//                       reflected halo around it
//   pin  band x px      the band of `joined`, for the re-pin
//   tp   ntaps          the taps below
//   ms   band x mbp bytes  the band's mask, one bit a column, 8 columns a byte
//   lv   5 x kMaxLevels ints  ry, rx, kyp, kxp and toff below, by level
struct ClusterParams {
  int cluster, band, band_pad, rad, wx, px, pitch, mbp, rows_x, ntaps, threads, levels;
  // per level: H and W radius, padded tap counts (kyp = 0: the level is the
  // identity and is skipped) and the offset of its taps in tp
  int ry[kMaxLevels], rx[kMaxLevels], kyp[kMaxLevels], kxp[kMaxLevels], toff[kMaxLevels];
  size_t smem;
  // level l: kyp[l] H taps, then kxp[l] W taps that start with
  // round_up(rx, 4) - rx zeros, so the W pass's window loads stay aligned
  float taps[kMaxPaddedTaps];
};

__device__ __forceinline__ float4 lds4(const float* a) { return *reinterpret_cast<const float4*>(a); }

__device__ __forceinline__ void fma4(float4& acc, float tap, const float4& v) {
  acc.x += tap * v.x;
  acc.y += tap * v.y;
  acc.z += tap * v.z;
  acc.w += tap * v.w;
}

// One chunk of 8 taps of the H pass for 8 output rows x 4 columns: `lo`
// holds window rows t0 .. t0 + 7, `hi` gets rows t0 + 8 .. t0 + 15 here (src
// points at row t0). The products that need only `lo` go first, while `hi`
// loads; the caller swaps the two halves from chunk to chunk.
__device__ __forceinline__ void h_chunk(float4 (&acc)[8], const float4 (&lo)[8], float4 (&hi)[8],
                                        const float* src, int px, const float* taps) {
#pragma unroll
  for (int j = 0; j < 8; ++j) hi[j] = lds4(src + (8 + j) * px);
  const float4 ta = lds4(taps), tb = lds4(taps + 4);
  const float tap[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int j = 0; j < 8 - k; ++j) fma4(acc[j], tap[k], lo[k + j]);
  }
#pragma unroll
  for (int k = 1; k < 8; ++k) {
#pragma unroll
    for (int j = 8 - k; j < 8; ++j) fma4(acc[j], tap[k], hi[k + j - 8]);
  }
}

// The same for the W pass: 8 output columns of a row, window columns
// t0 .. t0 + 15 of it (src points at column t0).
__device__ __forceinline__ void w_chunk(float (&acc)[8], const float (&lo)[8], float (&hi)[8], const float* src,
                                        const float* taps) {
  const float4 a = lds4(src + 8), b = lds4(src + 12);
  hi[0] = a.x; hi[1] = a.y; hi[2] = a.z; hi[3] = a.w;
  hi[4] = b.x; hi[5] = b.y; hi[6] = b.z; hi[7] = b.w;
  const float4 ta = lds4(taps), tb = lds4(taps + 4);
  const float tap[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int j = 0; j < 8 - k; ++j) acc[j] += tap[k] * lo[k + j];
  }
#pragma unroll
  for (int k = 1; k < 8; ++k) {
#pragma unroll
    for (int j = 8 - k; j < 8; ++j) acc[j] += tap[k] * hi[k + j - 8];
  }
}

// The two halves of cluster.sync(), so that work can run between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// An arrive that orders nothing: for "done reading", since loads whose
// values a thread has stored are complete.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kClusterMaxThreads)
pyramid_cluster_kernel(const float* __restrict__ joined, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int h, int w, const __grid_constant__ ClusterParams c) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / c.cluster;
  const int r0 = rank * c.band;
  const int nk = max(0, min(c.band, h - r0));  // rows this CTA owns
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int wx = c.wx, px = c.px, rad = c.rad, pitch = c.pitch;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ts = xs + c.rows_x * px;
  float* pin = ts + c.band_pad * pitch;
  float* tp = pin + c.band * px;
  uint8_t* ms = reinterpret_cast<uint8_t*>(tp + c.ntaps);
  int* lv = reinterpret_cast<int*>(ms + round_up(c.band * c.mbp, 16));  // ry, rx, kyp, kxp, toff by level

  // zero what is read but never written, so it meets its zero taps or the
  // outputs that are dropped as a finite value: the rows of xs below the
  // band (its bottom halo is filled later), and the first 4 and the last
  // pitch - wx positions of each row of ts
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < (c.rows_x - rad - nk) * px / 4; i += nt)
    reinterpret_cast<float4*>(xs + (rad + nk) * px)[i] = zero;
  const int tail4 = (pitch - wx) / 4 + 1;
  for (int i = tid; i < c.band_pad * tail4; i += nt) {
    const int r = i / tail4;
    const int k = i - r * tail4;
    reinterpret_cast<float4*>(ts + r * pitch + (k == 0 ? 0 : wx + 4 * (k - 1)))[0] = zero;
  }
  for (int i = tid; i < c.ntaps; i += nt) tp[i] = c.taps[i];
  if (tid < kMaxLevels) {
    lv[tid] = c.ry[tid];
    lv[kMaxLevels + tid] = c.rx[tid];
    lv[2 * kMaxLevels + tid] = c.kyp[tid];
    lv[3 * kMaxLevels + tid] = c.kxp[tid];
    lv[4 * kMaxLevels + tid] = c.toff[tid];
  }

  // the band of joined (into pin) and of the mask (into ms), 8 columns a
  // thread, kStage groups' loads in flight before any store
  const size_t base = (static_cast<size_t>(img) * h + r0) * w;
  const int groups = wx / 8;
  const int items8 = nk * groups;
  for (int i0 = tid; i0 < items8; i0 += kStage * nt) {
    float jv[kStage][8];
    uint8_t mv[kStage][8];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * nt;
      const int r = i / groups;
      const int c0 = (i - r * groups) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = i < items8 && c0 + j < w;
        jv[u][j] = in ? __ldg(joined + base + static_cast<size_t>(r) * w + c0 + j) : 0.0f;
        mv[u][j] = in ? __ldg(mask + base + static_cast<size_t>(r) * w + c0 + j) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * nt;
      if (i < items8) {
        const int r = i / groups;
        const int g8 = i - r * groups;
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) bits |= (mv[u][j] ? 1u : 0u) << j;
        float4* d = reinterpret_cast<float4*>(pin + r * px + g8 * 8);
        d[0] = make_float4(jv[u][0], jv[u][1], jv[u][2], jv[u][3]);
        d[1] = make_float4(jv[u][4], jv[u][5], jv[u][6], jv[u][7]);
        ms[r * c.mbp + g8] = static_cast<uint8_t>(bits);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nk * px / 4; i += nt)
    reinterpret_cast<float4*>(xs + rad * px)[i] = reinterpret_cast<const float4*>(pin)[i];
  __syncthreads();
  cluster_arrive();  // this band is in place (and this CTA has started)

  for (int l = 0; l < c.levels; ++l) {
    const int kyp = lv[2 * kMaxLevels + l], kxp = lv[3 * kMaxLevels + l];
    if (kyp == 0) continue;
    const int ry = lv[l], rx = lv[kMaxLevels + l];
    const int off = round_up(rx, 4);
    const float* ty = tp + lv[4 * kMaxLevels + l];
    const float* tx = ty + kyp;
    const bool repin = l < c.levels - 1;

    // halo rows [rad - ry, rad) and [rad + nk, rad + nk + ry) from the
    // bands of their owners (DSMEM), kBatch loads in flight per thread
    cluster_wait();
    const int per_row = wx / 4;
    const int halo = 2 * ry * per_row;
    for (int i0 = tid; i0 < halo; i0 += kBatch * nt) {
      float4 hv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * nt;
        if (i < halo) {
          const int j = i / per_row;
          const int b = j < ry ? rad - ry + j : rad + nk + (j - ry);
          const int g = reflect(r0 - rad + b, h);
          const int owner = g / c.band;
          const float* src = cluster.map_shared_rank(xs, owner) + (rad + g - owner * c.band) * px;
          hv[u] = reinterpret_cast<const float4*>(src)[i - j * per_row];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * nt;
        if (i < halo) {
          const int j = i / per_row;
          const int b = j < ry ? rad - ry + j : rad + nk + (j - ry);
          reinterpret_cast<float4*>(xs + b * px)[i - j * per_row] = hv[u];
        }
      }
    }
    cluster_arrive_relaxed();  // this CTA has read what it needs of the others' bands
    __syncthreads();

    // H pass: view row v of this level is xs row v + rad - ry; output row r
    // reads view rows r .. r + 2 ry. A thread: 4 columns x 8 rows. Each
    // chunk of 8 taps first takes the products of the window's older half,
    // while the newer half is still loading.
    const float* xv = xs + (rad - ry) * px;
    const int cgroups = wx / 4;
    for (int tile = tid; tile < (c.band_pad / 8) * cgroups; tile += nt) {
      const int rg = tile / cgroups;
      const int c0 = (tile - rg * cgroups) * 4;
      const float* src = xv + rg * 8 * px + c0;
      float4 acc[8], a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        a[j] = lds4(src + j * px);
      }
      int t0 = 0;
      for (; t0 + 16 <= kyp; t0 += 16) {
        h_chunk(acc, a, b, src + t0 * px, px, ty + t0);
        h_chunk(acc, b, a, src + (t0 + 8) * px, px, ty + t0 + 8);
      }
      if (t0 < kyp) h_chunk(acc, a, b, src + t0 * px, px, ty + t0);
#pragma unroll
      for (int j = 0; j < 8; ++j) *reinterpret_cast<float4*>(ts + (rg * 8 + j) * pitch + off + c0) = acc[j];
    }
    __syncthreads();

    // the W pass's reflected halo: column -i is column i, column w - 1 + i
    // is column w - 1 - i
    for (int i = tid; i < nk * rx; i += nt) {
      const int r = i / rx;
      const int k = i - r * rx + 1;
      float* row = ts + r * pitch + off;
      row[-k] = row[k];
      row[w - 1 + k] = row[w - 1 - k];
    }
    __syncthreads();
    cluster_wait();  // no CTA reads this band any more this level

    // W pass, then the re-pin, into the band: output column c reads ts
    // positions c .. c + kxp - 1 (the level's taps after the shift zeros).
    // A thread: 8 columns of a row; consecutive threads take consecutive rows.
    for (int tile = tid; tile < nk * groups; tile += nt) {
      const int g8 = tile / nk;
      const int r = tile - g8 * nk;
      const int c0 = g8 * 8;
      const float* src = ts + r * pitch + c0;
      float acc[8], a[8], b[8];
      {
        const float4 u = lds4(src), v = lds4(src + 4);
        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
        a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      int t0 = 0;
      for (; t0 + 16 <= kxp; t0 += 16) {
        w_chunk(acc, a, b, src + t0, tx + t0);
        w_chunk(acc, b, a, src + t0 + 8, tx + t0 + 8);
      }
      if (t0 < kxp) w_chunk(acc, a, b, src + t0, tx + t0);
      if (repin) {
        const unsigned bits = ms[r * c.mbp + g8];
        const float4 a = lds4(pin + r * px + c0), b = lds4(pin + r * px + c0 + 4);
        const float pv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = (bits >> j) & 1u ? pv[j] : acc[j];
      }
      float4* d = reinterpret_cast<float4*>(xs + (rad + r) * px + c0);
      d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
    cluster_arrive();  // this band is final for the level
  }
  cluster_wait();

  for (int i = tid; i < nk * w; i += nt) {
    const int r = i / w;
    out[base + i] = xs[(rad + r) * px + i - r * w];
  }
}

// -------------------------------------------------------- 3. global memory
constexpr int kGlobalThreads = 256;

// dst[img, r, c] = sum_k taps[k] * src[img, reflect(r + k - P, h), c]
__global__ void __launch_bounds__(kGlobalThreads)
pyramid_hpass_kernel(const float* __restrict__ src, float* __restrict__ dst, long long total, int h, int w,
                     int ky, int off, const __grid_constant__ PyramidTaps p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % w);
  const long long row = i / w;  // img * h + r
  const int r = static_cast<int>(row % h);
  const float* col = src + (row - r) * w + c;
  const float* t = p.taps + off;
  const int pad = (ky - 1) / 2;
  float acc = 0.0f;
  for (int k = 0; k < ky; ++k) acc += t[k] * __ldg(col + static_cast<long long>(reflect(r + k - pad, h)) * w);
  dst[i] = acc;
}

// dst[img, r, c] = sum_k taps[k] * src[img, r, reflect(c + k - P, w)], then
// the re-pin: mask ? joined : dst
__global__ void __launch_bounds__(kGlobalThreads)
pyramid_wpass_kernel(const float* __restrict__ src, const float* __restrict__ joined,
                     const uint8_t* __restrict__ mask, float* __restrict__ dst, long long total, int w, int kx,
                     int off, int repin, const __grid_constant__ PyramidTaps p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % w);
  const float* row = src + (i - c);
  const float* t = p.taps + off;
  const int pad = (kx - 1) / 2;
  float acc = 0.0f;
  for (int k = 0; k < kx; ++k) acc += t[k] * __ldg(row + reflect(c + k - pad, w));
  if (repin && __ldg(mask + i)) acc = __ldg(joined + i);
  dst[i] = acc;
}

// ----------------------------------------------------- 4. backward (adjoint)
// With B_l the blur of level l (H pass, then W pass), the forward is
//   x_0 = joined; y_l = B_l(x_l); x_{l+1} = mask ? joined : y_l; out = y_{L-1}.
// Its adjoint for a cotangent g of `out` runs the levels from the last down:
//   gx_l = B_l^T(g) (the W pass's transpose, then the H pass's);
//   l >= 1: d_joined += mask ? gx_l : 0 and g = mask ? 0 : gx_l;
//   l = 0:  d_joined += gx_0.
// A pass's transpose is not the pass itself within (K - 1) / 2 pixels of an
// edge, where the single reflection folds taps back: the forward's output i
// reads input reflect(i + k - P), so input j gathers taps[k] * g[i] over
// every (i, k) with reflect(i + k - P) = j, i.e. i + k - P = j, = -j (j >= 1)
// or = 2 (n - 1) - j (j <= n - 2), with 0 <= i < n.
//
// Design: one global-memory buffer holds both sums, since they live on
// different pixels: d_joined on the pinned ones, the gradient passed down on
// the others (read as 0 where pinned). Per level one W-transpose kernel into
// a scratch image and one H-transpose kernel that writes gx, adding the
// pixel's d_joined where pinned: two launches a level, one thread an output
// pixel, taps read through L1/L2 as in design 3. Levels whose two passes
// have one tap each are the identity; they are skipped (a skipped last level
// starts the buffer as a copy of the cotangent). What bounds it: the same
// taps as the forward (operations at 240x320), or the cotangent, the mask and
// the gradient once each (bytes at 24x32); this simple design reads every tap
// from cache and is far from either (PERF.md has its time).

// sum over the (i, k) above of taps[k] * load(i), for output j of n
template <typename Load>
__device__ __forceinline__ float adjoint_taps(const Load& load, int j, int n, const float* t, int K) {
  const int P = (K - 1) / 2;
  float acc = 0.0f;
  for (int k = max(0, j + P - (n - 1)); k <= min(K - 1, j + P); ++k) acc += t[k] * load(j - k + P);
  if (j >= 1)
    for (int k = 0; k <= P - j; ++k) acc += t[k] * load(P - j - k);
  if (j <= n - 2)
    for (int k = max(0, n - 1 - j + P); k < K; ++k) acc += t[k] * load(2 * (n - 1) - j - k + P);
  return acc;
}

// a row of the incoming gradient; pinned pixels read as 0 when `masked`
struct RowLoad {
  const float* row;
  const uint8_t* mrow;
  int masked;
  __device__ __forceinline__ float operator()(int c) const {
    return masked && __ldg(mrow + c) ? 0.0f : __ldg(row + c);
  }
};

// a column of the scratch image
struct ColLoad {
  const float* col;
  int w;
  __device__ __forceinline__ float operator()(int r) const { return __ldg(col + static_cast<long long>(r) * w); }
};

// dst[img, r, c] = the W pass's transpose of src at (img, r, c)
__global__ void __launch_bounds__(kGlobalThreads)
pyramid_wpass_adjoint_kernel(const float* __restrict__ src, const uint8_t* __restrict__ mask,
                             float* __restrict__ dst, long long total, int w, int kx, int off, int masked,
                             const __grid_constant__ PyramidTaps p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % w);
  const RowLoad load{src + (i - c), mask + (i - c), masked};
  dst[i] = adjoint_taps(load, c, w, p.taps + off, kx);
}

// gx = the H pass's transpose of src at (img, r, c); dst = gx, plus dst's
// d_joined at a pinned pixel when `accumulate`
__global__ void __launch_bounds__(kGlobalThreads)
pyramid_hpass_adjoint_kernel(const float* __restrict__ src, const uint8_t* __restrict__ mask, float* dst,
                             long long total, int h, int w, int ky, int off, int accumulate,
                             const __grid_constant__ PyramidTaps p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % w);
  const long long row = i / w;  // img * h + r
  const int r = static_cast<int>(row % h);
  const ColLoad load{src + (row - r) * w + c, w};
  float acc = adjoint_taps(load, r, h, p.taps + off, ky);
  if (accumulate && __ldg(mask + i)) acc += dst[i];
  dst[i] = acc;
}

// A row pitch of at least n floats that is 4 more than a multiple of 32.
constexpr int skew_pitch(int n) { return n + ((4 - n % 32) + 32) % 32; }

// The cluster design's parameters for an h x w image with these taps, or
// false when no cluster of up to 8 CTAs holds it.
bool cluster_params(int h, int w, const float* taps, const int* ky, const int* kx, int levels,
                    ClusterParams* c) {
  int rad = 0, kxp_max = 8, ntaps = 0;
  c->levels = levels;
  for (int l = 0, src = 0; l < levels; ++l) {
    const int ry = (ky[l] - 1) / 2, rx = (kx[l] - 1) / 2, shift = round_up(rx, 4) - rx;
    const bool identity = ky[l] == 1 && kx[l] == 1;
    c->ry[l] = ry;
    c->rx[l] = rx;
    c->kyp[l] = identity ? 0 : round_up(ky[l], 8);
    c->kxp[l] = identity ? 0 : round_up(kx[l] + shift, 8);
    c->toff[l] = ntaps;
    for (int i = 0; i < c->kyp[l]; ++i) c->taps[ntaps + i] = i < ky[l] ? taps[src + i] : 0.0f;
    for (int i = 0; i < c->kxp[l]; ++i)
      c->taps[ntaps + c->kyp[l] + i] = i >= shift && i - shift < kx[l] ? taps[src + ky[l] + i - shift] : 0.0f;
    ntaps += c->kyp[l] + c->kxp[l];
    src += ky[l] + kx[l];
    rad = max(rad, ry);
    kxp_max = max(kxp_max, c->kxp[l]);
  }
  const int wx = round_up(w, 8);
  const int px = skew_pitch(wx);
  const int pitch = skew_pitch(wx + kxp_max);
  const int mbp = round_up(wx / 8, 8) + 4;
  for (int cs = 1; cs <= 8; cs *= 2) {
    const int band = (h + cs - 1) / cs;
    if ((cs - 1) * band >= h) break;  // a CTA would own no row
    const int band_pad = round_up(band, 8);
    const int rows_x = band_pad + 2 * rad + 8;
    const size_t floats = static_cast<size_t>(rows_x) * px + static_cast<size_t>(band_pad) * pitch +
                          static_cast<size_t>(band) * px + ntaps;
    const size_t smem = floats * 4 + static_cast<size_t>(round_up(band * mbp, 16)) + 5 * kMaxLevels * sizeof(int);
    if (smem > static_cast<size_t>(kSmemLimit)) continue;
    // enough threads for every H-pass tile at once, and as many as split
    // the W pass's tiles into equal rounds
    const int h_tiles = (band_pad / 8) * (wx / 4), w_tiles = band * (wx / 8);
    const int rounds = (w_tiles + kClusterMaxThreads - 1) / kClusterMaxThreads;
    const int threads = max(min(h_tiles, kClusterMaxThreads), (w_tiles + rounds - 1) / rounds);
    c->cluster = cs;
    c->band = band;
    c->band_pad = band_pad;
    c->rad = rad;
    c->wx = wx;
    c->px = px;
    c->pitch = pitch;
    c->mbp = mbp;
    c->rows_x = rows_x;
    c->ntaps = ntaps;
    c->threads = min(kClusterMaxThreads, max(64, round_up(threads, 32)));
    c->smem = smem;
    return true;
  }
  return false;
}

// The launch of the cluster design for n images (attr must outlive cfg).
cudaLaunchConfig_t cluster_config(const ClusterParams& c, int n, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * c.cluster));
  cfg.blockDim = dim3(c.threads);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool warp_path(int h, int w, const int* ky, const int* kx, int levels) {
  if ((h != 24 && h != 32) || w > 32 || (h * w) % 16 != 0) return false;
  for (int l = 0; l < levels; ++l)
    if (ky[l] > kWarpMaxK || kx[l] > kWarpMaxK) return false;
  return true;
}

bool valid_taps(int h, int w, const int* ky, const int* kx, int levels) {
  if (levels < 1 || levels > kMaxLevels || h < 1 || w < 1) return false;
  int total = 0;
  for (int l = 0; l < levels; ++l) {
    if (ky[l] < 1 || kx[l] < 1 || ky[l] % 2 == 0 || kx[l] % 2 == 0) return false;
    if ((ky[l] - 1) / 2 > h - 1 || (kx[l] - 1) / 2 > w - 1) return false;
    total += ky[l] + kx[l];
  }
  return total <= kMaxTaps;
}

}  // namespace

// Which design takes an h x w image: 0 for a warp per image, 1..8 for a
// cluster of that many CTAs, 9 for the global-memory design (launched by
// tacex_deformation_pyramid_global); -1 when the taps are not valid for the
// image.
extern "C" int tacex_deformation_pyramid_plan(int h, int w, const float* taps, const int* ky, const int* kx,
                                              int levels) {
  if (!valid_taps(h, w, ky, kx, levels)) return -1;
  if (warp_path(h, w, ky, kx, levels)) return 0;
  ClusterParams c{};
  return cluster_params(h, w, taps, ky, kx, levels, &c) ? c.cluster : 9;
}

// The global-memory design for n images: per level an H pass from the
// level's input (joined, then out) into `scratch` (n x h x w floats) and a
// W pass with the re-pin into `out`. Returns the CUDA error of the launches
// (0 = cudaSuccess); launches on `stream` and does not synchronise.
extern "C" int tacex_deformation_pyramid_global(const float* joined, const uint8_t* mask, float* out,
                                                float* scratch, const float* taps, const int* ky, const int* kx,
                                                int levels, int n, int h, int w, void* stream) {
  if (n < 0 || !valid_taps(h, w, ky, kx, levels)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PyramidTaps p;
  p.levels = levels;
  int total_taps = 0;
  for (int l = 0; l < levels; ++l) {
    p.ky[l] = ky[l];
    p.kx[l] = kx[l];
    total_taps += ky[l] + kx[l];
  }
  for (int i = 0; i < total_taps; ++i) p.taps[i] = taps[i];
  const long long total = static_cast<long long>(n) * h * w;
  const long long blocks = (total + kGlobalThreads - 1) / kGlobalThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* src = joined;
  for (int l = 0, off = 0; l < levels; off += ky[l] + kx[l], ++l) {
    if (ky[l] == 1 && kx[l] == 1) continue;  // the identity; its re-pin repeats the last one
    pyramid_hpass_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, s>>>(src, scratch, total, h, w, ky[l],
                                                                                 off, p);
    pyramid_wpass_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, s>>>(
        scratch, joined, mask, out, total, w, kx[l], off + ky[l], l < levels - 1 ? 1 : 0, p);
    src = out;
  }
  if (src == joined)  // every level is the identity
    return cudaMemcpyAsync(out, joined, total * sizeof(float), cudaMemcpyDeviceToDevice, s);
  return cudaGetLastError();
}

// Returns the CUDA error of the launch (0 = cudaSuccess). Launches on
// `stream` and does not synchronise.
extern "C" int tacex_deformation_pyramid(const float* joined, const uint8_t* mask, float* out,
                                         const float* taps, const int* ky, const int* kx, int levels,
                                         int n, int h, int w, void* stream) {
  if (n < 0 || !valid_taps(h, w, ky, kx, levels)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const bool aligned = (reinterpret_cast<uintptr_t>(joined) | reinterpret_cast<uintptr_t>(mask) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && warp_path(h, w, ky, kx, levels)) {
    PyramidTaps p;
    p.levels = levels;
    int total = 0;
    for (int l = 0; l < levels; ++l) {
      p.ky[l] = ky[l];
      p.kx[l] = kx[l];
      total += ky[l] + kx[l];
    }
    for (int i = 0; i < total; ++i) p.taps[i] = taps[i];
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (h == 24)
      pyramid_warp_kernel<24><<<blocks, kWarpsPerBlock * 32, 0, s>>>(joined, mask, out, n, w, p);
    else
      pyramid_warp_kernel<32><<<blocks, kWarpsPerBlock * 32, 0, s>>>(joined, mask, out, n, w, p);
    return cudaGetLastError();
  }

  ClusterParams c{};
  if (!cluster_params(h, w, taps, ky, kx, levels, &c)) return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * c.cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pyramid_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(c.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(c, n, s, attr);
  err = cudaLaunchKernelEx(&cfg, pyramid_cluster_kernel, joined, mask, out, h, w, c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The gradient in `joined` of the pyramid for the cotangent `grad_out` of its
// output (section 4), into `grad_joined`, with `scratch` (n x h x w floats)
// between a level's two passes. Returns the CUDA error of the launches
// (0 = cudaSuccess); launches on `stream` and does not synchronise.
extern "C" int tacex_deformation_pyramid_backward(const float* grad_out, const uint8_t* mask, float* grad_joined,
                                                  float* scratch, const float* taps, const int* ky, const int* kx,
                                                  int levels, int n, int h, int w, void* stream) {
  if (n < 0 || !valid_taps(h, w, ky, kx, levels)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PyramidTaps p;
  p.levels = levels;
  int off[kMaxLevels];
  int total_taps = 0;
  for (int l = 0; l < levels; ++l) {
    p.ky[l] = ky[l];
    p.kx[l] = kx[l];
    off[l] = total_taps;
    total_taps += ky[l] + kx[l];
  }
  for (int i = 0; i < total_taps; ++i) p.taps[i] = taps[i];
  const long long total = static_cast<long long>(n) * h * w;
  const long long blocks = (total + kGlobalThreads - 1) / kGlobalThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bool first = true;  // grad_joined holds nothing yet: read grad_out, unmasked
  for (int l = levels - 1; l >= 0; --l) {
    if (ky[l] == 1 && kx[l] == 1) {
      if (l == levels - 1) {
        const cudaError_t err =
            cudaMemcpyAsync(grad_joined, grad_out, total * sizeof(float), cudaMemcpyDeviceToDevice, s);
        if (err != cudaSuccess) return err;
        first = false;
      }
      continue;
    }
    pyramid_wpass_adjoint_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, s>>>(
        first ? grad_out : grad_joined, mask, scratch, total, w, kx[l], off[l] + ky[l], first ? 0 : 1, p);
    pyramid_hpass_adjoint_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0, s>>>(
        scratch, mask, grad_joined, total, h, w, ky[l], off[l], first ? 0 : 1, p);
    first = false;
  }
  return cudaGetLastError();
}
