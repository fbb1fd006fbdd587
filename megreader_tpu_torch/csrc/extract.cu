// Region extraction of labelled page masks: root candidates, moments, extents.
//
// Replaces the TPU kernels of megreader_tpu/ops/pallas_extract.py (entry
// extract_regions_pallas):
//   * _candidates_kernel -> count_roots_kernel, rank_roots_kernel and
//     candidate_areas_kernel (mr_extract_candidates);
//   * _moments_kernel    -> moments_first_kernel and moments_centered_kernel
//     (mr_extract_moments);
//   * _extents_kernel    -> extents_kernel (mr_extract_extents).
// Contract, shared with the plain PyTorch versions in
// megreader_tpu_torch/ops/extract.py (*_reference):
//   * labels (B, H, W) int32, a pixel's label is the linear index y*W+x of its
//     component's root (its raster-first pixel), background -1;
//   * candidates: the first K2 roots of a page in raster order take slots
//     0..K2-1 (cand_idx, dead slots 0) and their exact pixel counts (areas, dead
//     slots 0); components past K2 roots count nowhere. Integers, bit-exact;
//   * moments: per slot k with root r_k, over the pixels labelled r_k: count,
//     sum of scores, sum of x, sum of y, then, centred on the slot's own
//     centroid sum/max(count, 1), the sums of dx^2, dy^2 and dx*dy
//     (B, K, 8) float64 sums, column 7 zero. Two slots with the same root (the
//     empty slots hold root 0) each get that root's sums;
//   * extents: per slot, the min and max over its pixels of the projections
//     u = dx cos + dy sin and v = -dx sin + dy cos, dx = x - cx, dy = y - cy with
//     the slot's own (cx, cy, cos, sin), computed in float64 with one rounding
//     per operation (no contraction into FMAs, as PyTorch's elementwise ops
//     round) and rounded to float32: bit-exact to the plain version. A slot with
//     no pixel keeps the sentinels (+1e9, -1e9, +1e9, -1e9).
//
// Design. Every kernel runs on a grid of (pixel tiles of 4096, pages), 256
// threads a block, each thread taking every 256th pixel of its tile, so a
// warp reads 32 neighbouring labels (coalesced). The TPU kernels' (K, W) strip
// layout exists for Mosaic's vector registers and is not copied.
//   * candidates: one pass counts each tile's roots; a second ranks them in
//     raster order (the tile's base is the sum of the page's earlier tiles'
//     counts, then a warp ballot and a block scan of 8 warp totals per round of
//     256 pixels) and writes each root's slot, or -1 past K2, into a page-sized
//     root->slot scratch; a third adds each pixel to its root's slot, in a
//     shared-memory histogram of K2 counters with warp-aggregated atomics
//     (__match_any_sync), flushed once per block with global atomics. A
//     label that names no root (the capped CCL state) counts nowhere, as in
//     the TPU kernel, whose slots compare labels with their roots.
//   * moments, extents: each warp looks its 32 labels up against the K roots
//     held in shared memory, one ballot per slot; where any lane matches, the
//     warp reduces the members' terms with shuffles and one lane adds them to
//     the block's shared accumulators (double atomicAdd, or float min/max by
//     integer atomics). A block flushes its slots to global memory once.
//     Warps whose 32 pixels are all background skip the slot loop. The moments
//     take two launches: the centred pass needs every block's first sums.
//
// Bound: each function must read the labels once (and the scores once for the
// moments) and write K-sized outputs: 8 pages of 640x640 int32 are 13.1 MB,
// 3.9 us at 3.35 TB/s. This design reads the labels three times (candidates:
// plus a 1.6 MB-per-page root->slot scratch, L2-resident), twice (moments)
// and once (extents), and does K compare/ballot steps per active warp and
// round: the operations, not the bytes, set its time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // pixels per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Float min/max through integer atomics: non-negative floats order as signed
// ints, negative floats in reverse as unsigned ints. Exact for every stored
// value and every v other than -0.0, which the callers turn into +0.0.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// ---------------------------------------------------------------- candidates

__global__ void __launch_bounds__(kThreads)
    count_roots_kernel(const int* __restrict__ labels, int* __restrict__ tile_counts,
                       int N, int T) {
  const int b = blockIdx.y;
  const int* l = labels + static_cast<int64_t>(b) * N;
  int total = 0;
  for (int r = 0; r < kRounds; ++r) {
    const int i = blockIdx.x * kTile + r * kThreads + threadIdx.x;
    total += __syncthreads_count(i < N && l[i] == i);
  }
  if (threadIdx.x == 0) tile_counts[static_cast<int64_t>(b) * T + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    rank_roots_kernel(const int* __restrict__ labels, const int* __restrict__ tile_counts,
                      int* __restrict__ cand_idx, int* __restrict__ slot_of, int N, int T,
                      int K2) {
  __shared__ int warp_total[kWarps];
  __shared__ int base;
  const int b = blockIdx.y;
  const int* l = labels + static_cast<int64_t>(b) * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {  // roots in the page's earlier tiles
    int s = 0;
    for (int t = lane; t < static_cast<int>(blockIdx.x); t += 32)
      s += tile_counts[static_cast<int64_t>(b) * T + t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) base = s;
  }
  __syncthreads();
  int running = base;
  for (int r = 0; r < kRounds; ++r) {
    const int i = blockIdx.x * kTile + r * kThreads + threadIdx.x;
    const bool root = i < N && l[i] == i;
    const unsigned ballot = __ballot_sync(kFull, root);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_total[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (root) {
      const int rank = running + before + __popc(ballot & ((1u << lane) - 1u));
      if (rank < K2) cand_idx[static_cast<int64_t>(b) * K2 + rank] = i;
      slot_of[static_cast<int64_t>(b) * N + i] = rank < K2 ? rank : -1;
    }
    running += total;
    __syncthreads();  // warp_total is written again next round
  }
}

__global__ void __launch_bounds__(kThreads)
    candidate_areas_kernel(const int* __restrict__ labels, const int* __restrict__ slot_of,
                           int* __restrict__ areas, int N, int K2) {
  extern __shared__ int hist[];  // K2 counters
  const int b = blockIdx.y;
  const int* l = labels + static_cast<int64_t>(b) * N;
  const int* so = slot_of + static_cast<int64_t>(b) * N;
  for (int k = threadIdx.x; k < K2; k += kThreads) hist[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const int i = blockIdx.x * kTile + r * kThreads + threadIdx.x;
    const int lab = i < N ? l[i] : -1;
    // slot_of holds an entry for every root only: under a capped CCL a label
    // may name a pixel that is no root, and such pixels count nowhere
    const int slot = lab >= 0 && l[lab] == lab ? so[lab] : -1;
    const unsigned peers = __match_any_sync(kFull, slot);
    if (slot >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[slot], __popc(peers));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K2; k += kThreads)
    if (hist[k]) atomicAdd(&areas[static_cast<int64_t>(b) * K2 + k], hist[k]);
}

// ------------------------------------------------------------------- moments

__global__ void __launch_bounds__(kThreads)
    moments_first_kernel(const int* __restrict__ labels, const float* __restrict__ scores,
                         const int* __restrict__ roots, double* __restrict__ sums, int N,
                         int W, int K) {
  extern __shared__ double smem[];
  double* acc = smem;                                   // K x (count, score, x, y)
  int* root = reinterpret_cast<int*>(acc + 4 * K);
  const int b = blockIdx.y;
  const int* l = labels + static_cast<int64_t>(b) * N;
  const float* sc = scores + static_cast<int64_t>(b) * N;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    root[k] = roots[static_cast<int64_t>(b) * K + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[4 * k + c] = 0.0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const int i = blockIdx.x * kTile + r * kThreads + threadIdx.x;
    const int lab = i < N ? l[i] : -1;
    if (!__any_sync(kFull, lab >= 0)) continue;
    const double s = lab >= 0 ? static_cast<double>(sc[i]) : 0.0;
    const double x = lab >= 0 ? static_cast<double>(i % W) : 0.0;
    const double y = lab >= 0 ? static_cast<double>(i / W) : 0.0;
    for (int k = 0; k < K; ++k) {
      const bool m = lab == root[k];
      const unsigned ballot = __ballot_sync(kFull, m);
      if (ballot == 0) continue;
      const double vs = warp_sum(m ? s : 0.0);
      const double vx = warp_sum(m ? x : 0.0);
      const double vy = warp_sum(m ? y : 0.0);
      if (lane == 0) {
        atomicAdd(&acc[4 * k], static_cast<double>(__popc(ballot)));
        atomicAdd(&acc[4 * k + 1], vs);
        atomicAdd(&acc[4 * k + 2], vx);
        atomicAdd(&acc[4 * k + 3], vy);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    if (acc[4 * k] == 0.0) continue;
    double* out = sums + (static_cast<int64_t>(b) * K + k) * 8;
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(&out[c], acc[4 * k + c]);
  }
}

__global__ void __launch_bounds__(kThreads)
    moments_centered_kernel(const int* __restrict__ labels, const int* __restrict__ roots,
                            double* __restrict__ sums, int N, int W, int K) {
  extern __shared__ double smem[];
  double* acc = smem;                                   // K x (dx^2, dy^2, dx dy)
  double* cen = acc + 3 * K;                            // K x (cx, cy)
  int* root = reinterpret_cast<int*>(cen + 2 * K);
  const int b = blockIdx.y;
  const int* l = labels + static_cast<int64_t>(b) * N;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const double* first = sums + (static_cast<int64_t>(b) * K + k) * 8;
    const double count = fmax(first[0], 1.0);  // the kernel's own count
    root[k] = roots[static_cast<int64_t>(b) * K + k];
    cen[2 * k] = first[2] / count;
    cen[2 * k + 1] = first[3] / count;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[3 * k + c] = 0.0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const int i = blockIdx.x * kTile + r * kThreads + threadIdx.x;
    const int lab = i < N ? l[i] : -1;
    if (!__any_sync(kFull, lab >= 0)) continue;
    const double x = lab >= 0 ? static_cast<double>(i % W) : 0.0;
    const double y = lab >= 0 ? static_cast<double>(i / W) : 0.0;
    for (int k = 0; k < K; ++k) {
      const bool m = lab == root[k];
      if (__ballot_sync(kFull, m) == 0) continue;
      const double dx = x - cen[2 * k], dy = y - cen[2 * k + 1];
      const double vxx = warp_sum(m ? dx * dx : 0.0);
      const double vyy = warp_sum(m ? dy * dy : 0.0);
      const double vxy = warp_sum(m ? dx * dy : 0.0);
      if (lane == 0) {
        atomicAdd(&acc[3 * k], vxx);
        atomicAdd(&acc[3 * k + 1], vyy);
        atomicAdd(&acc[3 * k + 2], vxy);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    double* out = sums + (static_cast<int64_t>(b) * K + k) * 8 + 4;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (acc[3 * k + c] != 0.0) atomicAdd(&out[c], acc[3 * k + c]);
  }
}

// ------------------------------------------------------------------- extents

__global__ void init_extents_kernel(float* __restrict__ ext, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < n) ext[j] = (j & 1) ? -kBig : kBig;
}

__global__ void __launch_bounds__(kThreads)
    extents_kernel(const int* __restrict__ labels, const int* __restrict__ roots,
                   const float* __restrict__ params, float* __restrict__ ext, int N, int W,
                   int K) {
  extern __shared__ float fsmem[];
  float* acc = fsmem;                                   // K x (min u, max u, min v, max v)
  float* prm = acc + 4 * K;                             // K x (cx, cy, cos, sin)
  int* root = reinterpret_cast<int*>(prm + 4 * K);
  const int b = blockIdx.y;
  const int* l = labels + static_cast<int64_t>(b) * N;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    root[k] = roots[static_cast<int64_t>(b) * K + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      prm[4 * k + c] = params[(static_cast<int64_t>(b) * K + k) * 4 + c];
      acc[4 * k + c] = (c & 1) ? -kBig : kBig;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const int i = blockIdx.x * kTile + r * kThreads + threadIdx.x;
    const int lab = i < N ? l[i] : -1;
    if (!__any_sync(kFull, lab >= 0)) continue;
    const double x = lab >= 0 ? static_cast<double>(i % W) : 0.0;
    const double y = lab >= 0 ? static_cast<double>(i / W) : 0.0;
    for (int k = 0; k < K; ++k) {
      const bool m = lab == root[k];
      if (__ballot_sync(kFull, m) == 0) continue;
      const double dx = __dsub_rn(x, static_cast<double>(prm[4 * k]));
      const double dy = __dsub_rn(y, static_cast<double>(prm[4 * k + 1]));
      const double c = prm[4 * k + 2], s = prm[4 * k + 3];
      float u = __double2float_rn(__dadd_rn(__dmul_rn(dx, c), __dmul_rn(dy, s)));
      float v = __double2float_rn(__dadd_rn(__dmul_rn(-dx, s), __dmul_rn(dy, c)));
      if (u == 0.0f) u = 0.0f;  // -0.0 -> +0.0 for the integer atomics
      if (v == 0.0f) v = 0.0f;
      const float u0 = warp_min(m ? u : kBig), u1 = warp_max(m ? u : -kBig);
      const float v0 = warp_min(m ? v : kBig), v1 = warp_max(m ? v : -kBig);
      if (lane == 0) {
        atomic_min_float(&acc[4 * k], u0);
        atomic_max_float(&acc[4 * k + 1], u1);
        atomic_min_float(&acc[4 * k + 2], v0);
        atomic_max_float(&acc[4 * k + 3], v1);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    if (acc[4 * k] == kBig) continue;  // no pixel of this slot in the tile
    float* out = ext + (static_cast<int64_t>(b) * K + k) * 4;
    atomic_min_float(&out[0], acc[4 * k]);
    atomic_max_float(&out[1], acc[4 * k + 1]);
    atomic_min_float(&out[2], acc[4 * k + 2]);
    atomic_max_float(&out[3], acc[4 * k + 3]);
  }
}

int tiles(int N) { return (N + kTile - 1) / kTile; }

}  // namespace

extern "C" int mr_extract_tile_pixels() { return kTile; }

// labels (B, N) int32; scratch tile_counts (B, ceil(N / tile)) and slot_of
// (B, N) int32; outputs cand_idx and areas (B, K2) int32, zeroed here.
extern "C" int mr_extract_candidates(const void* labels, void* tile_counts, void* slot_of,
                                     void* cand_idx, void* areas, int B, int N, int K2,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = static_cast<size_t>(B) * K2 * sizeof(int);
  cudaMemsetAsync(cand_idx, 0, out_bytes, st);
  cudaMemsetAsync(areas, 0, out_bytes, st);
  if (B > 0 && N > 0) {
    const int T = tiles(N);
    const dim3 grid(T, B);
    const int* lbl = static_cast<const int*>(labels);
    count_roots_kernel<<<grid, kThreads, 0, st>>>(lbl, static_cast<int*>(tile_counts), N, T);
    rank_roots_kernel<<<grid, kThreads, 0, st>>>(lbl, static_cast<const int*>(tile_counts),
                                                 static_cast<int*>(cand_idx),
                                                 static_cast<int*>(slot_of), N, T, K2);
    candidate_areas_kernel<<<grid, kThreads, K2 * sizeof(int), st>>>(
        lbl, static_cast<const int*>(slot_of), static_cast<int*>(areas), N, K2);
  }
  return static_cast<int>(cudaGetLastError());
}

// labels (B, N) int32, scores (B, N) float32, roots (B, K) int32 -> sums
// (B, K, 8) float64, zeroed here.
extern "C" int mr_extract_moments(const void* labels, const void* scores, const void* roots,
                                  void* sums, int B, int N, int W, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(sums, 0, static_cast<size_t>(B) * K * 8 * sizeof(double), st);
  if (B > 0 && N > 0 && K > 0) {
    const dim3 grid(tiles(N), B);
    const int* lbl = static_cast<const int*>(labels);
    const int* rts = static_cast<const int*>(roots);
    double* out = static_cast<double*>(sums);
    moments_first_kernel<<<grid, kThreads, K * (4 * sizeof(double) + sizeof(int)), st>>>(
        lbl, static_cast<const float*>(scores), rts, out, N, W, K);
    moments_centered_kernel<<<grid, kThreads, K * (5 * sizeof(double) + sizeof(int)), st>>>(
        lbl, rts, out, N, W, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// labels (B, N) int32, roots (B, K) int32, params (B, K, 4) float32 (cx, cy,
// cos, sin) -> ext (B, K, 4) float32 (min u, max u, min v, max v).
extern "C" int mr_extract_extents(const void* labels, const void* roots, const void* params,
                                  void* ext, int B, int N, int W, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(B) * K * 4;
  if (n > 0)
    init_extents_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        static_cast<float*>(ext), n);
  if (B > 0 && N > 0 && K > 0) {
    const dim3 grid(tiles(N), B);
    extents_kernel<<<grid, kThreads, K * (8 * sizeof(float) + sizeof(int)), st>>>(
        static_cast<const int*>(labels), static_cast<const int*>(roots),
        static_cast<const float*>(params), static_cast<float*>(ext), N, W, K);
  }
  return static_cast<int>(cudaGetLastError());
}
