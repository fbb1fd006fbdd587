// Region extraction of labelled page masks: root candidates, moments, extents.
//
// Replaces the TPU kernels of megreader_tpu/ops/pallas_extract.py (entry
// extract_regions_pallas):
//   * _candidates_kernel -> count_roots_kernel, rank_roots_kernel and
//     candidate_areas_kernel (mr_extract_candidates);
//   * _moments_kernel    -> moments_kernel (mr_extract_moments);
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
//     centroid sum/max(count, 1), the sums of dx^2, dy^2 and dx*dy, (B, K, 8)
//     float32, column 7 zero. Two slots with the same root (the empty slots
//     hold root 0) each get that root's sums. Count and first and second
//     moments come from exact int64 sums and an integer centring (see
//     moments_finish_kernel), bit-exact to the plain version and from launch to
//     launch; the score is a float64 sum (order-dependent, rtol 1e-6);
//   * extents: per slot, the min and max over its pixels of the projections
//     u = dx cos + dy sin and v = -dx sin + dy cos, dx = x - cx, dy = y - cy with
//     the slot's own (cx, cy, cos, sin), computed in float64 with one rounding
//     per operation (no contraction into FMAs, as PyTorch's elementwise ops
//     round) and rounded to float32: bit-exact to the plain version. A slot with
//     no pixel keeps the sentinels (+1e9, -1e9, +1e9, -1e9).
//
// Design. The candidates and extents kernels run on a grid of (pixel tiles of
// 4096, pages), 256 threads a block, each thread taking every 256th pixel of
// its tile, so a
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
//   * extents: each warp looks its 32 labels up against the K roots held in
//     shared memory, one ballot per slot; where any lane matches, the warp
//     reduces the members' terms with shuffles and one lane adds them to the
//     block's shared accumulators (float min/max by integer atomics). A block
//     flushes its slots to global memory once. Warps whose 32 pixels are all
//     background skip the slot loop.
//   * moments: one launch reads the labels and scores once and finds each
//     pixel's slot in a hash table of the roots; a small one writes the
//     float32 result (see the moments section).
//
// Bound: each function must read the labels once (and the scores once for the
// moments) and write K-sized outputs: 8 pages of 640x640 int32 are 13.1 MB,
// 3.9 us at 3.35 TB/s, 26.2 MB and 7.8 us with the scores. This design reads
// the labels three times for the candidates (plus a 1.6 MB-per-page
// root->slot scratch, L2-resident) and once for the extents, with K
// compare/ballot steps per active warp and round: there the operations, not
// the bytes, set its time. The moments read the labels and the scores once,
// with O(1) shared loads a pixel and one slot reduction a chunk of 128
// pixels on a text page.

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
//
// One pass over a page's labels and scores. A block takes whole rows (about
// kMomentTile pixels); each warp steps over 128-pixel chunks of those rows,
// 4 neighbouring pixels a lane (int4 and float4 loads where rows are 16-byte
// aligned), so x comes from the chunk and lane and y from the row. A pixel
// finds its slot in a per-block open-addressed table of the page's roots
// (8K entries or more, so that a label that is no root, most of a page's
// foreground, meets an empty entry at once; duplicates mapped to their
// lowest slot; a lane's 4 probes interleaved): no loop runs over K. The
// warp then takes one slot at a time, starting from the first lane that
// still holds a pixel of a slot: its lanes sum count, dx and dx^2 (dx = x
// less the chunk's origin, so each fits 32 bits) with redux and the score
// as a double with shuffles; six lanes then add the chunk's six integer sums
// (sum y, y^2 and xy follow from the row) to the block's shared int64
// accumulators at once, each a 64-bit add as two native 32-bit atomics, and
// a seventh lane the score to its warp's own double (a 64-bit or double
// shared atomicAdd is a compare-and-swap loop, slow under the block's 8
// warps on one text line). A text page's chunk touches one slot, and one
// iteration. Each block adds its live slots to the page's int64 scratch
// once; integer atomics are order-free, the score's double atomics across
// blocks are not. A second, small kernel (a block a page) finishes the K
// slots into float32: within 1 us of the last block of each page doing it
// behind a fence and a counter, and simpler.

constexpr int kMomentThreads = 256;
constexpr int kMomentWarps = kMomentThreads / 32;
constexpr int kMomentTile = 4096;  // pixels a block takes, in whole rows
constexpr int kChunk = 128;        // pixels a warp takes a step
// 64-bit words a slot: count, sum x, sum y, sum x^2, sum y^2, sum xy (int64),
// sum score (double; in the page scratch only), one unused. With
// check_moment_range (ops/extract.py) each sum, and each term of the finish,
// stays below 2^63.
constexpr int kSums = 8;

__device__ __forceinline__ unsigned root_hash(int root, int bits) {
  return (static_cast<unsigned>(root) * 2654435761u) >> (32 - bits);
}

// Fill the table (2^bits entries of (root, lowest slot)) with the page's K
// roots; roots < 0 match no pixel and stay out.
__device__ void build_root_table(int2* table, int bits, const int* __restrict__ roots, int K) {
  const int size = 1 << bits;
  for (int h = threadIdx.x; h < size; h += blockDim.x) table[h] = make_int2(-1, K);
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int r = roots[k];
    if (r < 0) continue;
    for (unsigned h = root_hash(r, bits);; h = (h + 1) & (size - 1)) {
      const int prev = atomicCAS(&table[h].x, -1, r);
      if (prev == -1 || prev == r) {
        atomicMin(&table[h].y, k);
        break;
      }
    }
  }
  __syncthreads();
}

// The lowest slot holding root r >= 0, or -1.
__device__ __forceinline__ int find_slot(const int2* table, int bits, int r) {
  const int mask = (1 << bits) - 1;
  for (unsigned h = root_hash(r, bits);; h = (h + 1) & mask) {
    const int2 e = table[h];
    if (e.x == r) return e.y;
    if (e.x == -1) return -1;
  }
}

// The slots of a lane's 4 labels (-1 for the background and for labels that
// are no root), the four lookups' probes interleaved.
__device__ __forceinline__ void find_slots(const int2* table, int bits, const int (&lab)[4],
                                           int (&slot)[4]) {
  const unsigned mask = (1u << bits) - 1;
  unsigned h[4], live = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    slot[j] = -1;
    h[j] = root_hash(lab[j], bits);
    if (lab[j] >= 0) live |= 1u << j;
  }
  while (live) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(live >> j & 1)) continue;
      const int2 e = table[h[j]];
      if (e.x == lab[j]) slot[j] = e.y;
      if (e.x == lab[j] || e.x == -1) live &= ~(1u << j);
      h[j] = (h[j] + 1) & mask;
    }
  }
}

// e - r2 / m in float64, one rounding each (no contraction): the plain
// version's arithmetic.
__device__ __forceinline__ float centred(long long e, long long r2, double m) {
  return __double2float_rn(__dsub_rn(__ll2double_rn(e), __ddiv_rn(__ll2double_rn(r2), m)));
}

// A 64-bit add to shared memory as two 32-bit atomics and a carry: the
// compiler makes a 64-bit shared atomicAdd a compare-and-swap loop.
__device__ __forceinline__ void shared_add_u64(unsigned long long* a, unsigned long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(a);
  const unsigned lo = static_cast<unsigned>(v), hi = static_cast<unsigned>(v >> 32);
  const unsigned old = atomicAdd(w, lo);
  const unsigned carry = old + lo < old ? 1u : 0u;  // this add wrapped the low word
  if (hi + carry) atomicAdd(w + 1, hi + carry);
}

// One chunk: 4 pixels of this lane at x0 + j (labels and scores given), in
// row y. Adds each slot's sums to the block's accumulators.
__device__ __forceinline__ void moments_chunk(const int (&lab)[4], const float (&s)[4], int x0,
                                              int xc, unsigned long long y, const int2* table,
                                              int bits, unsigned long long* acc,
                                              double* warp_score) {
  const int lane = threadIdx.x & 31;
  int slot[4];
  find_slots(table, bits, lab, slot);
  unsigned pend = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (slot[j] >= 0) pend |= 1u << j;
  for (;;) {
    const unsigned lanes = __ballot_sync(kFull, pend != 0);
    if (lanes == 0) break;
    const int lead = __ffs(lanes) - 1;
    int mine = -1;
#pragma unroll
    for (int j = 3; j >= 0; --j)
      if (pend >> j & 1) mine = slot[j];
    const int k = __shfl_sync(kFull, mine, lead);
    unsigned n = 0, d = 0, d2 = 0;  // d = x - xc < 128
    double sc = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((pend >> j & 1) && slot[j] == k) {
        const unsigned dj = static_cast<unsigned>(x0 + j - xc);
        n += 1, d += dj, d2 += dj * dj;
        sc += static_cast<double>(s[j]);
        pend &= ~(1u << j);
      }
    }
    n = __reduce_add_sync(kFull, n);
    d = __reduce_add_sync(kFull, d);
    d2 = __reduce_add_sync(kFull, d2);
    sc = warp_sum(sc);
    // lanes 0-5 add the chunk's six integer sums to the block's slot, one
    // each; lane 6 the score to the warp's own slot, with no atomic
    const unsigned long long N = n, X0 = static_cast<unsigned long long>(xc);
    const unsigned long long sx = N * X0 + d;
    if (lane < 6) {
      const unsigned long long v = lane == 0   ? N
                                   : lane == 1 ? sx
                                   : lane == 2 ? N * y
                                   : lane == 3 ? N * X0 * X0 + 2 * X0 * d + d2
                                   : lane == 4 ? N * y * y
                                               : sx * y;
      shared_add_u64(acc + k * kSums + lane, v);
    } else if (lane == 6) {
      warp_score[k] += sc;
    }
  }
}

// A lane's 4 labels and scores of a chunk (label -1 past the row's end).
template <bool kVec>
__device__ __forceinline__ void load_chunk(int (&lab)[4], float (&s)[4],
                                           const int* __restrict__ lrow,
                                           const float* __restrict__ srow, int x0, int W) {
  if (kVec) {
    int4 l = make_int4(-1, -1, -1, -1);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (x0 < W) {
      l = *reinterpret_cast<const int4*>(lrow + x0);
      v = *reinterpret_cast<const float4*>(srow + x0);
    }
    lab[0] = l.x, lab[1] = l.y, lab[2] = l.z, lab[3] = l.w;
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lab[j] = x0 + j < W ? lrow[x0 + j] : -1;
      s[j] = x0 + j < W ? srow[x0 + j] : 0.f;
    }
  }
}

// Grid (row tiles, pages). kVec: W % 4 == 0 and 16-byte aligned pages.
// sums (B, K, kSums) are zero at launch.
template <bool kVec>
__global__ void __launch_bounds__(kMomentThreads)
    moments_kernel(const int* __restrict__ labels, const float* __restrict__ scores,
                   const int* __restrict__ roots, unsigned long long* sums, int H, int W,
                   int K, int rows, int bits) {
  extern __shared__ unsigned long long msmem[];
  unsigned long long* acc = msmem;                            // K x kSums
  int2* table = reinterpret_cast<int2*>(acc + K * kSums);    // 2^bits entries
  double* warp_score = reinterpret_cast<double*>(table + (1 << bits));  // warps x K
  const int b = blockIdx.y;
  const int* rt = roots + static_cast<int64_t>(b) * K;
  for (int i = threadIdx.x; i < K * kSums; i += kMomentThreads) acc[i] = 0;
  for (int i = threadIdx.x; i < kMomentWarps * K; i += kMomentThreads) warp_score[i] = 0.0;
  build_root_table(table, bits, rt, K);

  const int64_t page = static_cast<int64_t>(b) * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_row = (W + kChunk - 1) / kChunk;
  const int y0 = static_cast<int>(blockIdx.x) * rows, y1 = min(H, y0 + rows);
  int y = y0 + warp / per_row, c = warp % per_row;
  int lab[4];  // this chunk's, while the next chunk's are loading
  float s[4];
  if (y < y1) {
    const int64_t r = page + static_cast<int64_t>(y) * W;
    load_chunk<kVec>(lab, s, labels + r, scores + r, c * kChunk + 4 * lane, W);
  }
  while (y < y1) {
    int yn = y, cn = c + kMomentWarps;
    while (cn >= per_row) cn -= per_row, ++yn;
    int next[4] = {-1, -1, -1, -1};
    float next_s[4] = {0.f, 0.f, 0.f, 0.f};
    if (yn < y1) {
      const int64_t r = page + static_cast<int64_t>(yn) * W;
      load_chunk<kVec>(next, next_s, labels + r, scores + r, cn * kChunk + 4 * lane, W);
    }
    moments_chunk(lab, s, c * kChunk + 4 * lane, c * kChunk, y, table, bits, acc,
                  warp_score + warp * K);
#pragma unroll
    for (int j = 0; j < 4; ++j) lab[j] = next[j], s[j] = next_s[j];
    y = yn, c = cn;
  }
  __syncthreads();

  unsigned long long* page_sums = sums + static_cast<int64_t>(b) * K * kSums;
  for (int k = threadIdx.x; k < K; k += kMomentThreads) {
    const unsigned long long* a = acc + k * kSums;
    if (a[0] == 0) continue;
    unsigned long long* g = page_sums + k * kSums;
#pragma unroll
    for (int c2 = 0; c2 < 6; ++c2) atomicAdd(g + c2, a[c2]);
    double score = 0.0;
    for (int w = 0; w < kMomentWarps; ++w) score += warp_score[w * K + k];
    atomicAdd(reinterpret_cast<double*>(g + 6), score);
  }
}

// The finish, a block a page, after every block's sums are in: slot k takes
// the sums of the lowest slot with its root.
__global__ void __launch_bounds__(kMomentThreads)
    moments_finish_kernel(const int* __restrict__ roots, const unsigned long long* sums,
                          float* __restrict__ out, int K, int bits) {
  extern __shared__ int2 ftable[];
  const int b = blockIdx.x;
  const int* rt = roots + static_cast<int64_t>(b) * K;
  build_root_table(ftable, bits, rt, K);
  const long long* page_sums = reinterpret_cast<const long long*>(sums) + int64_t{b} * K * kSums;
  float* page_out = out + static_cast<int64_t>(b) * K * 8;
  for (int k = threadIdx.x; k < K; k += kMomentThreads) {
    const int r = rt[k];
    const int f = r >= 0 ? find_slot(ftable, bits, r) : -1;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (f >= 0) {
      const long long* a = page_sums + f * kSums;
      const long long n = a[0], sx = a[1], sy = a[2], sxx = a[3], syy = a[4], sxy = a[5];
      const double score = __longlong_as_double(a[6]);
      const long long m = n > 1 ? n : 1;
      const long long qx = sx / m, rx = sx % m, qy = sy / m, ry = sy % m;
      const double dm = __ll2double_rn(m);
      lo = make_float4(__double2float_rn(__ll2double_rn(n)), __double2float_rn(score),
                       __double2float_rn(__ll2double_rn(sx)),
                       __double2float_rn(__ll2double_rn(sy)));
      hi = make_float4(centred(sxx - qx * qx * n - 2 * qx * rx, rx * rx, dm),
                       centred(syy - qy * qy * n - 2 * qy * ry, ry * ry, dm),
                       centred(sxy - qx * qy * n - qx * ry - qy * rx, rx * ry, dm), 0.f);
    }
    float4* o = reinterpret_cast<float4*>(page_out + k * 8);
    o[0] = lo;
    o[1] = hi;
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

// labels (B, H, W) int32, scores (B, H, W) float32, roots (B, K) int32 -> out
// (B, K, 8) float32. scratch: B * K * kSums 64-bit words, zeroed here.
extern "C" int mr_extract_moments(const void* labels, const void* scores, const void* roots,
                                  void* scratch, void* out, int B, int H, int W, int K,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t N = static_cast<int64_t>(H) * W;
  if (B > 0 && K > 0 && N == 0)
    cudaMemsetAsync(out, 0, static_cast<size_t>(B) * K * 8 * sizeof(float), st);
  if (B > 0 && K > 0 && N > 0) {
    unsigned long long* sums = static_cast<unsigned long long*>(scratch);
    cudaMemsetAsync(sums, 0, static_cast<size_t>(B) * K * kSums * sizeof(*sums), st);
    // the pass's table holds 8K entries or more, so that a label that is no
    // root (most of a page's foreground) finds an empty entry at once; the
    // finish's, 2K or more
    int bits = 1, finish_bits = 1;
    while ((1 << bits) < 8 * K) ++bits;
    while ((1 << finish_bits) < 2 * K) ++finish_bits;
    const int rows = W < kMomentTile ? kMomentTile / W : 1;
    const dim3 grid((H + rows - 1) / rows, B);
    const size_t smem = K * kSums * sizeof(unsigned long long) +
                        (size_t{1} << bits) * sizeof(int2) + kMomentWarps * K * sizeof(double);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(scores) % 16 == 0;
    auto kernel = vec ? moments_kernel<true> : moments_kernel<false>;
    if (smem > 48 * 1024) {  // above 48 KB a kernel opts in
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int* rts = static_cast<const int*>(roots);
    kernel<<<grid, kMomentThreads, smem, st>>>(static_cast<const int*>(labels),
                                               static_cast<const float*>(scores), rts, sums, H,
                                               W, K, rows, bits);
    moments_finish_kernel<<<B, kMomentThreads, (size_t{1} << finish_bits) * sizeof(int2), st>>>(
        rts, sums, static_cast<float*>(out), K, finish_bits);
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
