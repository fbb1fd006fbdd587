// Region extraction of labelled page masks: root candidates, moments, extents.
//
// Replaces the TPU kernels of megreader_tpu/ops/pallas_extract.py (entry
// extract_regions_pallas):
//   * _candidates_kernel -> rank_roots_kernel and candidate_areas_kernel
//     (mr_extract_candidates);
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
// Design. The TPU kernels' (K, W) strip layout exists for Mosaic's vector
// registers and is not copied. Every pass reads 128-pixel chunks a warp, 4
// neighbouring pixels a lane (int4 loads where the page allows), and finds a
// pixel's slot by probing its label in a per-block hash table of the page's
// roots in shared memory (see the root table), so no pass loops over the
// slots:
//   * candidates: two passes over the labels, 4096-pixel tiles. The first
//     ranks each tile's roots in the page by a chained scan with decoupled
//     look-back and writes the first K2 to cand_idx; the second counts each
//     live candidate's pixels through a table of them (see the candidates
//     section). Scratch: a status word a tile, K2 counts a page.
//   * moments: one pass over the labels and scores, then a small kernel that
//     writes the float32 result (see the moments section).
//   * extents: one pass over the labels on the moments' skeleton; the table
//     leads to a chain of the slots that share a root, each projected with
//     its own parameters (see the extents section).
//
// Bound: each function must read the labels once (and the scores once for the
// moments) and write K-sized outputs: 8 pages of 640x640 int32 are 13.1 MB,
// 3.9 us at 3.35 TB/s, 26.2 MB and 7.8 us with the scores. The candidates read
// the labels twice, the moments and extents once. What keeps them above the
// bound is latency, not bytes: a block's chunks load in few steps, and a
// chunk that holds several slots (the first rows of a noise page, a chain of
// dead slots on a component at pixel 0) reduces and adds each in turn.
// Shared memory a block: candidates 8 bytes a table entry (8 K2 entries,
// fewer past 192 KB: 2 K2 at K2 8192, 160 KB) and 4 a slot; moments 128 a
// slot and 64 (8 K entries) for the table; extents 40 a slot and 64 for the
// table (104 KB at K 1024). Above 48 KB the launchers opt in.

#include <cstdint>
#include <cuda_runtime.h>

// Timing hooks: scripts/extract_probe.py --stamps builds a copy of this file
// that defines EXTRACT_STAMP(kernel, tag) to record %globaltimer; empty here.
#ifndef EXTRACT_STAMP
#define EXTRACT_STAMP(kernel, tag)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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

// ------------------------------------------------------------ the root table
//
// A per-block open-addressed table of a page's roots in shared memory: each
// pass finds a pixel's slot by probing its label, with no loop over the slots.

constexpr int kChunk = 128;  // pixels a warp takes a step, 4 a lane
constexpr int kGroup = 4;    // chunks a warp loads at once

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

// A lane's 4 labels at l + i (-1 from index n on). kVec: i and n multiples of
// 4 and l 16-byte aligned, so the 4 lie wholly before n or from it.
template <bool kVec>
__device__ __forceinline__ void load_labels(int (&lab)[4], const int* __restrict__ l, int64_t i,
                                            int64_t n) {
  if (kVec) {
    int4 v = make_int4(-1, -1, -1, -1);
    if (i < n) v = *reinterpret_cast<const int4*>(l + i);
    lab[0] = v.x, lab[1] = v.y, lab[2] = v.z, lab[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) lab[j] = i + j < n ? l[i + j] : -1;
  }
}

// ---------------------------------------------------------------- candidates
//
// Two passes over a page's labels, each block a tile of 4096 pixels (a warp
// 512 of them, as 4 chunks of 128 with int4 loads).
//   * rank_roots_kernel counts its tile's roots (a warp scan of a byte a
//     chunk, a block sum of 8 warps) and finds their rank in the page by a
//     chained scan with decoupled look-back: a block publishes its tile's
//     count, then warp 0 sums the counts of up to 32 earlier tiles at a time
//     until it meets a published page prefix, and publishes its own.
//     A root of rank < K2 is written to its slot of cand_idx; the page's last
//     tile writes 0 into the dead slots.
//   * candidate_areas_kernel puts the page's live candidates (the first
//     min(roots, K2)) in a shared table, finds each pixel's slot by a probe of
//     its label, counts a warp's pixels of a slot with redux and one shared
//     atomic (or each lane its own, where a slot covers under 4 lanes), and
//     adds its counts to the page's once. The last block of a page
//     (a fence and a counter) writes the page's K2 areas as float32. A label
//     that names no root (the capped CCL state) and a root past K2 are in no
//     table, so they count nowhere, as in the TPU kernel.

constexpr int kCandThreads = 256;
constexpr int kCandWarps = kCandThreads / 32;
constexpr int kCandTile = kCandWarps * kGroup * kChunk;  // pixels a block
// look-back status of a tile: flag in the high word, count or prefix in the low
constexpr unsigned long long kCountReady = 1ull << 32, kPrefixReady = 2ull << 32;

// A 1-D grid of B * T blocks. A block takes its tile from a ticket, one
// atomicAdd on a counter, and not from blockIdx.x: ticket g is tile g % T of
// page g / T. Every lower ticket was drawn by a block that is already running,
// so the look-back waits only on tiles that are in progress or done, in
// whatever order the card starts the blocks. status (B, T) and the ticket
// counter are zero at launch.
template <bool kVec>
__global__ void __launch_bounds__(kCandThreads)
    rank_roots_kernel(const int* __restrict__ labels, unsigned long long* status,
                      unsigned* ticket, int* __restrict__ cand_idx, int N, int T, int K2) {
  __shared__ int s_warp[kCandWarps], s_prefix, s_ticket;
  EXTRACT_STAMP(0, 0);
  if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int b = s_ticket / T, t = s_ticket % T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* l = labels + static_cast<int64_t>(b) * N;
  const int64_t base =
      static_cast<int64_t>(t) * kCandTile + warp * kGroup * kChunk + 4 * lane;
  static_assert(kGroup == 4, "a lane's roots are 16 mask bits, counted a byte a chunk");
  int lab[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) load_labels<kVec>(lab[r], l, base + r * kChunk, N);
  unsigned mask = 0;  // bit 4r + j: pixel base + 128 r + j is a root
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lab[r][j] == static_cast<int>(base + r * kChunk + j)) mask |= 1u << (4 * r + j);
  // the warp's roots before each lane, a byte per chunk (at most 128 each)
  unsigned packed = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    packed |= static_cast<unsigned>(__popc(mask >> (4 * r) & 0xfu)) << (8 * r);
  unsigned incl = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const unsigned excl = incl - packed, totals = __shfl_sync(kFull, incl, 31);
  if (lane == 0)
    s_warp[warp] = (totals & 0xff) + (totals >> 8 & 0xff) + (totals >> 16 & 0xff) + (totals >> 24);
  __syncthreads();
  EXTRACT_STAMP(0, 1);
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kCandWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    count += c;
  }

  if (warp == 0) {  // the look-back
    unsigned long long* st = status + static_cast<int64_t>(b) * T;
    if (lane == 0)
      atomicExch(st + t, (t == 0 ? kPrefixReady : kCountReady) | static_cast<unsigned>(count));
    unsigned prefix = 0;
    for (int hi = t - 1; hi >= 0; hi -= 32) {
      const int idx = hi - lane;
      unsigned long long s;
      for (int spins = 0;; ++spins) {
        s = idx >= 0 ? atomicAdd(st + idx, 0ull) : kPrefixReady;
        if (!__any_sync(kFull, (s >> 32) == 0)) break;
        if (spins > (1 << 22)) __trap();  // an earlier tile never published: fail, not hang
      }
      const unsigned done = __ballot_sync(kFull, (s >> 32) == 2);
      const int stop = done ? __ffs(done) - 1 : 31;  // the nearest published prefix
      prefix += __reduce_add_sync(kFull, lane <= stop ? static_cast<unsigned>(s) : 0u);
      if (done) break;
    }
    if (lane == 0) {
      if (t > 0) atomicExch(st + t, kPrefixReady | (prefix + count));
      s_prefix = static_cast<int>(prefix);
    }
  }
  __syncthreads();
  EXTRACT_STAMP(0, 2);
  const int prefix = s_prefix;
  int* ci = cand_idx + static_cast<int64_t>(b) * K2;
  if (prefix < K2 && mask) {
    int rank = prefix + before;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const unsigned m = mask >> (4 * r) & 0xfu;
      const int at = rank + static_cast<int>(excl >> (8 * r) & 0xff);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = at + __popc(m & ((1u << j) - 1u));
        if ((m >> j & 1) && k < K2) ci[k] = static_cast<int>(base + r * kChunk + j);
      }
      rank += static_cast<int>(totals >> (8 * r) & 0xff);
    }
  }
  if (t == T - 1)  // the page's dead slots
    for (int k = min(prefix + count, K2) + threadIdx.x; k < K2; k += kCandThreads) ci[k] = 0;
  EXTRACT_STAMP(0, 3);
}

// One chunk: adds this warp's pixels of each slot to the block's counts.
// While the first lane's slot holds pixels of 4 lanes or more, the warp
// counts it together (redux, one atomic); the rest each lane adds alone.
__device__ __forceinline__ void count_chunk(const int (&lab)[4], const int2* table, int bits,
                                            int* hist) {
  int slot[4];
  find_slots(table, bits, lab, slot);
  unsigned pend = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (slot[j] >= 0) pend |= 1u << j;
  for (;;) {
    const unsigned lanes = __ballot_sync(kFull, pend != 0);
    if (lanes == 0) return;
    const int lead = __ffs(lanes) - 1;
    int mine = -1;
#pragma unroll
    for (int j = 3; j >= 0; --j)
      if (pend >> j & 1) mine = slot[j];
    const int k = __shfl_sync(kFull, mine, lead);
    unsigned in = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((pend >> j & 1) && slot[j] == k) in |= 1u << j;
    if (__popc(__ballot_sync(kFull, in != 0)) < 4) break;
    pend &= ~in;
    const unsigned n = __reduce_add_sync(kFull, __popc(in));
    if ((threadIdx.x & 31) == 0) atomicAdd(hist + k, static_cast<int>(n));
  }
  while (pend) {
    const int k = slot[__ffs(pend) - 1];
    unsigned in = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((pend >> j & 1) && slot[j] == k) in |= 1u << j;
    pend &= ~in;
    atomicAdd(hist + k, __popc(in));
  }
}

// Grid (T, B), after rank_roots_kernel. counts (B, K2) and done (B) are zero
// at launch; areas (B, K2) float32 are written by each page's last block.
template <bool kVec>
__global__ void __launch_bounds__(kCandThreads)
    candidate_areas_kernel(const int* __restrict__ labels,
                           const unsigned long long* __restrict__ status,
                           const int* __restrict__ cand_idx, int* counts, unsigned* done,
                           float* __restrict__ areas, int N, int T, int K2, int bits) {
  extern __shared__ int2 csmem[];
  int2* table = csmem;                                    // 2^bits entries
  int* hist = reinterpret_cast<int*>(table + (1 << bits));  // K2
  __shared__ bool s_last;
  EXTRACT_STAMP(1, 0);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* l = labels + static_cast<int64_t>(b) * N;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kCandTile + warp * kGroup * kChunk + 4 * lane;
  int lab[kGroup][4];  // loading while the table is built
#pragma unroll
  for (int r = 0; r < kGroup; ++r) load_labels<kVec>(lab[r], l, base + r * kChunk, N);
  const int live = min(static_cast<int>(static_cast<unsigned>(status[int64_t{b} * T + T - 1])), K2);
  for (int k = threadIdx.x; k < live; k += kCandThreads) hist[k] = 0;
  build_root_table(table, bits, cand_idx + static_cast<int64_t>(b) * K2, live);
  EXTRACT_STAMP(1, 1);
  if (live > 0) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) count_chunk(lab[r], table, bits, hist);
  }
  EXTRACT_STAMP(1, 2);
  __syncthreads();
  EXTRACT_STAMP(1, 3);

  int* page_counts = counts + static_cast<int64_t>(b) * K2;
  for (int k = threadIdx.x; k < live; k += kCandThreads)
    if (hist[k]) atomicAdd(page_counts + k, hist[k]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {  // every block of the page has added its counts
    __threadfence();
    float* page_areas = areas + static_cast<int64_t>(b) * K2;
    for (int k = threadIdx.x; k < K2; k += kCandThreads)
      page_areas[k] = static_cast<float>(__ldcg(page_counts + k));
  }
  EXTRACT_STAMP(1, 4);
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
// 64-bit words a slot: count, sum x, sum y, sum x^2, sum y^2, sum xy (int64),
// sum score (double; in the page scratch only), one unused. With
// check_moment_range (ops/extract.py) each sum, and each term of the finish,
// stays below 2^63.
constexpr int kSums = 8;

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
//
// One pass over a page's labels on the moments pass's skeleton: a block takes
// whole rows, each warp 128-pixel chunks of them, 4 at a time with int4 loads
// (the first 4 while the block builds its table), and a pixel finds the lowest
// slot of its root in the block's table. Unlike the moments, the extents
// depend on each slot's own (cx, cy, cos, sin), and slots that share a root
// (the dead slots' root 0) may differ in them: the table's entry leads to a
// chain of the slots with that root and distinct parameters (next, in
// increasing order; a slot whose root and parameters repeat an earlier one's
// takes that one's result, so the dead slots are one link), and a member
// pixel is projected for each link. Text pages have chains of one slot. The
// four extents of a slot are kept as minima of order-preserving 32-bit keys
// (a maximum as the minimum of the complements), so one atomicMin folds each
// in. Where a warp's first chain covers 4 lanes or more, the warp reduces its
// keys with redux and lanes 0-3 fold them in at once; the rest of a chunk
// (a noise page's dozen components) each lane folds in alone. Min and max are
// order-free, so the result is the same bits on every launch. A block
// flushes its touched slots once, with the sign-split float atomics, into the
// output that a small kernel has filled with the sentinels: one launch,
// against the two of a memset of a key scratch and a finishing kernel (the
// moments' memset and finish take 1.1 and 3.4 us, PERF.md).

__global__ void init_extents_kernel(float* __restrict__ ext, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < n) ext[j] = (j & 1) ? -kBig : kBig;
}

// Links the slots k with use(k) into chains: next[k] is the next such slot
// with the same root (-1 at a chain's end) and each table entry's .y the
// chain's head (its lowest slot). Warp 0 takes the slots 32 at a time from
// the last, so each chain runs in increasing order.
template <typename Use>
__device__ void link_chains(int2* table, int bits, const int* __restrict__ roots, int K,
                            int* next, Use use) {
  const int mask = (1 << bits) - 1;
  for (int h = threadIdx.x; h <= mask; h += blockDim.x) table[h].y = -1;
  __syncthreads();
  const int lane = threadIdx.x;
  for (int base = (K - 1) & ~31; threadIdx.x < 32 && base >= 0; base -= 32) {
    const int k = base + lane;
    const int r = k < K && use(k) ? roots[k] : -1;
    const unsigned peers = __match_any_sync(kFull, r);
    int h = -1;
    if (r >= 0) {
      h = static_cast<int>(root_hash(r, bits));
      while (table[h].x != r) h = (h + 1) & mask;
      const unsigned above = peers & ~((2u << lane) - 1u);  // later slots of this root here
      next[k] = above ? base + __ffs(above) - 1 : table[h].y;
    }
    __syncwarp();
    if (r >= 0 && lane == __ffs(peers) - 1) table[h].y = k;  // the chain's new head
    __syncwarp();
  }
  __syncthreads();
}

__device__ __forceinline__ bool same_params(float4 a, float4 b) {
  return __float_as_uint(a.x) == __float_as_uint(b.x) &&
         __float_as_uint(a.y) == __float_as_uint(b.y) &&
         __float_as_uint(a.z) == __float_as_uint(b.z) &&
         __float_as_uint(a.w) == __float_as_uint(b.w);
}

// The slots of each root as chains of their distinct parameters: rep[k] is
// the first slot of k's chain with k's root and bitwise the same (cx, cy,
// cos, sin), whose extents k takes (the dead slots, root 0 and the same
// parameters, share one), and only such representatives are linked: a table
// entry holds (root, lowest slot), next[k] the next representative. Roots < 0
// match no pixel and stay out.
__device__ void build_root_chains(int2* table, int bits, const int* __restrict__ roots, int K,
                                  const float4* prm, int* next, int* rep) {
  const int size = 1 << bits;
  build_root_table(table, bits, roots, K);
  link_chains(table, bits, roots, K, next, [](int) { return true; });
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int r = roots[k];
    int j = k;
    if (r >= 0) {
      int h = static_cast<int>(root_hash(r, bits));
      while (table[h].x != r) h = (h + 1) & (size - 1);
      for (j = table[h].y; !same_params(prm[j], prm[k]); j = next[j]) {
      }
    }
    rep[k] = j;
  }
  __syncthreads();
  link_chains(table, bits, roots, K, next, [rep](int k) { return rep[k] == k; });
}

// Float order as unsigned order (for -0.0 the callers pass +0.0), and back.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A warp's group of chunks g, g + 8, ... of a block's rows (from row y0, n
// chunks in all), loaded together: 4 labels a lane each (-1 past the end).
template <bool kVec>
__device__ __forceinline__ void load_group(int (&lab)[kGroup][4],
                                           const int* __restrict__ page_labels, int W, int y0,
                                           int per_row, int n, int g) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    const int idx = g + q * kMomentWarps;
    if (idx < n) {
      load_labels<kVec>(lab[q], page_labels + static_cast<int64_t>(y0 + idx / per_row) * W,
                        idx % per_row * kChunk + 4 * lane, W);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) lab[q][j] = -1;
    }
  }
}

// This lane's pixels `in` of a chunk (4 pixels at x0 + j, row y) projected
// for slot k: the minima of their keys and of the keys' complements (the
// maxima), as (min u, ~max u, min v, ~max v); all ones where `in` is empty.
__device__ __forceinline__ uint4 project(float4 p, unsigned in, int x0, double yd) {
  const double cx = p.x, c = p.z, s = p.w;
  const double dy = __dsub_rn(yd, static_cast<double>(p.y));
  uint4 m = make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!(in >> j & 1)) continue;
    const double dx = __dsub_rn(static_cast<double>(x0 + j), cx);
    float u = __double2float_rn(__dadd_rn(__dmul_rn(dx, c), __dmul_rn(dy, s)));
    float v = __double2float_rn(__dadd_rn(__dmul_rn(-dx, s), __dmul_rn(dy, c)));
    if (u == 0.0f) u = 0.0f;  // -0.0 -> +0.0
    if (v == 0.0f) v = 0.0f;
    const unsigned ku = float_key(u), kv = float_key(v);
    m = make_uint4(min(m.x, ku), min(m.y, ~ku), min(m.z, kv), min(m.w, ~kv));
  }
  return m;
}

// One chunk: 4 pixels of this lane at x0 + j (labels given), in row y. Folds
// each slot's projections into the block's keys acc (K x 4 words, each a
// minimum). While the first lane's chain holds pixels of 4 lanes or more,
// the warp takes it together (a text line's chunk holds one chain): it
// reduces the four keys with redux and lanes 0-3 fold them in at once. The
// rest (a noise page's chunk holds a dozen small components) each lane folds
// in alone, four atomics a slot.
__device__ __forceinline__ void extents_chunk(const int (&lab)[4], int x0, int y,
                                              const int2* table, int bits, const int* next,
                                              const float4* prm, unsigned* acc) {
  const int lane = threadIdx.x & 31;
  int slot[4];
  find_slots(table, bits, lab, slot);
  unsigned pend = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (slot[j] >= 0) pend |= 1u << j;
  const double yd = static_cast<double>(y);
  for (;;) {
    const unsigned lanes = __ballot_sync(kFull, pend != 0);
    if (lanes == 0) return;
    const int lead = __ffs(lanes) - 1;
    int mine = -1;
#pragma unroll
    for (int j = 3; j >= 0; --j)
      if (pend >> j & 1) mine = slot[j];
    const int head = __shfl_sync(kFull, mine, lead);
    unsigned in = 0;  // this lane's pixels of the chain
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((pend >> j & 1) && slot[j] == head) in |= 1u << j;
    if (__popc(__ballot_sync(kFull, in != 0)) < 4) break;
    pend &= ~in;
    for (int k = head; k >= 0; k = next[k]) {
      const uint4 m = project(prm[k], in, x0, yd);
      const unsigned r0 = __reduce_min_sync(kFull, m.x), r1 = __reduce_min_sync(kFull, m.y);
      const unsigned r2 = __reduce_min_sync(kFull, m.z), r3 = __reduce_min_sync(kFull, m.w);
      if (lane < 4)
        atomicMin(acc + 4 * k + lane, lane == 0 ? r0 : lane == 1 ? r1 : lane == 2 ? r2 : r3);
    }
  }
  while (pend) {
    const int head = slot[__ffs(pend) - 1];
    unsigned in = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((pend >> j & 1) && slot[j] == head) in |= 1u << j;
    pend &= ~in;
    for (int k = head; k >= 0; k = next[k]) {
      const uint4 m = project(prm[k], in, x0, yd);
      atomicMin(acc + 4 * k, m.x);
      atomicMin(acc + 4 * k + 1, m.y);
      atomicMin(acc + 4 * k + 2, m.z);
      atomicMin(acc + 4 * k + 3, m.w);
    }
  }
}

// Grid (row tiles, pages). kVec: W % 4 == 0 and 16-byte aligned labels. ext
// (B, K, 4) holds the sentinels at launch.
template <bool kVec>
__global__ void __launch_bounds__(kMomentThreads)
    extents_kernel(const int* __restrict__ labels, const int* __restrict__ roots,
                   const float* __restrict__ params, float* __restrict__ ext, int H, int W,
                   int K, int rows, int bits) {
  extern __shared__ uint4 esmem[];
  unsigned* acc = reinterpret_cast<unsigned*>(esmem);  // K x (min u, ~max u, min v, ~max v)
  float4* prm = reinterpret_cast<float4*>(esmem + K);  // K x (cx, cy, cos, sin)
  int2* table = reinterpret_cast<int2*>(prm + K);      // 2^bits entries
  int* next = reinterpret_cast<int*>(table + (1 << bits));  // K
  int* rep = next + K;                                      // K
  EXTRACT_STAMP(2, 0);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* page_labels = labels + static_cast<int64_t>(b) * H * W;
  const int per_row = (W + kChunk - 1) / kChunk;
  const int y0 = static_cast<int>(blockIdx.x) * rows;
  const int n = (min(H, y0 + rows) - y0) * per_row;  // chunks of this block
  int lab[kGroup][4];  // the first group's labels load while the table is built
  load_group<kVec>(lab, page_labels, W, y0, per_row, n, warp);

  const int* rt = roots + static_cast<int64_t>(b) * K;
  const float* pp = params + static_cast<int64_t>(b) * K * 4;
  const unsigned lo = float_key(kBig), hi = ~float_key(-kBig);  // the sentinels as keys
  for (int k = threadIdx.x; k < K; k += kMomentThreads) {
    reinterpret_cast<uint4*>(acc)[k] = make_uint4(lo, hi, lo, hi);
    prm[k] = make_float4(pp[4 * k], pp[4 * k + 1], pp[4 * k + 2], pp[4 * k + 3]);
  }
  build_root_chains(table, bits, rt, K, prm, next, rep);
  EXTRACT_STAMP(2, 1);

  for (int g = warp;;) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int idx = g + q * kMomentWarps;
      if (idx < n)
        extents_chunk(lab[q], idx % per_row * kChunk + 4 * lane, y0 + idx / per_row, table, bits,
                      next, prm, acc);
    }
    g += kGroup * kMomentWarps;
    if (g >= n) break;
    load_group<kVec>(lab, page_labels, W, y0, per_row, n, g);
  }
  EXTRACT_STAMP(2, 2);
  __syncthreads();
  EXTRACT_STAMP(2, 3);

  for (int k = threadIdx.x; k < K; k += kMomentThreads) {
    const uint4 a = reinterpret_cast<const uint4*>(acc)[rep[k]];
    float* out = ext + (static_cast<int64_t>(b) * K + k) * 4;
    if (a.x != lo) atomic_min_float(out, key_float(a.x));
    if (a.y != hi) atomic_max_float(out + 1, key_float(~a.y));
    if (a.z != lo) atomic_min_float(out + 2, key_float(a.z));
    if (a.w != hi) atomic_max_float(out + 3, key_float(~a.w));
  }
  EXTRACT_STAMP(2, 4);
}

// The least bits with 2^bits >= n (at least 1).
int table_bits(int64_t n) {
  int bits = 1;
  while ((int64_t{1} << bits) < n) ++bits;
  return bits;
}

// Above 48 KB of dynamic shared memory a kernel opts in.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// The candidates' scratch in bytes: look-back status (B, T) as 64-bit words,
// then the pages' done counters (B), counts (B, K2) and the rank pass's
// ticket counter.
extern "C" long long mr_extract_candidates_scratch_bytes(int B, int N, int K2) {
  const int64_t T = (int64_t{N} + kCandTile - 1) / kCandTile;
  return int64_t{B} * T * 8 + (int64_t{B} + int64_t{B} * K2 + 1) * 4;
}

// labels (B, N) int32 -> cand_idx (B, K2) int32, areas (B, K2) float32;
// scratch of mr_extract_candidates_scratch_bytes, zeroed here.
extern "C" int mr_extract_candidates(const void* labels, void* scratch, void* cand_idx,
                                     void* areas, int B, int N, int K2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && N == 0) {
    cudaMemsetAsync(cand_idx, 0, static_cast<size_t>(B) * K2 * sizeof(int), st);
    cudaMemsetAsync(areas, 0, static_cast<size_t>(B) * K2 * sizeof(float), st);
  }
  if (B > 0 && N > 0) {
    const int T = (N + kCandTile - 1) / kCandTile;
    cudaMemsetAsync(scratch, 0, mr_extract_candidates_scratch_bytes(B, N, K2), st);
    unsigned long long* status = static_cast<unsigned long long*>(scratch);
    unsigned* done = reinterpret_cast<unsigned*>(status + int64_t{B} * T);
    int* counts = reinterpret_cast<int*>(done + B);
    unsigned* ticket = reinterpret_cast<unsigned*>(counts + int64_t{B} * K2);
    // the table: 8 K2 entries where they fit, at least 2 K2
    int bits = table_bits(8 * int64_t{K2});
    auto smem = [&](int bb) { return (size_t{1} << bb) * sizeof(int2) + K2 * sizeof(int); };
    while (smem(bits) > 192 * 1024 && (1 << bits) > 2 * K2) --bits;
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
    auto rank = vec ? rank_roots_kernel<true> : rank_roots_kernel<false>;
    auto area = vec ? candidate_areas_kernel<true> : candidate_areas_kernel<false>;
    const cudaError_t err = opt_in(area, smem(bits));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int* lbl = static_cast<const int*>(labels);
    rank<<<static_cast<unsigned>(int64_t{B} * T), kCandThreads, 0, st>>>(
        lbl, status, ticket, static_cast<int*>(cand_idx), N, T, K2);
    area<<<dim3(T, B), kCandThreads, smem(bits), st>>>(lbl, status,
                                                      static_cast<const int*>(cand_idx), counts,
                                                      done, static_cast<float*>(areas), N, T,
                                                      K2, bits);
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
    const int bits = table_bits(8 * K), finish_bits = table_bits(2 * K);
    const int rows = W < kMomentTile ? kMomentTile / W : 1;
    const dim3 grid((H + rows - 1) / rows, B);
    const size_t smem = K * kSums * sizeof(unsigned long long) +
                        (size_t{1} << bits) * sizeof(int2) + kMomentWarps * K * sizeof(double);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(scores) % 16 == 0;
    auto kernel = vec ? moments_kernel<true> : moments_kernel<false>;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int* rts = static_cast<const int*>(roots);
    kernel<<<grid, kMomentThreads, smem, st>>>(static_cast<const int*>(labels),
                                               static_cast<const float*>(scores), rts, sums, H,
                                               W, K, rows, bits);
    moments_finish_kernel<<<B, kMomentThreads, (size_t{1} << finish_bits) * sizeof(int2), st>>>(
        rts, sums, static_cast<float*>(out), K, finish_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// labels (B, H, W) int32, roots (B, K) int32, params (B, K, 4) float32 (cx,
// cy, cos, sin) -> ext (B, K, 4) float32 (min u, max u, min v, max v).
extern "C" int mr_extract_extents(const void* labels, const void* roots, const void* params,
                                  void* ext, int B, int H, int W, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(B) * K * 4;
  if (n > 0)
    init_extents_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        static_cast<float*>(ext), n);
  if (n > 0 && H > 0 && W > 0) {
    const int bits = table_bits(8 * K);
    const int rows = W < kMomentTile ? kMomentTile / W : 1;
    const dim3 grid((H + rows - 1) / rows, B);
    const size_t smem = K * (sizeof(uint4) + sizeof(float4) + 2 * sizeof(int)) +
                        (size_t{1} << bits) * sizeof(int2);
    const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(labels) % 16 == 0;
    auto kernel = vec ? extents_kernel<true> : extents_kernel<false>;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMomentThreads, smem, st>>>(
        static_cast<const int*>(labels), static_cast<const int*>(roots),
        static_cast<const float*>(params), static_cast<float*>(ext), H, W, K, rows, bits);
  }
  return static_cast<int>(cudaGetLastError());
}
