// 4-connected component labelling of binary page masks: the capped sweep, each
// sweep spread over the whole card in one cooperative, persistent launch.
//
// Replaces the TPU kernel megreader_tpu/ops/pallas_ccl.py::_ccl_kernel (entry
// connected_components_pallas). Contract, shared with the plain PyTorch version
// megreader_tpu_torch/ops/ccl.py::connected_components_reference and with the JAX
// XLA solve (megreader_tpu/ops/ccl.py::_ccl_single):
//   * input  (B, H, W) uint8 mask, output (B, H, W) int32 labels;
//   * a pixel starts with its own linear index y*W+x, background holds -1 (no
//     sweep reads it); with a seed array (the multigrid solve of
//     ops/ccl.py::connected_components(multigrid=True), after the JAX
//     _ccl_multigrid_single), it starts with min(y*W+x, seed) instead;
//   * one sweep is L <- C(R(L)): R gives every pixel of a horizontal run of mask
//     pixels the run's minimum, C then does the same along each vertical run
//     (the reference's forward-then-backward running min along a line gives
//     exactly these integers). A page stops after the first sweep that changes
//     nothing or after max_iters sweeps (at least one), so labels under the cap
//     are bit-identical to the reference on serpentine masks. A union-find solve
//     would converge in one launch but would not reproduce the capped state,
//     which is why this kernel keeps the sweep structure.
//
// Design: one cooperative launch, grid = what co-resides on the card (occupancy
// x SMs), capped at the useful work; cooperative_groups grid.sync() separates the
// phases, so the whole capped solve runs with no host synchronisation. The mask
// is read once, to set the labels up; from then on a label < 0 is background.
// Measured, the cost of a phase is its chain of dependent steps, not its bytes:
// on an H100 SXM an L2 hit takes about 370 cycles and a grid barrier about
// 1.15 us (scripts/ccl_probe.py). So each phase is one load of everything an
// item needs, then work in registers and shared memory, then the stores.
//   * row phase: one warp per (page, row). The warp loads 640 pixels at a time
//     (lane i on pixel 32c + i: coalesced, all loads in flight), transposes
//     them through shared memory so that lane i owns 20 consecutive pixels,
//     takes its runs to their in-segment minimum in registers, and keeps three
//     summaries: the minimum of the run at each end, and whether one run spans
//     it. Two shuffle scans of those summaries across the lanes (a segmented
//     min, see compose) give each lane the minimum entering from either side,
//     and the lane rewrites its edge runs. A longer row carries the run at each
//     640-pixel tile's right edge forward, then walks back over its tiles.
//   * column phase: one block per (page, strip of S columns), thread = (column,
//     segment of rows); the lanes of one segment read one row's S columns, so
//     each load is S consecutive ints (S = 16 at 640x640: 64-byte segments,
//     every sector used). A thread copies its segment into its own slots of
//     shared memory (all loads in flight), scans its runs there, and the
//     segment summaries go down and up the column by segmented Hillis-Steele
//     scans in shared memory. S is the widest of 32, 16, 8, 4 whose segments
//     of at most 64 rows span the page (a taller page runs in row tiles, with
//     carries as the rows), narrowed until the strips outnumber the SMs, and
//     narrowed again in later sweeps as pages converge.
//   * changed flags: a block notes the pages it changed in shared memory and
//     stores one flag per page at the end of the sweep, each flag on its own
//     L2 line (thousands of warps storing to one line queue for tens of us).
//     Two buffers by sweep parity: after the barrier every block reads the
//     same flags into shared memory (which pages are still active, and so
//     whether any is), and the other buffer is cleared after the next row
//     phase, when every block has read it. So the loop condition is uniform
//     across the grid, and converged pages are skipped. Each page also counts
//     the sweeps it ran (the reference's count).
//   * memory ordering: labels and flags are read with ld.global.cg (L2, never
//     the non-coherent L1 or read-only path) and written in place; the mask is
//     read-only and takes __ldg.
//
// Bound (as chip_smoke.py counts it, unchanged since the first version): each
// sweep does a min/compare and a select per pixel in each of 4 passes, INT32
// work at 132 SMs x 64 lanes x 1.98 GHz = 16.7 T/s: 1.6 us per sweep of 8 pages
// at 640^2; the function reads the mask once and writes the labels once, 5 bytes
// a pixel (16.4 MB, 4.9 us at 3.35 TB/s), so past 3 sweeps operations bound it.
//
// L2 traffic per sweep of this design: each phase reads every label of an
// active page once (4 B a pixel; a row or column longer than one tile reads
// most of it twice) and writes the labels that fall (at most 4 B): 8-16 B a
// pixel a sweep, 26-52 MB for 8 pages at 640^2, all of it L2-resident (the
// labels take 13 MB of the 50 MB). What sets its time: a sweep is at least two
// barriers, one flag read, and per phase one load round trip and its scans;
// when many pages are active, the items queue for the grid's blocks.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowSeg = 20;      // pixels of a row tile a lane owns
constexpr int kRowTile = 32 * kRowSeg;  // pixels of a row a warp holds at once
constexpr int kRowSmem = 32 * (kRowSeg + 1);  // ints of a warp's row tile
constexpr int kSegRows = 64;     // rows of a column segment at most (a 64-bit mask)
constexpr int kFlagStride = 32;  // ints between two changed flags: one L2 line each
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const uint8_t* mask;
  const int* seed;  // (B, H, W) start labels, min'd with the own index; or nullptr
  int* labels;
  int* scratch;  // B sweep counts, then 2 x B changed flags (see flag_offset)
  int B, H, W, max_iters;
  int sms;  // SMs of the card
};

// Where the changed flags start in the scratch: after the B sweep counts,
// rounded up to a whole L2 line.
__host__ __device__ inline int64_t flag_offset(int B) {
  return (static_cast<int64_t>(B) + kFlagStride - 1) / kFlagStride * kFlagStride;
}

// The strip width of a sweep with `pages` active pages: the widest of 32, 16,
// 8, 4 columns whose segments (kThreads / strip of them, at most kSegRows rows
// each) span the page's height in one tile, narrowed until the strips
// outnumber the SMs, so that the active pages still fill the card.
__host__ __device__ inline int strip_for(int pages, int H, int W, int sms) {
  int strip = 32;
  while (strip > 4 && kThreads / strip * kSegRows < H) strip /= 2;
  while (strip > 4 && static_cast<int64_t>(pages) * ((W + strip - 1) / strip) < sms)
    strip /= 2;
  return strip;
}

// The column tiles of a strip of `strip` columns: rows a tile covers, rows a
// segment covers.
__host__ __device__ inline void column_shape(int strip, int H, int* tile_rows,
                                             int* seg_rows) {
  const int segs = kThreads / strip;
  *tile_rows = H < segs * kSegRows ? H : segs * kSegRows;
  *seg_rows = (*tile_rows + segs - 1) / segs;
}

// Ints of dynamic shared memory before the page flags: a warp's row tile
// each, or a thread's column slots each (one phase at a time).
constexpr int kTileInts =
    kWarps * kRowSmem > kSegRows * kThreads ? kWarps * kRowSmem : kSegRows * kThreads;

// (a, pass) stands for the map c -> min(a, pass ? c : big): what a segment does
// to the minimum that enters it from one end (a is the minimum of its run at
// the other end, pass says whether one run spans it). compose(later, earlier).
__device__ __forceinline__ void compose(int& a, bool& pass, int a0, bool pass0, int big) {
  a = min(a, pass ? a0 : big);
  pass = pass && pass0;
}

// Row tiles live in shared memory in the order the lanes read them: lane i
// owns pixels [kRowSeg i, kRowSeg (i + 1)) of the tile, at a stride of
// kRowSeg + 1 words (odd), so both the coalesced writes and the per-lane reads
// are free of bank conflicts.
__device__ __forceinline__ int row_slot(int p) {
  return p / kRowSeg * (kRowSeg + 1) + p % kRowSeg;
}

// Every horizontal run of one row tile (in shared memory, -1 = background)
// takes its minimum, with carry_left / carry_right: the minimum of the run
// entering from the left / right of the tile (big if none). Each lane takes
// the runs of its kRowSeg pixels to their in-segment minimum in registers and
// keeps the segment's summaries (the minimum of the run at its left and right
// end, whether one run spans it); two shuffle scans over the lanes carry them
// left to right and right to left, and each lane rewrites its edge runs. Sets
// *out_right / *out_left to the minimum of the run at the tile's right / left
// edge (big where that pixel is background): the carry into the next tile.
__device__ __forceinline__ void tile_runs(int* s, int lane, int big, int carry_left,
                                          int carry_right, int* out_left,
                                          int* out_right) {
  int v[kRowSeg];
  int* seg = s + lane * (kRowSeg + 1);
#pragma unroll
  for (int k = 0; k < kRowSeg; ++k) v[k] = seg[k];
  int run = big, first_off = kRowSeg, last_off = -1;
#pragma unroll
  for (int k = 0; k < kRowSeg; ++k) {
    if (v[k] < 0) {
      run = big;
      first_off = min(first_off, k);
      last_off = k;
    } else {
      run = min(run, v[k]);
      v[k] = run;
    }
  }
  const int right = run;
  run = big;
#pragma unroll
  for (int k = kRowSeg - 1; k >= 0; --k) {
    if (v[k] < 0) {
      run = big;
    } else {
      run = min(run, v[k]);
      v[k] = run;
    }
  }
  const int left = run;
  const bool full = first_off == kRowSeg;

  // inclusive scans of the segment maps (see compose): ra/rp from the left,
  // la/lp from the right
  int ra = right, la = left;
  bool rp = full, lp = full;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a0 = __shfl_up_sync(kFull, ra, d);
    const bool p0 = __shfl_up_sync(kFull, rp, d);
    const int a1 = __shfl_down_sync(kFull, la, d);
    const bool p1 = __shfl_down_sync(kFull, lp, d);
    if (lane >= d) compose(ra, rp, a0, p0, big);
    if (lane + d < 32) compose(la, lp, a1, p1, big);
  }
  // what enters this lane's segment from the left and from the right
  int from_left = __shfl_up_sync(kFull, ra, 1);
  const bool pass_left = __shfl_up_sync(kFull, rp, 1);
  int from_right = __shfl_down_sync(kFull, la, 1);
  const bool pass_right = __shfl_down_sync(kFull, lp, 1);
  from_left = lane == 0 ? carry_left : min(from_left, pass_left ? carry_left : big);
  from_right = lane == 31 ? carry_right : min(from_right, pass_right ? carry_right : big);
  const int ra31 = __shfl_sync(kFull, ra, 31), la0 = __shfl_sync(kFull, la, 0);
  const bool rp31 = __shfl_sync(kFull, rp, 31), lp0 = __shfl_sync(kFull, lp, 0);
  *out_right = min(ra31, rp31 ? carry_left : big);
  *out_left = min(la0, lp0 ? carry_right : big);

  if (full) {  // one run through the segment: every pixel holds its minimum
    const int m = min(left, min(from_left, from_right));
#pragma unroll
    for (int k = 0; k < kRowSeg; ++k) v[k] = m;
  } else {
    const int l = min(left, from_left), r = min(right, from_right);
#pragma unroll
    for (int k = 0; k < kRowSeg; ++k) {
      if (k < first_off) v[k] = l;
      if (k > last_off) v[k] = r;
    }
  }
#pragma unroll
  for (int k = 0; k < kRowSeg; ++k) seg[k] = v[k];
}

// Gives every horizontal run of one row its minimum. The warp loads the row
// kRowTile pixels at a time (lane i on pixel 32c + i of chunk c: coalesced,
// all at once), transposes the tile through shared memory `s` and runs
// tile_runs on it, then stores the labels that fell, coalesced. A row of up to
// kRowTile pixels is one L2 round trip; a longer one carries the run at each
// tile's right edge into the next tile, then walks back over all but its last
// tile (one more load each) to carry the run at each left edge into the tile
// before. A label is background (-1) or a mask pixel's label (>= 0), so the
// mask is not read. Returns 1 if a label fell.
__device__ int row_runs(int* l, int W, int big, int lane, int* s) {
  const int tiles = (W + kRowTile - 1) / kRowTile;
  int changed = 0;
  int carry = big, carry_back = big;
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0: every tile, left to right; pass 1: tiles - 2 .. 0
    const int count = pass == 0 ? tiles : tiles - 1;
    for (int i = 0; i < count; ++i) {
      const int t = pass == 0 ? i : tiles - 2 - i;
      const int x0 = t * kRowTile;
      int old[kRowSeg];
#pragma unroll
      for (int j = 0; j < kRowSeg; ++j) {
        const int x = x0 + 32 * j + lane;
        old[j] = x < W ? __ldcg(l + x) : -1;
        s[row_slot(32 * j + lane)] = old[j];
      }
      __syncwarp();
      int out_left, out_right;
      if (pass == 0) {
        tile_runs(s, lane, big, carry, big, &out_left, &out_right);
        carry = out_right;
        if (t == tiles - 1) carry_back = out_left;
      } else {
        tile_runs(s, lane, big, big, carry_back, &out_left, &out_right);
        carry_back = out_left;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kRowSeg; ++j) {
        const int x = x0 + 32 * j + lane;
        const int nv = s[row_slot(32 * j + lane)];
        if (x < W && nv != old[j]) {
          l[x] = nv;
          changed = 1;
        }
      }
      __syncwarp();
    }
  }
  return changed;
}

// One tile of a column strip: rows y0 .. y0 + rows - 1 of the strip's columns,
// thread = (column cx, segment of seg_rows rows). Every vertical run takes its
// minimum, with carry_top / carry_bottom: the minimum of the run entering the
// tile from above / below (big if none). A thread loads its segment (the
// warp's lanes of one segment read one row's columns: coalesced) into its own
// slots of shared memory `mine` (slot k at mine[k * kThreads], so a warp's
// accesses are free of bank conflicts), takes its runs to their in-segment
// minimum (down, then up) and keeps the summaries (the minimum of the run at
// its top and bottom, whether one run spans it); segmented Hillis-Steele scans
// over the segments carry them down and up the column, each thread rewrites
// its edge runs, and stores the labels that fell. Sets *out_top / *out_bottom
// to the minimum of the run at the tile's top / bottom (big where that pixel is
// background) and returns 1 if a label fell. Every thread of the block calls
// it (it holds __syncthreads).
__device__ int column_tile(int* l, int W, int y0, int rows, int seg_rows, int strip,
                           bool col, int big, int carry_top, int carry_bottom,
                           int* mine, int* s_down, bool* s_dpass, int* s_up,
                           bool* s_upass, int* out_top, int* out_bottom) {
  const int t = threadIdx.x, segs = kThreads / strip;
  const int seg = t / strip, cx = t % strip;
  const int r0 = min(seg * seg_rows, rows), n = col ? min(r0 + seg_rows, rows) - r0 : 0;
  int* g = l + static_cast<int64_t>(y0 + r0) * W;
#pragma unroll 8
  for (int k = 0; k < n; ++k) mine[k * kThreads] = __ldcg(g + static_cast<int64_t>(k) * W);

  uint64_t fell = 0;  // bit k: slot k was lowered
  int run = big, top_end = n, bot_start = 0;
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const int v = mine[k * kThreads];
    if (v < 0) {
      run = big;
      top_end = min(top_end, k);
      bot_start = k + 1;
    } else if (v <= run) {
      run = v;
    } else {
      mine[k * kThreads] = run;
      fell |= 1ull << k;
    }
  }
  const int bot = run;
  run = big;
#pragma unroll 8
  for (int k = n - 1; k >= 0; --k) {
    const int v = mine[k * kThreads];
    if (v < 0) {
      run = big;
    } else if (v <= run) {
      run = v;
    } else {
      mine[k * kThreads] = run;
      fell |= 1ull << k;
    }
  }
  const int top = run;
  const bool full = n > 0 && top_end == n;

  // inclusive scans of the segment maps (see compose): down from the top
  // segment, up from the bottom one
  int da = bot, ua = top;
  bool dp = full, upp = full;
  for (int d = 1; d < segs; d <<= 1) {
    s_down[t] = da;
    s_dpass[t] = dp;
    s_up[t] = ua;
    s_upass[t] = upp;
    __syncthreads();
    if (seg >= d) compose(da, dp, s_down[t - d * strip], s_dpass[t - d * strip], big);
    if (seg + d < segs) compose(ua, upp, s_up[t + d * strip], s_upass[t + d * strip], big);
    __syncthreads();
  }
  s_down[t] = da;
  s_dpass[t] = dp;
  s_up[t] = ua;
  s_upass[t] = upp;
  __syncthreads();
  const int from_above =
      seg > 0 ? min(s_down[t - strip], s_dpass[t - strip] ? carry_top : big) : carry_top;
  const int from_below = seg + 1 < segs
                             ? min(s_up[t + strip], s_upass[t + strip] ? carry_bottom : big)
                             : carry_bottom;
  const int last = (segs - 1) * strip + cx;
  *out_bottom = min(s_down[last], s_dpass[last] ? carry_top : big);
  *out_top = min(s_up[cx], s_upass[cx] ? carry_bottom : big);

  if (full) {  // one run through the segment: every pixel holds its minimum
    const int m = min(top, min(from_above, from_below));
    if (m < top)
      for (int k = 0; k < n; ++k) {
        mine[k * kThreads] = m;
        fell |= 1ull << k;
      }
  } else {
    if (top != big && from_above < top)
      for (int k = 0; k < top_end; ++k) {
        mine[k * kThreads] = from_above;
        fell |= 1ull << k;
      }
    if (bot != big && from_below < bot)
      for (int k = bot_start; k < n; ++k) {
        mine[k * kThreads] = from_below;
        fell |= 1ull << k;
      }
  }
  for (int k = 0; k < n; ++k)
    if (fell >> k & 1ull) g[static_cast<int64_t>(k) * W] = mine[k * kThreads];
  return fell != 0;
}

// dynamic shared memory: the row tiles or the column slots (one phase at a
// time), then B ints (pages active this sweep) and B ints (pages this block
// changed this sweep)
__global__ void __launch_bounds__(kThreads, 2) ccl_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_down[kThreads], s_up[kThreads];
  __shared__ bool s_dpass[kThreads], s_upass[kThreads];
  extern __shared__ int s_dyn[];
  int* s_active = s_dyn + kTileInts;
  int* s_dirty = s_active + p.B;

  const int B = p.B, H = p.H, W = p.W;
  const int64_t n = static_cast<int64_t>(H) * W;
  const int big = H * W;
  int* sweeps = p.scratch;
  int* flags = p.scratch + flag_offset(B);  // flag of page b in buffer k: (k * B + b) * kFlagStride
  const int lane = threadIdx.x & 31;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;

  // the mask (and the seeds) are read here only: from now on a label < 0 is
  // background
  for (int b = 0; b < B; ++b)
    for (int64_t i = tid; i < n; i += nthreads) {
      const int own = static_cast<int>(i);
      p.labels[b * n + i] = !__ldg(p.mask + b * n + i) ? -1
                            : p.seed ? min(own, __ldg(p.seed + b * n + i))
                                     : own;
    }
  for (int64_t i = tid; i < flag_offset(B) + 2 * B * kFlagStride; i += nthreads)
    p.scratch[i] = 0;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    s_active[b] = 1;
    s_dirty[b] = 0;
  }
  grid.sync();

  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  int* s_row = s_dyn + (threadIdx.x >> 5) * kRowSmem;

  for (int it = 0;; ++it) {
    int* cur = flags + static_cast<int64_t>(it & 1) * B * kFlagStride;
    int* other = flags + static_cast<int64_t>(~it & 1) * B * kFlagStride;
    if (blockIdx.x == 0)
      for (int b = threadIdx.x; b < B; b += kThreads) sweeps[b] += s_active[b];
    // narrower strips as pages converge (the same choice in every block)
    int active = 0;
    for (int b = 0; b < B; ++b) active += s_active[b];
    const int strip = strip_for(active, H, W, p.sms);
    const int strips = (W + strip - 1) / strip;
    int tile_rows, seg_rows;
    column_shape(strip, H, &tile_rows, &seg_rows);
    const int tiles = (H + tile_rows - 1) / tile_rows;

    // row phase: R
    for (int item = gwarp; item < B * H; item += nwarps) {
      const int b = item / H;
      if (!s_active[b]) continue;  // converged page
      const int changed =
          row_runs(p.labels + static_cast<int64_t>(item) * W, W, big, lane, s_row);
      if (__any_sync(kFull, changed) && lane == 0) s_dirty[b] = 1;
    }
    grid.sync();

    // `other` was read after the previous sweep's last barrier, which every
    // block has passed: clear it for the next sweep
    if (blockIdx.x == 0)
      for (int b = threadIdx.x; b < B; b += kThreads) other[b * kFlagStride] = 0;

    // column phase: C. A tall strip runs in row tiles: down over all of them,
    // carrying the run at each bottom edge, then back up over all but the last,
    // carrying the run at each top edge.
    for (int item = blockIdx.x; item < B * strips; item += gridDim.x) {
      const int b = item / strips;
      if (!s_active[b]) continue;  // uniform across the block
      const int x = (item % strips) * strip + threadIdx.x % strip;
      int* l = p.labels + b * n + x;
      int changed = 0, carry = big, carry_back = big;
      for (int pass = 0; pass < 2; ++pass) {
        const int count = pass == 0 ? tiles : tiles - 1;
        for (int i = 0; i < count; ++i) {
          const int t = pass == 0 ? i : tiles - 2 - i;
          const int y0 = t * tile_rows;
          int out_top, out_bottom;
          changed |= column_tile(l, W, y0, min(tile_rows, H - y0), seg_rows, strip,
                                 x < W, big, pass == 0 ? carry : big,
                                 pass == 0 ? big : carry_back, s_dyn + threadIdx.x, s_down,
                                 s_dpass, s_up, s_upass, &out_top, &out_bottom);
          if (pass == 0) {
            carry = out_bottom;
            if (t == tiles - 1) carry_back = out_top;
          } else {
            carry_back = out_top;
          }
          __syncthreads();  // before the next tile reuses the scans' arrays
        }
      }
      if (__syncthreads_or(changed) && threadIdx.x == 0) s_dirty[b] = 1;
    }

    // one store per page this block changed: flags on separate L2 lines, so
    // blocks changing different pages do not queue on one line
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += kThreads)
      if (s_dirty[b]) {
        cur[b * kFlagStride] = 1;
        s_dirty[b] = 0;
      }
    grid.sync();
    int any = 0;
    for (int b = threadIdx.x; b < B; b += kThreads) {
      s_active[b] = __ldcg(cur + b * kFlagStride);
      any |= s_active[b];
    }
    // every block reads the same flags, so the exit is uniform across the grid
    if (!__syncthreads_or(any) || it + 1 >= p.max_iters) break;
  }
}

struct Config {
  int grid, per_sm, sms;
  size_t smem;
};

cudaError_t launch_config(int B, int H, int W, Config* c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  c->smem = sizeof(int) * (kTileInts + 2 * static_cast<size_t>(B));
  err = cudaFuncSetAttribute(ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(c->smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c->per_sm, ccl_kernel, kThreads,
                                                      c->smem);
  if (err != cudaSuccess) return err;
  const int strip = strip_for(B, H, W, c->sms);
  const int64_t rows = (static_cast<int64_t>(B) * H + kWarps - 1) / kWarps;
  const int64_t strips = static_cast<int64_t>(B) * ((W + strip - 1) / strip);
  const int64_t useful = rows > strips ? rows : strips;
  const int64_t resident = static_cast<int64_t>(c->per_sm) * c->sms;
  c->grid = static_cast<int>(useful < resident ? useful : resident);
  return cudaSuccess;
}

}  // namespace

// The launch mr_ccl_launch makes for a (B, H, W) mask on the current device:
// out = {grid blocks, co-resident blocks per SM, SMs, strip width of the
// first sweep}.
extern "C" int mr_ccl_config(int B, int H, int W, int* out) {
  Config c{};
  const cudaError_t err = launch_config(B, H, W, &c);
  out[0] = c.grid;
  out[1] = c.per_sm;
  out[2] = c.sms;
  out[3] = strip_for(B, H, W, c.sms);
  return static_cast<int>(err);
}

// int32s of scratch the launch needs for B pages: the sweep counts, then the
// changed flags; the kernel initialises them.
extern "C" int64_t mr_ccl_scratch_size(int B) {
  return flag_offset(B) + 2 * static_cast<int64_t>(B) * kFlagStride;
}

// scratch: mr_ccl_scratch_size(B) int32s; its first B hold each page's sweeps.
// seed: nullptr (every mask pixel starts with its own index) or (B, H, W)
// int32 start labels, each mask pixel starting with min(own index, seed).
extern "C" int mr_ccl_launch(const void* mask, const void* seed, void* labels,
                             void* scratch, int B, int H, int W, int max_iters,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  Config c{};
  cudaError_t err = launch_config(B, H, W, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Params p{static_cast<const uint8_t*>(mask), static_cast<const int*>(seed),
           static_cast<int*>(labels), static_cast<int*>(scratch), B, H, W, max_iters,
           c.sms};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ccl_kernel),
                                    dim3(c.grid), dim3(kThreads), args, c.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
