// 4-connected component labelling of binary page masks, one thread block per page.
//
// Replaces the TPU kernel megreader_tpu/ops/pallas_ccl.py::_ccl_kernel (entry
// connected_components_pallas). Contract, shared with the plain PyTorch version
// megreader_tpu_torch/ops/ccl.py::connected_components_reference and with the JAX
// XLA solve (megreader_tpu/ops/ccl.py::_ccl_single):
//   * input  (B, H, W) uint8 mask, output (B, H, W) int32 labels;
//   * a pixel's label is the minimum own linear index y*W+x over its 4-connected
//     component, background is -1;
//   * one sweep = row forward + row backward + column forward + column backward
//     segmented running min (a background pixel resets the run). Sweeps repeat
//     until one changes nothing or max_iters sweeps ran (at least one sweep), so
//     labels under the cap are bit-identical to the reference on serpentine masks.
//     A union-find solve would converge in one launch but would not reproduce the
//     capped state, which is why this kernel keeps the sweep structure.
//
// Design: the labels live in the output tensor (1.6 MB per 640x640 page, resident
// in the 50 MB L2). Each thread owns whole rows, then whole columns, and runs the
// sequential forward and backward running min along them: the same values the TPU
// kernel gets from its Hillis-Steele scans. __syncthreads separates the row and
// column phases (a block's global writes are visible to the block after it), and
// __syncthreads_or carries the changed flag, so the whole capped solve is one
// launch with no host synchronisation between sweeps.
//
// Bound: each sweep does a min/compare and a select per pixel in each of its 4
// passes, INT32 work at 132 SMs x 64 lanes x 1.98 GHz = 16.7 T/s: 1.6 us per
// sweep of 8 pages at 640^2. The function reads the mask once and writes the
// labels once, 5 bytes a pixel: 16.4 MB, 4.9 us at 3.35 TB/s, so past 3 sweeps
// the operations set the bound. This multi-pass design moves
// 8 pages x 640^2 x 4 B x 8 passes = 105 MB through L2 per sweep (31 us at the HBM
// rate, were it not L2-resident). The scans are latency-bound: each thread walks
// its line serially, so loads are batched kChunk at a time. Known costs, left for
// a later change: with grid = B the kernel uses 8 of the 132 SMs at B = 8, and the
// row phase is uncoalesced (neighbouring threads read addresses W ints apart; the
// column phase is coalesced).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 8;  // pixels loaded ahead of each scan step

// Segmented running min over one line of n pixels spaced `stride` apart, in
// the direction `dir` (+1 forward, -1 backward), carrying the run's minimum
// in `cur`. A line is read kChunk pixels at a time into registers before
// they are scanned, so kChunk loads are in flight instead of one: the
// compiler cannot move a load past the previous pixel's store by itself.
// Returns 1 if any label on the line decreased.
__device__ __forceinline__ int scan_dir(const uint8_t* __restrict__ m,
                                        int* __restrict__ l, int n, int stride,
                                        int dir, int big) {
  int changed = 0;
  int cur = big;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    int v[kChunk];
    bool on[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i0 + j;
      const int64_t o = static_cast<int64_t>(dir > 0 ? i : n - 1 - i) * stride;
      on[j] = i < n && m[o];
      v[j] = on[j] ? l[o] : big;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i0 + j;
      if (!on[j]) {
        cur = big;
      } else if (v[j] <= cur) {
        cur = v[j];
      } else {
        l[static_cast<int64_t>(dir > 0 ? i : n - 1 - i) * stride] = cur;
        changed = 1;
      }
    }
  }
  return changed;
}

// Forward then backward segmented running min along one line.
__device__ __forceinline__ int scan_line(const uint8_t* __restrict__ m,
                                         int* __restrict__ l, int n, int stride,
                                         int big) {
  const int fwd = scan_dir(m, l, n, stride, 1, big);
  return fwd | scan_dir(m, l, n, stride, -1, big);
}

__global__ void __launch_bounds__(kThreads)
    ccl_kernel(const uint8_t* __restrict__ mask, int* __restrict__ labels, int H,
               int W, int max_iters) {
  const int64_t n = static_cast<int64_t>(H) * W;
  const uint8_t* m = mask + blockIdx.x * n;
  int* l = labels + blockIdx.x * n;
  const int big = H * W;

  // Background is never read by a scan (it only resets the run), so it can hold
  // its final value -1 from the start.
  for (int i = threadIdx.x; i < n; i += blockDim.x) l[i] = m[i] ? i : -1;
  __syncthreads();

  int changed = 1;
  for (int it = 0; changed && (it == 0 || it < max_iters); ++it) {
    int local = 0;
    for (int y = threadIdx.x; y < H; y += blockDim.x)
      local |= scan_line(m + static_cast<int64_t>(y) * W,
                         l + static_cast<int64_t>(y) * W, W, 1, big);
    __syncthreads();
    for (int x = threadIdx.x; x < W; x += blockDim.x)
      local |= scan_line(m + x, l + x, H, W, big);
    changed = __syncthreads_or(local);
  }
}

}  // namespace

extern "C" int mr_ccl_launch(const void* mask, void* labels, int B, int H, int W,
                             int max_iters, void* stream) {
  if (B > 0 && H > 0 && W > 0)
    ccl_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mask), static_cast<int*>(labels), H, W,
        max_iters);
  return static_cast<int>(cudaGetLastError());
}
