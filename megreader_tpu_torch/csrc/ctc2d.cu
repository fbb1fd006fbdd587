// 2D-CTC loss with a Markov height chain on the card: the log-space alpha
// recursion over (height, extended label state) (forward) and the beta
// recursion with the gradients with respect to the emissions, the
// transitions and the initial heights (backward).
//
// Replaces the TPU kernels megreader_tpu/ops/pallas_ctc2d.py::
// _ctc2d_alpha_kernel (pallas_call at :205) and ::_ctc2d_beta_kernel
// (pallas_call at :224). The semantics are those of the plain version
// (ops/ctc2d.py::ctc2d_nll_markov_reference, a port of the XLA scan
// megreader_tpu/ops/ctc2d.py::ctc2d_loss_markov), not the Pallas kernels':
// S = 2L+1 extended states, NEG_INF = -1e30 as the sentinel, the label move's
// logsumexp gives NEG_INF where its maximum lies at or below NEG_INF/2, the
// height contraction and the final height marginalization are plain
// logsumexps, states at or beyond 2*label_length+1 hold NEG_INF, alpha is
// frozen from t >= logit_length on (a length below 1 counts as 1, above T as
// T), trans[:, 0] is never used, and
// nll = -logaddexp(lse_h alpha[T-1, h, 2L], lse_h alpha[T-1, h, 2L-1]).
// A row with no alignment has a finite loss of about 1e30; the beta kernel
// gives it the XLA scan's gradient (see there).
//
// What bounds it on an H100. At config #2's training shape (B 64, T 25, H 4,
// C 37, labels padded to L 32, so S = 65) the forward pass moves about
// 2.7 MB and the backward pass about 3.8 MB: about a microsecond each at
// 3.35 TB/s, and the arithmetic is smaller still. What sets the time is the
// chain of T dependent steps, each a label move, a contraction over H heights
// and an emission, at the latency of one SM.
//
// The design's answer: the chain runs in warps with no block barrier on it.
// A row's live states 0 .. 2*label_length lie in ceil((2*label_length+1)/32)
// columns of 32 states; warp k holds column k, lane j the state s = 32k + j at
// every height (H floats in registers). A step's label move reads s-1 and s-2
// by warp shuffles and its contraction over the H previous heights runs in
// registers, with A_t and the emissions read from shared memory, where the
// sequence's (T, H, C) emission slab and (T, H, H) transition slab are staged
// by cp.async at the start; the alpha planes gather there too and leave in
// one coalesced pass at the end. The step has no jump: its logsumexps select
// their sentinel, and exp and log are the fast ones (see fexp), so the H
// heights of a lane interleave. A row longer than one column spreads over more
// warps: the label move only looks down the states (alpha) or up them (beta),
// so warp k needs, of its neighbour, two boundary states of the previous step
// and never the reverse. The neighbour publishes them to shared memory with a
// step counter (release by a block fence; the reader spins on the counter),
// and the warps run as a pipeline one step apart. Most words need one warp.
//
// The beta kernel keeps only the mirrored recursion on its chain (phase A)
// and stores every beta plane in shared memory, while the sequence's alpha
// slab arrives by cp.async. After one block barrier, phase B computes every
// gradient with no serial dependency, 16 warps over the steps: the occupancy
// exp(alpha + beta - logZ) of each (t, h, s), summed per class in a fixed
// order (the even states' blank by a shuffle tree; each label class along a
// list of its positions built while phase A runs), and the transition terms
// xi[h', h] = sum_s exp(lblmove(alpha[t-1])[h', s] + A_t[h', h]
//                       + emit[t, h, s] + beta[t, h, s] - logZ)
// by shuffle trees, so two launches on the same inputs give the same bits.
// The (H, C) and (H, H) rows and the initial heights' gradient (the column-0
// emission gradient summed over classes) are stored by consecutive lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Per-step timestamps for scripts/ctc2d_probe.py, which defines these in its
// copy of this file; nothing here otherwise.
#ifndef CTC2D_STAMP
#define CTC2D_STAMP(id)
#define CTC2D_STAMP_INIT
#endif

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_H = 8;           // heights: one kernel instance each
constexpr int MAX_COLS = 4;        // columns of 32 states: S = 2L+1 <= 128
constexpr int ALPHA_THREADS = 32 * MAX_COLS;
constexpr int BETA_WARPS = 16;     // phase B; phase A takes the first columns' warps

// The chain and the gradient pass use the fast exp and log (ex2.approx and
// lg2.approx, flushing results below 2^-126 to zero, with no range fix-ups):
// branch-free, and their arguments here are a difference from a maximum
// (exp) or a sum of such exps between 1 and a few (log), where they lose
// under 1e-6 relative; phase ctc2d of chip_smoke.py holds the results at
// the plain version's tolerances.
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float flog(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.6931471805599453f;
}

// keep ? x : NEG_INF by bit masks, so that the compiler cannot turn the
// choice into a jump around the work that computes x (keep is all ones or
// all zeros).
__device__ __forceinline__ float keep_or_neg_inf(float x, unsigned keep) {
  return __uint_as_float((__float_as_uint(x) & keep) | (__float_as_uint(NEG_INF) & ~keep));
}

// Branch-free (a select, not a jump), so that the unrolled heights of a
// step interleave; with every input at NEG_INF the sum is 3 and the select
// takes NEG_INF.
__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float r = m + flog(fexp(a - m) + fexp(b - m) + fexp(c - m));
  return m <= HALF_NEG_INF ? NEG_INF : r;
}

__device__ __forceinline__ int round4d(int n) { return (n + 3) & ~3; }

// Copy n 4-byte words from device memory to shared memory with cp.async,
// 16 bytes at a time where both ends allow it; completes at the next
// cp_async_wait of the group committed after it.
__device__ __forceinline__ void stage(void* dst, const void* src, int n, int tid, int nthreads) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  const bool wide = ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  const int n16 = wide ? n / 4 : 0;
  for (int i = tid; i < n16; i += nthreads) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(s + 16 * i) : "memory");
  }
  for (int i = 4 * n16 + tid; i < n; i += nthreads) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d + 4 * i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(a), "l"(s + 4 * i) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Publish a warp's step counter after its boundary states (lane 0, after a
// __syncwarp), and wait for a neighbour's (every lane).
__device__ __forceinline__ void publish(int* counter, int value) {
  __threadfence_block();
  *reinterpret_cast<volatile int*>(counter) = value;
}

__device__ __forceinline__ void wait_for(const int* counter, int value) {
  while (*reinterpret_cast<const volatile int*>(counter) < value) {
  }
  __syncwarp();
  __threadfence_block();
}

// One extended state s of a sequence.
struct State {
  int cls;     // class emitted in this state (clamped into [0, C))
  bool valid;  // s < 2 * label_length + 1
  bool skip;   // the s-2 -> s transition is allowed
  bool bad;    // a label inside label_length lies outside [0, C)
};

__device__ __forceinline__ State make_state(const int* lab, int s, int S, int lab_len, int C,
                                            int blank) {
  State st;
  const bool in_range = s < S;
  const int c = (in_range && (s & 1)) ? lab[s >> 1] : blank;
  const int c2 = (in_range && s >= 2) ? ((s & 1) ? lab[(s >> 1) - 1] : blank) : -1;
  st.valid = s < 2 * lab_len + 1;
  st.skip = in_range && c != blank && c != c2;
  st.bad = st.valid && (c < 0 || c >= C);
  st.cls = min(max(c, 0), C - 1);
  return st;
}

// Live columns of 32 states of a row with lab_len labels.
__device__ __forceinline__ int live_columns(int lab_len) { return (2 * lab_len + 1 + 31) >> 5; }

// Shared memory, in floats, each part from a multiple of 16 bytes.
struct AlphaSmem {
  int emit, trans, alpha, bnd, counters, fin, total;
  __host__ __device__ AlphaSmem(int T, int H, int C, int L) {
    emit = 0;
    trans = emit + ((T * H * C + 3) & ~3);
    alpha = trans + ((T * H * H + 3) & ~3);
    bnd = alpha + ((T * H * (2 * L + 1) + 3) & ~3);
    counters = bnd + MAX_COLS * T * H * 2;
    fin = counters + MAX_COLS;
    total = fin + 4;
  }
};

struct BetaSmem {
  int emit, trans, alpha, beta, labels, next, first, bnd, counters, rows, tiles, total;
  __host__ __device__ BetaSmem(int T, int H, int C, int L) {
    const int S = 2 * L + 1;
    emit = 0;
    trans = emit + ((T * H * C + 3) & ~3);
    alpha = trans + ((T * H * H + 3) & ~3);
    beta = alpha + ((T * H * S + 3) & ~3);
    labels = beta + ((T * H * S + 3) & ~3);
    next = labels + ((L + 3) & ~3);
    first = next + ((L + 3) & ~3);
    bnd = first + ((C + 3) & ~3);
    counters = bnd + MAX_COLS * T * H * 2;
    rows = counters + MAX_COLS;
    tiles = rows + BETA_WARPS * H * ((S + 3) & ~3);
    total = tiles + BETA_WARPS * ((H * H + 3) & ~3);
  }
};

// emit (B, T, H, C); trans (B, T, H, H) with rows h_prev; init (B, H);
// labels (B, L); alpha out (B, T, H, S); nll out (B,).
// Block: 4 warps, warp k the states 32k .. 32k+31 of sequence blockIdx.x.
template <int H>
__global__ void __launch_bounds__(ALPHA_THREADS)
    ctc2d_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ trans,
                       const float* __restrict__ init, const int* __restrict__ logit_lengths,
                       const int* __restrict__ labels, const int* __restrict__ label_lengths,
                       int T, int C, int L, int blank, float* __restrict__ alpha,
                       float* __restrict__ nll) {
  extern __shared__ __align__(16) float smem[];
  CTC2D_STAMP_INIT
  constexpr int HH = H * H;
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int k = tid >> 5;
  const int j = tid & 31;
  const int s = 32 * k + j;
  const AlphaSmem lay(T, H, C, L);
  float* es = smem + lay.emit;     // [t][h][c]
  float* as = smem + lay.trans;    // [t][h_prev][h]
  float* ap = smem + lay.alpha;    // [t][h][s], stored to device memory at the end
  float* bnd = smem + lay.bnd;     // [column][t][h][2]: alpha of lanes 30, 31
  int* done = reinterpret_cast<int*>(smem + lay.counters);  // last step published
  float* fin = smem + lay.fin;     // the two terminal states' height marginals

  stage(es, emit + (size_t)b * T * H * C, T * H * C, tid, ALPHA_THREADS);
  stage(as, trans + (size_t)b * T * HH, T * HH, tid, ALPHA_THREADS);
  cp_async_commit();
  const int* lab = labels + (size_t)b * L;
  const int raw_lab_len = label_lengths[b];
  const int lab_len = min(max(raw_lab_len, 0), L);
  const int len = min(max(logit_lengths[b], 1), T);
  const int K = live_columns(lab_len);
  const State st = make_state(lab, s, S, lab_len, C, blank);
  const bool any_bad =
      __syncthreads_or(st.bad || (tid == 0 && (raw_lab_len < 0 || raw_lab_len > L)));
  if (tid < MAX_COLS) done[tid] = -1;
  if (k >= K) {  // a column past the row's states: NEG_INF at every step
    if (s < S)
      for (int i = 0; i < T * H; ++i) ap[i * S + s] = NEG_INF;
  }
  cp_async_wait<0>();
  __syncthreads();  // slabs and counters ready (the one barrier before the chain)

  float a[H];
  const unsigned keep = st.valid ? 0xffffffffu : 0u;
  if (k < K) {
    const bool start = st.valid && (s == 0 || (s == 1 && lab_len > 0));
#pragma unroll
    for (int h = 0; h < H; ++h) {
      a[h] = start ? init[(size_t)b * H + h] + es[h * C + st.cls] : NEG_INF;
      if (s < S) ap[h * S + s] = a[h];
    }
    const bool feeds = k + 1 < K;  // the next column reads lanes 30 and 31
    if (feeds) {
      if (j >= 30)
#pragma unroll
        for (int h = 0; h < H; ++h) bnd[((k * T) * H + h) * 2 + j - 30] = a[h];
      __syncwarp();
      if (j == 0) publish(done + k, 0);
    }
    for (int t = 1; t < len; ++t) {
      CTC2D_STAMP(1)
      const float* At = as + t * HH;
      const float* et = es + t * H * C;
      float p1[H], p2[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        p1[h] = __shfl_sync(FULL, a[h], (j + 31) & 31);
        p2[h] = __shfl_sync(FULL, a[h], (j + 30) & 31);
      }
      if (k > 0) {  // s-1 and s-2 of lanes 0 and 1 lie in the previous column
        wait_for(done + k - 1, t - 1);
        const float* nb = bnd + ((k - 1) * T + t - 1) * H * 2;
        if (j < 2) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            p2[h] = nb[h * 2 + j];
            if (j == 0) p1[h] = nb[h * 2 + 1];
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (j < 1) p1[h] = NEG_INF;
          if (j < 2) p2[h] = NEG_INF;
        }
      }
      float lbl[H];
#pragma unroll
      for (int h = 0; h < H; ++h) lbl[h] = logsumexp3(a[h], p1[h], st.skip ? p2[h] : NEG_INF);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float m = lbl[0] + At[h];
#pragma unroll
        for (int hp = 1; hp < H; ++hp) m = fmaxf(m, lbl[hp] + At[hp * H + h]);
        float sum = 0.f;
#pragma unroll
        for (int hp = 0; hp < H; ++hp) sum += fexp(lbl[hp] + At[hp * H + h] - m);
        a[h] = keep_or_neg_inf((flog(sum) + m) + et[h * C + st.cls], keep);
      }
      if (feeds) {
        if (j >= 30)
#pragma unroll
          for (int h = 0; h < H; ++h) bnd[((k * T + t) * H + h) * 2 + j - 30] = a[h];
        __syncwarp();
        if (j == 0) publish(done + k, t);
      }
      if (s < S)
#pragma unroll
        for (int h = 0; h < H; ++h) ap[(t * H + h) * S + s] = a[h];
    }
    if (s < S) {  // frozen past the row's length
      for (int t = len; t < T; ++t)
#pragma unroll
        for (int h = 0; h < H; ++h) ap[(t * H + h) * S + s] = a[h];
    }
    CTC2D_STAMP(9)
    // height marginals of the two terminal states
    const int s_last = 2 * lab_len;
    if (s == s_last || (lab_len > 0 && s == s_last - 1)) {
      float m = a[0];
#pragma unroll
      for (int h = 1; h < H; ++h) m = fmaxf(m, a[h]);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) sum += expf(a[h] - m);
      fin[s == s_last ? 0 : 1] = logf(sum) + m;
    }
  }
  __syncthreads();
  float* out = alpha + (size_t)b * T * H * S;  // the alpha planes, coalesced
  const int n = T * H * S;
  if (((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ap)) & 15) == 0) {
    for (int i = tid; i < n / 4; i += ALPHA_THREADS)
      reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(ap)[i];
    for (int i = 4 * (n / 4) + tid; i < n; i += ALPHA_THREADS) out[i] = ap[i];
  } else {
    for (int i = tid; i < n; i += ALPHA_THREADS) out[i] = ap[i];
  }
  if (tid == 0) {
    const float a_last = fin[0];
    const float a_prev = lab_len > 0 ? fin[1] : NEG_INF;
    const float m = fmaxf(a_last, a_prev);
    const float ll = m + logf(expf(a_last - m) + expf(a_prev - m));
    nll[b] = any_bad ? nanf("") : -ll;
  }
}

// grad_emit out (B, T, H, C) = d(grad_nll . nll) / d emit,
// grad_trans out (B, T, H, H) = d(grad_nll . nll) / d trans,
// grad_init out (B, H) = d(grad_nll . nll) / d init.
// Block: 16 warps; in phase A warp k runs the column of states 32k ..
// 32k+31, in phase B warp w the steps t = w, w + 16, ...
template <int H>
__global__ void __launch_bounds__(32 * BETA_WARPS)
    ctc2d_beta_kernel(const float* __restrict__ emit, const float* __restrict__ trans,
                      const int* __restrict__ logit_lengths, const int* __restrict__ labels,
                      const int* __restrict__ label_lengths, int T, int C, int L, int blank,
                      const float* __restrict__ alpha, const float* __restrict__ nll,
                      const float* __restrict__ grad_nll, float* __restrict__ grad_emit,
                      float* __restrict__ grad_trans, float* __restrict__ grad_init) {
  extern __shared__ __align__(16) float smem[];
  CTC2D_STAMP_INIT
  constexpr int HH = H * H;
  constexpr int NT = 32 * BETA_WARPS;
  const int S = 2 * L + 1;
  const int HC = H * C;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int j = tid & 31;
  float* ge = grad_emit + (size_t)b * T * HC;
  float* gt = grad_trans + (size_t)b * T * HH;
  float* gi = grad_init + (size_t)b * H;
  const int* lab = labels + (size_t)b * L;
  const int lab_len = min(max(label_lengths[b], 0), L);
  const int t_last = min(max(logit_lengths[b], 1), T) - 1;
  const float logz = -nll[b];
  const float g = grad_nll[b];

  // frozen steps carry no gradient; trans[:, 0] is never used
  for (int i = tid; i < (T - 1 - t_last) * HC; i += NT) ge[(size_t)(t_last + 1) * HC + i] = 0.f;
  for (int i = tid; i < (T - 1 - t_last) * HH; i += NT) gt[(size_t)(t_last + 1) * HH + i] = 0.f;
  for (int i = tid; i < HH; i += NT) gt[i] = 0.f;

  if (!(logz > HALF_NEG_INF)) {
    // No alignment: the XLA scan's sentinel arithmetic gives each terminal
    // state -1/2 of the row's gradient at the last step, spread evenly over
    // the H heights (-1/(2H) on each height's emission of the state's class)
    // and then over the H previous heights (-1/(2H^2) on each transition);
    // nothing at t = 0, where the terminal states are constants. A row with
    // a bad label (NaN loss) gets a NaN gradient.
    const float gg = isnan(logz) ? logz : g;
    const int c_prev = lab_len > 0 ? lab[lab_len - 1] : -1;
    const float wt = 0.5f / H;
    for (int t = 0; t <= t_last; ++t) {
      for (int i = tid; i < HC; i += NT) {
        const int c = i % C;
        float v = 0.f;
        if (t == t_last && t > 0) {
          if (c == blank) v -= wt;
          if (c == c_prev) v -= wt;
        }
        ge[(size_t)t * HC + i] = v * gg;
      }
      if (t > 0) {
        const float v = t == t_last ? -(lab_len > 0 ? 2.f : 1.f) * wt / H : 0.f;
        for (int i = tid; i < HH; i += NT) gt[(size_t)t * HH + i] = v * gg;
      }
    }
    if (tid < H) gi[tid] = 0.f * gg;  // the column-0 row above, summed over classes
    return;
  }

  const BetaSmem lay(T, H, C, L);
  float* es = smem + lay.emit;    // [t][h][c]
  float* as = smem + lay.trans;   // [t][h_prev][h]
  float* al = smem + lay.alpha;   // [t][h][s]
  float* bt = smem + lay.beta;    // [t][h][s]
  int* ls = reinterpret_cast<int*>(smem + lay.labels);
  int* next = reinterpret_cast<int*>(smem + lay.next);    // next position of the same class
  int* first = reinterpret_cast<int*>(smem + lay.first);  // first position of a class, or -1
  float* bnd = smem + lay.bnd;    // [column][t][h][2]: beta + emit of lanes 0, 1
  int* done = reinterpret_cast<int*>(smem + lay.counters);  // steps published
  stage(es, emit + (size_t)b * T * HC, T * HC, tid, NT);
  stage(as, trans + (size_t)b * T * HH, T * HH, tid, NT);
  stage(ls, lab, L, tid, NT);
  cp_async_commit();
  stage(al, alpha + (size_t)b * T * H * S, T * H * S, tid, NT);  // lands during phase A
  cp_async_commit();
  if (tid < MAX_COLS) done[tid] = 0;
  cp_async_wait<1>();
  __syncthreads();

  const int K = live_columns(lab_len);
  if (w < K) {
    // Phase A: beta[t-1][h][s] = lse over h'' of mv[h''][s] + A_t[h][h''],
    // mv the backward label move of nx = beta[t] + emit[t] on valid states
    const int s = 32 * w + j;
    const State st = make_state(ls, s, S, lab_len, C, blank);
    const bool skip2 = make_state(ls, s + 2, S, lab_len, C, blank).skip;
    const bool terminal = s == 2 * lab_len || (lab_len > 0 && s == 2 * lab_len - 1);
    const bool feeds = w > 0;  // the previous column reads lanes 0 and 1
    float be[H];
#pragma unroll
    for (int h = 0; h < H; ++h) be[h] = terminal ? 0.f : NEG_INF;
    for (int t = t_last; t >= 1; --t) {
      CTC2D_STAMP(1)
      const float* At = as + t * HH;
      const float* et = es + t * HC;
      float nx[H], d1[H], d2[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (s < S) bt[(t * H + h) * S + s] = be[h];
        nx[h] = st.valid ? be[h] + et[h * C + st.cls] : NEG_INF;
      }
      if (feeds) {
        if (j < 2)
#pragma unroll
          for (int h = 0; h < H; ++h) bnd[((w * T + t) * H + h) * 2 + j] = nx[h];
        __syncwarp();
        if (j == 0) publish(done + w, t_last - t + 1);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        d1[h] = __shfl_sync(FULL, nx[h], (j + 1) & 31);
        d2[h] = __shfl_sync(FULL, nx[h], (j + 2) & 31);
      }
      if (w + 1 < K) {  // s+1 and s+2 of lanes 30 and 31 lie in the next column
        wait_for(done + w + 1, t_last - t + 1);
        const float* nb = bnd + ((w + 1) * T + t) * H * 2;
        if (j >= 30) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            d2[h] = nb[h * 2 + j - 30];
            if (j == 31) d1[h] = nb[h * 2];
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (j == 31) d1[h] = NEG_INF;
          if (j >= 30) d2[h] = NEG_INF;
        }
      }
      float mv[H];
#pragma unroll
      for (int h = 0; h < H; ++h) mv[h] = logsumexp3(nx[h], d1[h], skip2 ? d2[h] : NEG_INF);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float m = mv[0] + At[h * H];
#pragma unroll
        for (int hn = 1; hn < H; ++hn) m = fmaxf(m, mv[hn] + At[h * H + hn]);
        float sum = 0.f;
#pragma unroll
        for (int hn = 0; hn < H; ++hn) sum += fexp(mv[hn] + At[h * H + hn] - m);
        const float r = m + flog(sum);
        be[h] = m <= HALF_NEG_INF ? NEG_INF : r;
      }
    }
    if (s < S)
#pragma unroll
      for (int h = 0; h < H; ++h) bt[h * S + s] = be[h];
    CTC2D_STAMP(3)
  } else if (w == BETA_WARPS - 1) {
    // while phase A runs: each label class's positions as a list, in order
    for (int c = j; c < C; c += 32) first[c] = -1;
    __syncwarp();
    for (int i = j; i < lab_len; i += 32) {
      const int c = ls[i];
      int later = -1;
      for (int i2 = i + 1; i2 < lab_len && later < 0; ++i2)
        if (ls[i2] == c) later = i2;
      next[i] = later;
      bool is_first = c >= 0 && c < C;
      for (int i2 = 0; i2 < i && is_first; ++i2) is_first = ls[i2] != c;
      if (is_first) first[c] = i;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // beta planes, the alpha slab and the class lists complete
  CTC2D_STAMP(4)

  // Phase B: every step's gradients at once, warp w the steps w, w + 16, ...
  const int Sb = 2 * lab_len + 1;
  const int RS = round4d(S);
  float* rows = smem + lay.rows + w * H * RS;        // occupancies of the odd states
  float* tile = smem + lay.tiles + w * round4d(HH);  // xi of one step
  for (int t = w; t <= t_last; t += BETA_WARPS) {
    const float* at = al + t * H * S;
    const float* bp = bt + t * H * S;
    const float* et = es + t * HC;
    // the (H, C) emission row: every height at once
    float blank_part[H];
#pragma unroll
    for (int h = 0; h < H; ++h) blank_part[h] = 0.f;
    for (int s = j; s < Sb; s += 32) {
      float o[H];
#pragma unroll
      for (int h = 0; h < H; ++h) o[h] = fexp(at[h * S + s] + bp[h * S + s] - logz);
      if (s & 1) {
#pragma unroll
        for (int h = 0; h < H; ++h) rows[h * RS + s] = o[h];
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) blank_part[h] += o[h];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int h = 0; h < H; ++h) blank_part[h] += __shfl_xor_sync(FULL, blank_part[h], off);
    __syncwarp();
    float init_part[H];
#pragma unroll
    for (int h = 0; h < H; ++h) init_part[h] = 0.f;
    for (int c = j; c < C; c += 32) {
      float v[H];
#pragma unroll
      for (int h = 0; h < H; ++h) v[h] = c == blank ? blank_part[h] : 0.f;
      for (int i = first[c]; i >= 0; i = next[i])
#pragma unroll
        for (int h = 0; h < H; ++h) v[h] += rows[h * RS + 2 * i + 1];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float gv = -v[h] * g;
        ge[((size_t)t * H + h) * C + c] = gv;
        init_part[h] += gv;
      }
    }
    if (t == 0) {  // the initial heights: the column-0 row summed over classes
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int h = 0; h < H; ++h) init_part[h] += __shfl_xor_sync(FULL, init_part[h], off);
      if (j < H)
#pragma unroll
        for (int h = 0; h < H; ++h)
          if (h == j) gi[h] = init_part[h];
    }
    __syncwarp();  // every read of rows done
    if (t >= 1) {
      const float* ap = al + (t - 1) * H * S;
      const float* At = as + t * HH;
      float xv[HH];
#pragma unroll
      for (int q = 0; q < HH; ++q) xv[q] = 0.f;
      for (int s = j; s < Sb; s += 32) {
        const State st = make_state(ls, s, S, lab_len, C, blank);
        float lm[H];
#pragma unroll
        for (int hp = 0; hp < H; ++hp) {
          const float* r = ap + hp * S;
          lm[hp] = logsumexp3(r[s], s >= 1 ? r[s - 1] : NEG_INF,
                              (st.skip && s >= 2) ? r[s - 2] : NEG_INF);
        }
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float nxv = bp[h * S + s] + et[h * C + st.cls];
#pragma unroll
          for (int hp = 0; hp < H; ++hp)
            xv[hp * H + h] += fexp(lm[hp] + At[hp * H + h] + nxv - logz);
        }
      }
      // HH shuffle trees side by side, level by level (each lane ends with
      // every sum)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < HH; ++q) xv[q] += __shfl_xor_sync(FULL, xv[q], o);
      if (j == 0)
#pragma unroll
        for (int q = 0; q < HH; ++q) tile[q] = xv[q];
      __syncwarp();
      for (int q = j; q < HH; q += 32) gt[(size_t)t * HH + q] = -tile[q] * g;
      __syncwarp();
    }
  }
  CTC2D_STAMP(9)
}

// Above 48 KB of dynamic shared memory a kernel must opt in, per device;
// opted[device] (one array per kernel instance) holds the largest size set.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t smem, size_t* opted) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && opted[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES) opted[dev] = smem;
  return 0;
}

template <int H>
int launch_alpha(const float* emit, const float* trans, const float* init,
                 const int* logit_lengths, const int* labels, const int* label_lengths, int B,
                 int T, int C, int L, int blank, float* alpha, float* nll, cudaStream_t stream) {
  const size_t smem = AlphaSmem(T, H, C, L).total * sizeof(float);
  static size_t opted[MAX_DEVICES] = {};
  const int err = opt_in_smem(ctc2d_alpha_kernel<H>, smem, opted);
  if (err != 0) return err;
  ctc2d_alpha_kernel<H><<<B, ALPHA_THREADS, smem, stream>>>(
      emit, trans, init, logit_lengths, labels, label_lengths, T, C, L, blank, alpha, nll);
  return (int)cudaGetLastError();
}

template <int H>
int launch_beta(const float* emit, const float* trans, const int* logit_lengths,
                const int* labels, const int* label_lengths, int B, int T, int C, int L,
                int blank, const float* alpha, const float* nll, const float* grad_nll,
                float* grad_emit, float* grad_trans, float* grad_init, cudaStream_t stream) {
  const size_t smem = BetaSmem(T, H, C, L).total * sizeof(float);
  static size_t opted[MAX_DEVICES] = {};
  const int err = opt_in_smem(ctc2d_beta_kernel<H>, smem, opted);
  if (err != 0) return err;
  ctc2d_beta_kernel<H><<<B, 32 * BETA_WARPS, smem, stream>>>(
      emit, trans, logit_lengths, labels, label_lengths, T, C, L, blank, alpha, nll, grad_nll,
      grad_emit, grad_trans, grad_init);
  return (int)cudaGetLastError();
}

}  // namespace

#define CTC2D_FOR_EACH_H(CALL) \
  switch (H) {                 \
    case 1: return CALL(1);    \
    case 2: return CALL(2);    \
    case 3: return CALL(3);    \
    case 4: return CALL(4);    \
    case 5: return CALL(5);    \
    case 6: return CALL(6);    \
    case 7: return CALL(7);    \
    case 8: return CALL(8);    \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// Bytes of dynamic shared memory of the alpha (beta = 0) or beta (beta = 1)
// kernel, for the wrapper's check.
size_t mr_ctc2d_smem(int beta, int T, int H, int L, int C) {
  const int floats = beta ? BetaSmem(T, H, C, L).total : AlphaSmem(T, H, C, L).total;
  return (size_t)floats * sizeof(float);
}

// The launchers' limits on H and on S = 2L+1.
int mr_ctc2d_max_heights() { return MAX_H; }
int mr_ctc2d_max_states() { return 32 * MAX_COLS; }

int mr_ctc2d_alpha_launch(const float* emit, const float* trans, const float* init,
                          const int* logit_lengths, const int* labels, const int* label_lengths,
                          int B, int T, int H, int C, int L, int blank, float* alpha, float* nll,
                          void* stream) {
  if (2 * L + 1 > 32 * MAX_COLS) return (int)cudaErrorInvalidValue;
#define CTC2D_ALPHA(h)                                                                     \
  launch_alpha<h>(emit, trans, init, logit_lengths, labels, label_lengths, B, T, C, L, blank, \
                  alpha, nll, (cudaStream_t)stream)
  CTC2D_FOR_EACH_H(CTC2D_ALPHA)
#undef CTC2D_ALPHA
}

int mr_ctc2d_beta_launch(const float* emit, const float* trans, const int* logit_lengths,
                         const int* labels, const int* label_lengths, int B, int T, int H, int C,
                         int L, int blank, const float* alpha, const float* nll,
                         const float* grad_nll, float* grad_emit, float* grad_trans,
                         float* grad_init, void* stream) {
  if (2 * L + 1 > 32 * MAX_COLS) return (int)cudaErrorInvalidValue;
#define CTC2D_BETA(h)                                                                     \
  launch_beta<h>(emit, trans, logit_lengths, labels, label_lengths, B, T, C, L, blank, alpha, \
                 nll, grad_nll, grad_emit, grad_trans, grad_init, (cudaStream_t)stream)
  CTC2D_FOR_EACH_H(CTC2D_BETA)
#undef CTC2D_BETA
}

}  // extern "C"
