// CTC loss on the card: the log-space alpha recursion (forward) and the beta
// recursion with the gradient with respect to the log-probabilities
// (backward).
//
// Replaces the TPU kernels megreader_tpu/ops/pallas_ctc.py::_ctc_alpha_kernel
// (pallas_call at :185) and ::_ctc_beta_kernel (pallas_call at :208). The
// semantics are those of the plain version (ops/ctc.py::ctc_alpha_reference
// and ::ctc_beta_reference, ports of the XLA scan in megreader_tpu/ops/ctc.py):
// S = 2L+1 extended states, NEG_INF = -1e30 as the sentinel of an unreachable
// state, a logsumexp whose maximum lies at or below NEG_INF/2 gives NEG_INF,
// states at or beyond 2*label_length+1 hold NEG_INF, alpha is frozen from
// t >= logit_length on (a length below 1 counts as 1, above T as T), and
// nll = -logaddexp(alpha[T-1, 2L], alpha[T-1, 2L-1]). A row with no
// alignment therefore has a finite loss of about 1e30; a label outside
// [0, C) (or a label length outside [0, L]) gives NaN.
//
// What bounds it on an H100. At the training shape of config #1 (B 64, T 25,
// C 37, labels padded to L 32, so S = 65) the forward pass moves about
// 0.66 MB and the backward pass about 0.9 MB: well under a microsecond each at
// 3.35 TB/s, and the arithmetic (a few exps and a log per state and step) is
// smaller still. What sets the time is the chain of T dependent steps at the
// latency of one warp, and the launch.
//
// The design's answer: one warp holds a whole sequence's chain in registers.
// Lane j holds the states j, j+32, j+64, ... (one column of 32 states each);
// a row steps only the columns its label length makes live, rounded up to a
// power of two (most words, up to 15 labels, need one column), with the
// kernel instantiated by the most columns the batch's padded L can need
// (up to 32: S <= 1024); alpha's chain steps only the columns its states
// can have reached (column k from step 16k on). The label move reads s-1 and
// s-2 by warp shuffles, and lanes 0 and 1 take them from the previous
// column's lanes 30 and 31 rotated the same way, so a step has no block
// barrier and no shared-memory round trip. The step has no jump: its selects
// are bit masks where the compiler would branch, and exp and log are the
// fast ones (see fexp). The chains run on alpha and beta less an offset kept
// in double (see alpha_steps), so that a long row keeps its precision.
//
// Each kernel has two instances, chosen by shape in the wrapper
// (ops/ctc.py). Where it fits in a block's shared memory, the sequence's
// (T, C) emission slab is staged there by cp.async before the chain, and the
// beta kernel keeps its planes there too (with the alpha slab arriving
// during the chain); past that, the chain reads its emissions from device
// memory one step ahead and the beta planes go to a scratch buffer from the
// wrapper. The alpha chain stores each row to the (B, T, S) output as it is
// made, frozen rows after it, while the block's other warps fill the states
// no column reaches with NEG_INF and check the labels.
//
// The beta kernel keeps only the mirrored recursion on its chain (phase A,
// one warp, the block's other warps meanwhile build each label class's list
// of positions). After one block barrier, phase B computes the gradient with
// no serial dependency:
// grad[t, c] = -g * sum over live s with class c of exp(alpha + beta - logZ),
// its warps over the steps: the blank over the even states by a shuffle
// tree, each label class along its list of positions. Every (t, c) of the
// output is written once, by consecutive lanes, with zeros on the frozen
// steps. There are no float atomics, so two launches on the same inputs give
// the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Per-step timestamps for scripts/ctc_probe.py, which defines these in its
// copy of this file; nothing here otherwise.
#ifndef CTC_STAMP
#define CTC_STAMP(id)
#define CTC_STAMP_INIT
#endif

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_COLS = 32;     // columns of 32 states: S = 2L+1 <= 1024
constexpr int ALPHA_WARPS = 4;   // warp 0 runs the chain; all stage and store
// Beta: phase A on warp 0, phase B on all; fewer warps where the chain's
// columns need the registers
template <int NC>
__host__ __device__ constexpr int beta_warps() { return NC <= 4 ? 16 : 8; }

// The chain and the gradient pass use the fast exp and log (ex2.approx and
// lg2.approx, flushing results below 2^-126 to zero, with no range fix-ups):
// branch-free, and their arguments here are a difference from a maximum
// (exp) or a sum of such exps between 1 and 3 (log), where they lose under
// 1e-6 relative; phase ctc of chip_smoke.py holds the results at the plain
// version's tolerances.
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

// All ones where bit c of m is set, else 0.
__device__ __forceinline__ unsigned bit_mask(unsigned m, int c) { return 0u - ((m >> c) & 1u); }

// Branch-free (a select, not a jump); the maximum's term is exp(0) = 1, so
// two exps, not three. With every input at NEG_INF the sum is 3 and the
// select takes NEG_INF.
__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  const float m = fmaxf(hi, c);
  const float mid = fmaxf(lo, fminf(hi, c));
  const float r = m + flog(1.f + fexp(mid - m) + fexp(fminf(lo, c) - m));
  return m <= HALF_NEG_INF ? NEG_INF : r;
}

// exp(alpha + beta - logZ), beta = beta_off + off, with the exponent summed
// in double (off_less_logz = off - logZ): alpha, beta and logZ grow with T
// (about -5 a step), and their sum in float would lose about 1e-4 of the
// result at T 240.
__device__ __forceinline__ float occupancy(float alpha, float beta_off, double off_less_logz) {
  return fexp((float)((double)alpha + (double)beta_off + off_less_logz));
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// The slot for an array staged from src: base (16-byte aligned, with 4 floats
// to spare) moved on by src's offset inside its 16 bytes, so that the two
// share their alignment and the copy can go 16 bytes at a time.
template <typename P>
__device__ __forceinline__ float* shifted(float* base, const P* src) {
  return base + ((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Copy n 4-byte words from device memory to shared memory with cp.async;
// dst lies at the same address as src modulo 16 (see shifted). The head and
// tail go 4 bytes at a time, the rest 16. Completes at the next
// cp_async_wait of the group committed after it.
__device__ __forceinline__ void stage(float* dst, const void* src, int n, int tid, int nthreads) {
  const char* s = static_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15) >> 2);
  const int n16 = (n - head) >> 2;
  for (int i = tid; i < n16; i += nthreads) {
    const int o = 4 * head + 16 * i;
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d + o));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(s + o) : "memory");
  }
  const int tail = head + 4 * n16;
  for (int i = tid; i < head + n - tail; i += nthreads) {
    const int o = 4 * (i < head ? i : tail + i - head);
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d + o));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(a), "l"(s + o) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One extended state s of a sequence.
struct State {
  int cls;     // class emitted in this state (clamped into [0, C))
  bool skip;   // the s-2 -> s transition is allowed
};

__device__ __forceinline__ State make_state(const int* lab, int s, int S, int C, int blank) {
  State st;
  const bool in_range = s < S;
  const int c = (in_range && (s & 1)) ? lab[s >> 1] : blank;
  const int c2 = (in_range && s >= 2) ? ((s & 1) ? lab[(s >> 1) - 1] : blank) : -1;
  st.skip = in_range && c != blank && c != c2;
  st.cls = min(max(c, 0), C - 1);
  return st;
}

// Columns of 32 states that a row with lab_len labels steps: its live
// columns rounded up to a power of two.
__host__ __device__ __forceinline__ int column_bucket(int states) {
  const int cols = (states + 31) >> 5;
  int kb = 1;
  while (kb < cols) kb <<= 1;
  return kb;
}

// Shared memory, in floats, each part from a multiple of 16 bytes; staged
// parts have 4 floats to spare (see shifted).
struct Smem {
  int emit, alpha, beta, offs, labels, next, first, fin, total;
  __host__ __device__ Smem(bool beta_kernel, bool shared, int T, int C, int L) {
    const int S = 2 * L + 1;
    int o = 0;
    emit = o;
    if (shared) o += round4(T * C + 4);
    const bool planes = shared && beta_kernel;
    alpha = o;
    if (planes) o += round4(T * S + 4);
    beta = o;
    if (planes) o += round4(T * S);
    offs = o;  // a double a step: the offset of that step's beta plane
    if (planes) o += round4(2 * T);
    labels = o;
    o += round4(L + 4);
    next = o;
    if (beta_kernel) o += round4(L);
    first = o;
    if (beta_kernel) o += round4(C);
    fin = o;
    total = o + 6;
  }
};

// Warp-wide maximum of the first N values of each lane.
template <int N, int KB>
__device__ __forceinline__ float warp_max(const float (&x)[KB]) {
  float m = x[0];
#pragma unroll
  for (int c = 1; c < N; ++c) m = fmaxf(m, x[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  return m;
}

// Alpha's chain keeps in a[] alpha less an offset `off` (double): each step
// subtracts the maximum of the values two steps back (r_use, reduced beside
// the step before), so that the float values stay near 0 however long the
// row. A stretch of the chain: steps t .. t_end-1 over the first N of the KB
// columns; the others hold NEG_INF, as state s is unreachable before step
// (s-1)/2, so column k joins at step 16k. Each row goes to the output as it
// is made (a store does not hold up the chain).
template <int N, int KB, bool SHARED>
__device__ __forceinline__ void alpha_steps(float (&a)[KB], float (&en)[KB], const int (&cls)[KB],
                                            unsigned keepm, unsigned skipm,
                                            const float* __restrict__ emit, int C, int S,
                                            int len, int& t, int t_end, float& r_use,
                                            double& off, float* out, int j) {
  if (!SHARED && t < t_end) {
#pragma unroll
    for (int c = 0; c < N; ++c) en[c] = __ldg(emit + (size_t)t * C + cls[c]);
  }
  for (; t < t_end; ++t) {
    CTC_STAMP(1)
    const float r_new = warp_max<N>(a);  // beside the step, used at the next one
    float e[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (SHARED) {
        e[c] = emit[t * C + cls[c]] - r_use;
      } else {  // read one step ahead
        e[c] = en[c] - r_use;
        if (t + 1 < len) en[c] = __ldg(emit + (size_t)(t + 1) * C + cls[c]);
      }
    }
    off += r_use;
    r_use = r_new;
    // s-1 and s-2 of lanes 0 and 1 come from the previous column, rotated
    float c1 = NEG_INF, c2 = NEG_INF;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float r1 = __shfl_sync(FULL, a[c], (j + 31) & 31);
      const float r2 = __shfl_sync(FULL, a[c], (j + 30) & 31);
      const float p1 = j >= 1 ? r1 : c1;
      const float p2 = j >= 2 ? r2 : c2;
      c1 = r1;
      c2 = r2;
      const float moved = logsumexp3(a[c], p1, keep_or_neg_inf(p2, bit_mask(skipm, c)));
      a[c] = keep_or_neg_inf(moved + e[c], bit_mask(keepm, c));
      const int s = 32 * c + j;
      if (s < S) out[(size_t)t * S + s] = (float)((double)a[c] + off);
    }
  }
}

// Alpha's chain, warp 0, KB columns: rows 0 .. len-1 and the frozen rows
// after them, of the states in the row's columns; the two terminal states'
// last values and their offset into fin.
template <int KB, bool SHARED>
__device__ __forceinline__ void alpha_chain(const float* __restrict__ emit, const int* lab, int T,
                                            int C, int S, int lab_len, int len, int blank,
                                            float* out, double* fin, int j) {
  const int Sb = 2 * lab_len + 1;
  float a[KB], en[KB];
  int cls[KB];
  unsigned keepm = 0, skipm = 0;
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    const int s = 32 * c + j;
    const State st = make_state(lab, s, S, C, blank);
    cls[c] = st.cls;
    keepm |= (unsigned)(s < Sb) << c;
    skipm |= (unsigned)st.skip << c;
    const bool start = s == 0 || (s == 1 && lab_len > 0);
    a[c] = start ? emit[cls[c]] : NEG_INF;
    if (s < S) out[s] = a[c];
  }
  double off = 0.0;
  float r_use = 0.f;
  int t = 1;
#define CTC_ALPHA_STEPS(n)                                                                   \
  alpha_steps<n, KB, SHARED>(a, en, cls, keepm, skipm, emit, C, S, len, t,                 \
                             n == KB ? len : min(len, 16 * n), r_use, off, out, j)
  CTC_ALPHA_STEPS(1);
  if constexpr (KB >= 2) CTC_ALPHA_STEPS(2);
  if constexpr (KB >= 4) CTC_ALPHA_STEPS(4);
  if constexpr (KB >= 8) CTC_ALPHA_STEPS(8);
  if constexpr (KB >= 16) CTC_ALPHA_STEPS(16);
  if constexpr (KB >= 32) CTC_ALPHA_STEPS(32);
#undef CTC_ALPHA_STEPS
  CTC_STAMP(9)
  if (j == 0) fin[2] = off;
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    const int s = 32 * c + j;
    if (s == Sb - 1) fin[0] = a[c];
    if (s == Sb - 2) fin[1] = a[c];
    if (s < S) {  // frozen past the row's length
      const float v = (float)((double)a[c] + off);
      for (int t = len; t < T; ++t) out[(size_t)t * S + s] = v;
    }
  }
}

// log_probs (B, T, C); labels (B, L); alpha out (B, T, S); nll out (B,).
// Block: ALPHA_WARPS warps for sequence blockIdx.x; NC the most columns the
// padded L needs (a power of two).
template <int NC, bool SHARED>
__global__ void __launch_bounds__(32 * ALPHA_WARPS)
    ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ logit_lengths,
                     const int* __restrict__ labels, const int* __restrict__ label_lengths, int T,
                     int C, int L, int blank, float* __restrict__ alpha,
                     float* __restrict__ nll) {
  extern __shared__ __align__(16) float smem[];
  CTC_STAMP_INIT
  CTC_STAMP(0)
  constexpr int NT = 32 * ALPHA_WARPS;
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int j = tid & 31;
  const Smem lay(false, SHARED, T, C, L);
  const float* lp = log_probs + (size_t)b * T * C;
  float* out = alpha + (size_t)b * T * S;
  // alpha[len-1] - off at the states 2*lab_len and 2*lab_len-1, and off
  double* fin = reinterpret_cast<double*>(smem + lay.fin);
  float* es = SHARED ? shifted(smem + lay.emit, lp) : nullptr;
  const int* lab = labels + (size_t)b * L;
  int* ls = reinterpret_cast<int*>(shifted(smem + lay.labels, lab));
  stage(reinterpret_cast<float*>(ls), lab, L, tid, NT);
  if (SHARED) stage(es, lp, T * C, tid, NT);
  cp_async_commit();
  const int raw_lab_len = label_lengths[b];
  const int lab_len = min(max(raw_lab_len, 0), L);
  const int len = min(max(logit_lengths[b], 1), T);
  const int KB = column_bucket(2 * lab_len + 1);
  cp_async_wait<0>();
  __syncthreads();  // the labels and the slab staged
  CTC_STAMP(2)

  bool bad = false;
  if (tid < 32) {
    const float* emit = SHARED ? es : lp;
#define CTC_ALPHA_CHAIN(kb) \
  alpha_chain<kb, SHARED>(emit, ls, T, C, S, lab_len, len, blank, out, fin, j)
    switch (KB) {
      case 1: CTC_ALPHA_CHAIN(1); break;
      case 2: if constexpr (NC >= 2) CTC_ALPHA_CHAIN(2); break;
      case 4: if constexpr (NC >= 4) CTC_ALPHA_CHAIN(4); break;
      case 8: if constexpr (NC >= 8) CTC_ALPHA_CHAIN(8); break;
      case 16: if constexpr (NC >= 16) CTC_ALPHA_CHAIN(16); break;
      default: if constexpr (NC >= 32) CTC_ALPHA_CHAIN(32); break;
    }
#undef CTC_ALPHA_CHAIN
  } else {
    // while the chain runs: a label outside [0, C), or a label length
    // outside [0, L], makes the loss NaN
    bad = tid == 32 && (raw_lab_len < 0 || raw_lab_len > L);
    for (int i = tid - 32; i < lab_len; i += NT - 32) bad = bad || ls[i] < 0 || ls[i] >= C;
    // the states past the row's columns and those unreachable so far
    // (s > 2t+1), which the chain leaves unwritten: NEG_INF
    for (int i = tid - 32; i < T * S; i += NT - 32) {
      const int t = i / S;
      const int s = i - t * S;
      if (s >= 32 * KB || s > 2 * min(t, len - 1) + 1) out[i] = NEG_INF;
    }
  }
  const bool any_bad = __syncthreads_or(bad);
  CTC_STAMP(10)
  if (tid == 0) {  // near 0 in float, then the offset in double
    const float a_last = (float)fin[0];
    const float a_prev = lab_len > 0 ? (float)fin[1] : NEG_INF;
    const float m = fmaxf(a_last, a_prev);
    const float ll = m + logf(expf(a_last - m) + expf(a_prev - m));
    nll[b] = any_bad ? nanf("") : (float)-(fin[2] + (double)ll);
  }
  CTC_STAMP(11)
}

// Beta's chain (phase A), warp 0, KB columns: beta[t_last] is 0 on the
// terminal states; beta[t-1][s] = lse(nx[s], nx[s+1], nx[s+2] where the
// s -> s+2 move is allowed), nx = beta[t] + emit[t] on valid states; every
// plane 0 .. t_last into bt. As in alpha's chain, the registers hold beta
// less an offset in double, the maxima of the values two steps back.
template <int KB, bool SHARED>
__device__ __forceinline__ void beta_chain(const float* __restrict__ emit, const int* ls, int C,
                                           int S, int lab_len, int t_last, int blank, float* bt,
                                           double* offs, int j) {
  const int Sb = 2 * lab_len + 1;
  float be[KB], en[KB];  // be: beta - off
  int cls[KB];
  unsigned keepm = 0, skip2m = 0;
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    const int s = 32 * c + j;
    cls[c] = make_state(ls, s, S, C, blank).cls;
    keepm |= (unsigned)(s < Sb) << c;
    skip2m |= (unsigned)make_state(ls, s + 2, S, C, blank).skip << c;
    const bool terminal = s == Sb - 1 || (lab_len > 0 && s == Sb - 2);
    be[c] = terminal ? 0.f : NEG_INF;
    if (s < S) bt[(size_t)t_last * S + s] = be[c];
    if (!SHARED) en[c] = __ldg(emit + (size_t)t_last * C + cls[c]);
  }
  if (SHARED && j == 0) offs[t_last] = 0.0;
  double off = 0.0;
  float q_use = 0.f;
  for (int t = t_last; t >= 1; --t) {
    CTC_STAMP(1)
    const float q_new = warp_max<KB>(be);  // beside the step, used at the next one
    float e[KB];
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      if (SHARED) {
        e[c] = emit[t * C + cls[c]] - q_use;
      } else {  // read one step ahead
        e[c] = en[c] - q_use;
        if (t > 1) en[c] = __ldg(emit + (size_t)(t - 1) * C + cls[c]);
      }
    }
    off += q_use;
    q_use = q_new;
    // s+1 and s+2 of lanes 31 and 30 come from the next column, rotated
    float c1 = NEG_INF, c2 = NEG_INF;
#pragma unroll
    for (int c = KB - 1; c >= 0; --c) {
      const float nx = keep_or_neg_inf(be[c] + e[c], bit_mask(keepm, c));
      const float d1 = __shfl_sync(FULL, nx, (j + 1) & 31);
      const float d2 = __shfl_sync(FULL, nx, (j + 2) & 31);
      const float p1 = j <= 30 ? d1 : c1;
      const float p2 = j <= 29 ? d2 : c2;
      c1 = d1;
      c2 = d2;
      be[c] = logsumexp3(nx, p1, keep_or_neg_inf(p2, bit_mask(skip2m, c)));
      const int s = 32 * c + j;
      if (s < S) bt[(size_t)(t - 1) * S + s] = SHARED ? be[c] : (float)((double)be[c] + off);
    }
    if (SHARED && j == 0) offs[t - 1] = off;
  }
  CTC_STAMP(3)
}

// grad out (B, T, C) = d(grad_nll . nll) / d log_probs. scratch (B, T, S)
// holds the beta planes of the device-memory instance (unused otherwise).
// Block: beta_warps<NC>() warps for sequence blockIdx.x.
template <int NC, bool SHARED>
__global__ void __launch_bounds__(32 * beta_warps<NC>())
    ctc_beta_kernel(const float* __restrict__ log_probs, const int* __restrict__ logit_lengths,
                    const int* __restrict__ labels, const int* __restrict__ label_lengths, int T,
                    int C, int L, int blank, const float* __restrict__ alpha,
                    const float* __restrict__ nll, const float* __restrict__ grad_nll,
                    float* __restrict__ grad, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  CTC_STAMP_INIT
  CTC_STAMP(0)
  constexpr int NW = beta_warps<NC>();
  constexpr int NT = 32 * NW;
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int j = tid & 31;
  float* g_out = grad + (size_t)b * T * C;
  const int* lab = labels + (size_t)b * L;
  const Smem lay(true, SHARED, T, C, L);
  const float* lp = log_probs + (size_t)b * T * C;
  const float* alb = alpha + (size_t)b * T * S;
  float* es = SHARED ? shifted(smem + lay.emit, lp) : nullptr;
  float* as = SHARED ? shifted(smem + lay.alpha, alb) : nullptr;
  int* ls = reinterpret_cast<int*>(shifted(smem + lay.labels, lab));
  stage(reinterpret_cast<float*>(ls), lab, L, tid, NT);
  if (SHARED) stage(es, lp, T * C, tid, NT);
  cp_async_commit();
  if (SHARED) stage(as, alb, T * S, tid, NT);  // lands during phase A
  cp_async_commit();
  const int lab_len = min(max(label_lengths[b], 0), L);
  const int t_last = min(max(logit_lengths[b], 1), T) - 1;
  const float logz = -nll[b];
  const float g = grad_nll[b];

  if (!(logz > HALF_NEG_INF)) {
    // No alignment: the plain version's sentinel arithmetic gives each
    // terminal state half of the row's gradient, at the last step only,
    // through its emission (nothing when that step is t = 0, where the
    // terminal states are constants); frozen steps carry none. A row with a
    // bad label (NaN loss) gets a NaN gradient on its live steps.
    const float gg = isnan(logz) ? logz : g;
    const int c_prev = lab_len > 0 ? lab[lab_len - 1] : -1;
    for (int i = tid; i < T * C; i += NT) {
      const int t = i / C;
      const int c = i - t * C;
      float v = 0.f;
      if (t == t_last && t > 0) {
        if (c == blank) v -= 0.5f;
        if (c == c_prev) v -= 0.5f;
      }
      g_out[i] = t <= t_last ? v * gg : 0.f;
    }
    cp_async_wait<0>();  // no copy outlives the block
    return;
  }

  int* next = reinterpret_cast<int*>(smem + lay.next);    // next position of the same class
  int* first = reinterpret_cast<int*>(smem + lay.first);  // first position of a class, or -1
  for (int c = tid; c < C; c += NT) first[c] = -1;
  cp_async_wait<1>();
  __syncthreads();
  CTC_STAMP(2)

  const float* al = SHARED ? as : alb;
  float* bt = SHARED ? smem + lay.beta : scratch + (size_t)b * T * S;
  double* offs = reinterpret_cast<double*>(smem + lay.offs);  // shared memory: beta - off
  const int KB = column_bucket(2 * lab_len + 1);
  if (w == 0) {
    const float* emit = SHARED ? es : lp;
#define CTC_BETA_CHAIN(kb) \
  beta_chain<kb, SHARED>(emit, ls, C, S, lab_len, t_last, blank, bt, offs, j)
    switch (KB) {
      case 1: CTC_BETA_CHAIN(1); break;
      case 2: if constexpr (NC >= 2) CTC_BETA_CHAIN(2); break;
      case 4: if constexpr (NC >= 4) CTC_BETA_CHAIN(4); break;
      case 8: if constexpr (NC >= 8) CTC_BETA_CHAIN(8); break;
      case 16: if constexpr (NC >= 16) CTC_BETA_CHAIN(16); break;
      default: if constexpr (NC >= 32) CTC_BETA_CHAIN(32); break;
    }
#undef CTC_BETA_CHAIN
  } else {
    // while phase A runs: each label class's positions as a list, in order
    for (int i = tid - 32; i < lab_len; i += NT - 32) {
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
  CTC_STAMP(4)

  // Phase B: every step's class row at once, warp w the steps w, w + NW, ...
  const int Sb = 2 * lab_len + 1;
  for (int t = w; t < T; t += NW) {
    float* row = g_out + (size_t)t * C;
    if (t > t_last) {  // frozen steps carry no gradient
      for (int c = j; c < C; c += 32) row[c] = 0.f;
      continue;
    }
    const float* at = al + (size_t)t * S;
    const float* bp = bt + (size_t)t * S;
    const double off_less_logz = (SHARED ? offs[t] : 0.0) - (double)logz;
    float blank_sum = 0.f;
    for (int s = 2 * j; s < Sb; s += 64) blank_sum += occupancy(at[s], bp[s], off_less_logz);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) blank_sum += __shfl_xor_sync(FULL, blank_sum, o);
    for (int c = j; c < C; c += 32) {
      float v = c == blank ? blank_sum : 0.f;
      for (int k = first[c]; k >= 0; k = next[k])
        v += occupancy(at[2 * k + 1], bp[2 * k + 1], off_less_logz);
      row[c] = -v * g;
    }
  }
  CTC_STAMP(9)
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

template <int NC, bool SHARED>
int launch_alpha(const float* log_probs, const int* logit_lengths, const int* labels,
                 const int* label_lengths, int B, int T, int C, int L, int blank, float* alpha,
                 float* nll, cudaStream_t stream) {
  const size_t smem = Smem(false, SHARED, T, C, L).total * sizeof(float);
  static size_t opted[MAX_DEVICES] = {};
  const int err = opt_in_smem(ctc_alpha_kernel<NC, SHARED>, smem, opted);
  if (err != 0) return err;
  ctc_alpha_kernel<NC, SHARED><<<B, 32 * ALPHA_WARPS, smem, stream>>>(
      log_probs, logit_lengths, labels, label_lengths, T, C, L, blank, alpha, nll);
  return (int)cudaGetLastError();
}

template <int NC, bool SHARED>
int launch_beta(const float* log_probs, const int* logit_lengths, const int* labels,
                const int* label_lengths, int B, int T, int C, int L, int blank,
                const float* alpha, const float* nll, const float* grad_nll, float* grad,
                float* scratch, cudaStream_t stream) {
  const size_t smem = Smem(true, SHARED, T, C, L).total * sizeof(float);
  static size_t opted[MAX_DEVICES] = {};
  const int err = opt_in_smem(ctc_beta_kernel<NC, SHARED>, smem, opted);
  if (err != 0) return err;
  ctc_beta_kernel<NC, SHARED><<<B, 32 * beta_warps<NC>(), smem, stream>>>(
      log_probs, logit_lengths, labels, label_lengths, T, C, L, blank, alpha, nll, grad_nll, grad,
      scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher instance by the columns the padded L needs, in shared
// memory (shared != 0) or in device memory.
#define CTC_FOR_EACH_NC(CALL)                     \
  switch (column_bucket(2 * L + 1)) {             \
    case 1: return CALL(1);                       \
    case 2: return CALL(2);                       \
    case 4: return CALL(4);                       \
    case 8: return CALL(8);                       \
    case 16: return CALL(16);                     \
    case 32: return CALL(32);                     \
    default: return (int)cudaErrorInvalidValue;   \
  }

extern "C" {

// Bytes of dynamic shared memory of the alpha (beta = 0) or beta (beta = 1)
// kernel's instance with its planes in shared memory (shared = 1) or in
// device memory (shared = 0), for the wrapper's choice and check.
size_t mr_ctc_smem(int beta, int shared, int T, int L, int C) {
  return (size_t)Smem(beta != 0, shared != 0, T, C, L).total * sizeof(float);
}

// The launchers' limit on S = 2L+1.
int mr_ctc_max_states() { return 32 * MAX_COLS; }

int mr_ctc_alpha_launch(const float* log_probs, const int* logit_lengths, const int* labels,
                        const int* label_lengths, int B, int T, int C, int L, int blank,
                        int shared, float* alpha, float* nll, void* stream) {
  if (2 * L + 1 > 32 * MAX_COLS) return (int)cudaErrorInvalidValue;
#define CTC_ALPHA(nc)                                                                        \
  (shared ? launch_alpha<nc, true>(log_probs, logit_lengths, labels, label_lengths, B, T, C, \
                                   L, blank, alpha, nll, (cudaStream_t)stream)               \
          : launch_alpha<nc, false>(log_probs, logit_lengths, labels, label_lengths, B, T, C, \
                                    L, blank, alpha, nll, (cudaStream_t)stream))
  CTC_FOR_EACH_NC(CTC_ALPHA)
#undef CTC_ALPHA
}

int mr_ctc_beta_launch(const float* log_probs, const int* logit_lengths, const int* labels,
                       const int* label_lengths, int B, int T, int C, int L, int blank,
                       int shared, const float* alpha, const float* nll, const float* grad_nll,
                       float* grad, float* scratch, void* stream) {
  if (2 * L + 1 > 32 * MAX_COLS) return (int)cudaErrorInvalidValue;
  if (!shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
#define CTC_BETA(nc)                                                                          \
  (shared ? launch_beta<nc, true>(log_probs, logit_lengths, labels, label_lengths, B, T, C, L, \
                                  blank, alpha, nll, grad_nll, grad, scratch,                 \
                                  (cudaStream_t)stream)                                       \
          : launch_beta<nc, false>(log_probs, logit_lengths, labels, label_lengths, B, T, C,   \
                                   L, blank, alpha, nll, grad_nll, grad, scratch,             \
                                   (cudaStream_t)stream))
  CTC_FOR_EACH_NC(CTC_BETA)
#undef CTC_BETA
}

}  // extern "C"
