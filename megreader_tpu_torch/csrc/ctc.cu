// CTC loss on the card: the log-space alpha recursion (forward) and the beta
// recursion with the gradient with respect to the log-probabilities
// (backward), one thread block per sequence.
//
// Replaces the TPU kernels megreader_tpu/ops/pallas_ctc.py::_ctc_alpha_kernel
// (pallas_call at :185) and ::_ctc_beta_kernel (pallas_call at :208). The
// semantics are those of the plain version (ops/ctc.py::ctc_nll_reference,
// a port of the XLA scan in megreader_tpu/ops/ctc.py): S = 2L+1 extended
// states, NEG_INF = -1e30 as the sentinel of an unreachable state, a
// logsumexp whose maximum lies at or below NEG_INF/2 gives NEG_INF, states at
// or beyond 2*label_length+1 hold NEG_INF, alpha is frozen from
// t >= logit_length on (a length below 1 counts as 1, above T as T), and
// nll = -logaddexp(alpha[T-1, 2L], alpha[T-1, 2L-1]). A row with no
// alignment therefore has a finite loss of about 1e30.
//
// What bounds it on an H100. At the training shape of config #1 (B 64, T 25,
// C 37, labels padded to L 32, so S = 65) the forward pass moves about 0.66 MB
// (log-probs 237 KB read, alpha 416 KB written) and the backward pass about
// 0.9 MB (log-probs and alpha read, the (B, T, C) gradient written): well
// under a microsecond each at 3.35 TB/s, and the arithmetic (a few exps and a
// log per state and step, about 0.1 M states) is smaller still. What sets the
// time is the chain of T dependent steps, each a gather, a logsumexp and a
// barrier, and the launch.
//
// The design's answer: one block per sequence (grid = B), one thread per
// extended state (block = S rounded up to 32). The two latest alpha rows sit
// in shared memory, double-buffered, so one __syncthreads() per step
// separates them; the emission log_probs[b, t, ext[s]] is gathered by each
// thread straight from device memory (an L2-resident gather, not the one-hot
// matmul the TPU needs) and loaded one step ahead. The forward pass writes
// every alpha row to a (B, T, S) buffer that the backward pass reads. The
// backward pass runs the mirrored recursion back to front and folds the
// per-state gradient -exp(alpha + beta - logZ) into a per-class row in shared
// memory with shared-memory atomics (two rows, alternating by step, so one
// barrier per step suffices), then writes that row of the (B, T, C) output:
// the class gather of the TPU path's transposed one-hot matmul happens
// inside the kernel, and every output element is written once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;

__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= HALF_NEG_INF) return NEG_INF;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// Per-thread view of one extended state of sequence b.
struct State {
  int cls;     // class emitted in this state (clamped into [0, C))
  bool valid;  // s < 2 * label_length + 1
  bool skip;   // the s-2 -> s transition is allowed
  bool bad;    // a label inside label_length lies outside [0, C)
};

__device__ __forceinline__ State make_state(const int* __restrict__ lab, int s, int S,
                                            int lab_len, int C, int blank) {
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

// log_probs (B, T, C); labels (B, L); alpha out (B, T, S); nll out (B,).
// Dynamic shared memory: 2 * (blockDim.x + 2) floats.
__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs,
                                 const int* __restrict__ logit_lengths,
                                 const int* __restrict__ labels,
                                 const int* __restrict__ label_lengths, int T, int C, int L,
                                 int blank, float* __restrict__ alpha,
                                 float* __restrict__ nll) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int W = blockDim.x + 2;  // two leading NEG_INF slots stand for s-1, s-2 < 0
  float* bufs[2] = {smem, smem + W};
  const float* lp = log_probs + (size_t)b * T * C;
  float* out = alpha + (size_t)b * T * S;
  const int raw_lab_len = label_lengths[b];
  const int lab_len = min(max(raw_lab_len, 0), L);
  const int len = min(max(logit_lengths[b], 1), T);
  const State st = make_state(labels + (size_t)b * L, s, S, lab_len, C, blank);
  const bool any_bad =
      __syncthreads_or(st.bad || (s == 0 && (raw_lab_len < 0 || raw_lab_len > L)));

  float a = NEG_INF;
  if (s == 0) a = lp[blank];
  else if (s == 1 && lab_len > 0) a = lp[st.cls];
  if (!st.valid) a = NEG_INF;
  if (s < 2) {
    bufs[0][s] = NEG_INF;
    bufs[1][s] = NEG_INF;
  }
  bufs[0][2 + s] = a;
  if (s < S) out[s] = a;

  float* cur = bufs[0];
  float e_next = len > 1 ? lp[(size_t)C + st.cls] : 0.f;
  for (int t = 1; t < len; ++t) {
    __syncthreads();  // row t-1 complete in `cur`
    const float e = e_next;
    if (t + 1 < len) e_next = lp[(size_t)(t + 1) * C + st.cls];
    const float* prev = cur;
    cur = bufs[t & 1];
    const float a2 = st.skip ? prev[s] : NEG_INF;  // prev[2 + s - 2]
    const float m = fmaxf(fmaxf(prev[2 + s], prev[1 + s]), a2);
    const float summed =
        m + logf(expf(prev[2 + s] - m) + expf(prev[1 + s] - m) + expf(a2 - m));
    a = st.valid ? (m <= HALF_NEG_INF ? NEG_INF : summed) + e : NEG_INF;
    cur[2 + s] = a;
    if (s < S) out[(size_t)t * S + s] = a;
  }
  if (s < S) {  // frozen past the row's length
    for (int t = len; t < T; ++t) out[(size_t)t * S + s] = a;
  }
  __syncthreads();
  if (s == 0) {
    const float a_last = cur[2 + 2 * lab_len];
    const float a_prev = lab_len > 0 ? cur[2 + 2 * lab_len - 1] : NEG_INF;
    const float m = fmaxf(a_last, a_prev);
    const float ll = m + logf(expf(a_last - m) + expf(a_prev - m));
    nll[b] = any_bad ? nanf("") : -ll;
  }
}

// grad out (B, T, C) = d(grad_nll . nll) / d log_probs.
// Dynamic shared memory: 2 * (blockDim.x + 2) floats of beta-side terms,
// 2 * C floats of class rows, blockDim.x + 2 ints of skip flags.
__global__ void ctc_beta_kernel(const float* __restrict__ log_probs,
                                const int* __restrict__ logit_lengths,
                                const int* __restrict__ labels,
                                const int* __restrict__ label_lengths, int T, int C, int L,
                                int blank, const float* __restrict__ alpha,
                                const float* __restrict__ nll,
                                const float* __restrict__ grad_nll,
                                float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int nt = blockDim.x;
  const int W = nt + 2;  // two trailing NEG_INF slots stand for s+1, s+2 >= blockDim
  float* nxt_bufs[2] = {smem, smem + W};
  float* acc[2] = {smem + 2 * W, smem + 2 * W + C};
  int* skip = reinterpret_cast<int*>(smem + 2 * W + 2 * C);
  const float* lp = log_probs + (size_t)b * T * C;
  const float* al = alpha + (size_t)b * T * S;
  float* g_out = grad + (size_t)b * T * C;
  const int lab_len = min(max(label_lengths[b], 0), L);
  const int t_last = min(max(logit_lengths[b], 1), T) - 1;
  const float logz = -nll[b];
  const float g = grad_nll[b];
  const State st = make_state(labels + (size_t)b * L, s, S, lab_len, C, blank);

  for (int t = t_last + 1; t < T; ++t)  // frozen steps carry no gradient
    for (int c = s; c < C; c += nt) g_out[(size_t)t * C + c] = 0.f;

  if (!(logz > HALF_NEG_INF)) {
    // No alignment: the plain version's sentinel arithmetic gives each
    // terminal state half of the row's gradient, at the last step only,
    // through its emission (nothing when that step is t = 0, where the
    // terminal states are constants). A row with a bad label (NaN loss)
    // gets a NaN gradient.
    const float gg = isnan(logz) ? logz : g;
    const int c_last = blank;
    const int c_prev = lab_len > 0 ? labels[(size_t)b * L + lab_len - 1] : -1;
    for (int t = 0; t <= t_last; ++t) {
      for (int c = s; c < C; c += nt) {
        float v = 0.f;
        if (t == t_last && t > 0) {
          if (c == c_last) v -= 0.5f;
          if (c == c_prev) v -= 0.5f;
        }
        g_out[(size_t)t * C + c] = v * gg;
      }
    }
    return;
  }

  for (int c = s; c < C; c += nt) {
    acc[0][c] = 0.f;
    acc[1][c] = 0.f;
  }
  skip[s] = st.skip;
  if (s < 2) {
    skip[nt + s] = 0;
    nxt_bufs[0][nt + s] = NEG_INF;
    nxt_bufs[1][nt + s] = NEG_INF;
  }
  const bool terminal = s == 2 * lab_len || (lab_len > 0 && s == 2 * lab_len - 1);
  const float smask = st.valid ? 0.f : NEG_INF;
  __syncthreads();

  float e = lp[(size_t)t_last * C + st.cls];
  float beta = terminal ? 0.f : NEG_INF;
  for (int t = t_last; t >= 0; --t) {
    if (t < t_last) {  // beta[t] from beta[t+1] + emit[t+1], kept in nxt_bufs
      const float* nx = nxt_bufs[(t + 1) & 1];
      beta = logsumexp3(nx[s], nx[s + 1], skip[s + 2] ? nx[s + 2] : NEG_INF);
    }
    const float e_t = e;
    if (t > 0) e = lp[(size_t)(t - 1) * C + st.cls];
    if (st.valid)
      atomicAdd(&acc[t & 1][st.cls], -expf(al[(size_t)t * S + s] + beta - logz));
    nxt_bufs[t & 1][s] = beta + e_t + smask;
    __syncthreads();
    for (int c = s; c < C; c += nt) {
      g_out[(size_t)t * C + c] = acc[t & 1][c] * g;
      acc[t & 1][c] = 0.f;
    }
  }
}

inline int block_threads(int L) { return ((2 * L + 1 + 31) / 32) * 32; }

inline size_t alpha_smem(int L) { return 2 * (size_t)(block_threads(L) + 2) * sizeof(float); }

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the beta kernel, for the wrapper's check
// (the alpha kernel's are at most 8 KB for the at most 1024 threads of a block).
size_t mr_ctc_beta_smem(int L, int C) {
  const size_t w = block_threads(L) + 2;
  return (2 * w + 2 * (size_t)C) * sizeof(float) + w * sizeof(int);
}

int mr_ctc_alpha_launch(const float* log_probs, const int* logit_lengths, const int* labels,
                        const int* label_lengths, int B, int T, int C, int L, int blank,
                        float* alpha, float* nll, void* stream) {
  ctc_alpha_kernel<<<B, block_threads(L), alpha_smem(L), (cudaStream_t)stream>>>(
      log_probs, logit_lengths, labels, label_lengths, T, C, L, blank, alpha, nll);
  return (int)cudaGetLastError();
}

int mr_ctc_beta_launch(const float* log_probs, const int* logit_lengths, const int* labels,
                       const int* label_lengths, int B, int T, int C, int L, int blank,
                       const float* alpha, const float* nll, const float* grad_nll,
                       float* grad, void* stream) {
  ctc_beta_kernel<<<B, block_threads(L), mr_ctc_beta_smem(L, C), (cudaStream_t)stream>>>(
      log_probs, logit_lengths, labels, label_lengths, T, C, L, blank, alpha, nll, grad_nll,
      grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
