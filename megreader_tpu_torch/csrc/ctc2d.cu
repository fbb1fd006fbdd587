// 2D-CTC loss with a Markov height chain on the card: the log-space alpha
// recursion over (height, extended label state) (forward) and the beta
// recursion with the gradients with respect to the emissions and the
// transitions (backward), one thread block per sequence.
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
// 2.7 MB (emissions 0.95 MB and transitions 0.1 MB read, alpha 1.66 MB
// written) and the backward pass about 3.8 MB: about a microsecond each at
// 3.35 TB/s, and the arithmetic (a few exps a state and height and step,
// about 0.4 M (h, s) cells) is smaller still. What sets the time is the chain
// of T dependent steps, each a label move, a barrier, a contraction over H
// heights and another barrier, and the launch.
//
// The design's answer: one block per sequence (grid = B) and one thread per
// (height, state) pair. The states of each height are padded to a multiple of
// 32 (Sp), so every warp holds one height: block = H x Sp threads (384 at
// H 4, 576 at H 6). Per step, each thread writes the label move of its own
// (h, s) to a shared H x Sp plane, a barrier, then each thread contracts over
// the H previous heights with A_t, staged in shared memory and loaded one
// step ahead, and adds its emission emit[b, t, h, ext[s]], gathered straight
// from device memory (L2) one step ahead (not the TPU path's one-hot matmul).
// The forward pass writes every alpha plane to a (B, T, H, S) buffer that the
// backward pass reads. The backward pass runs the mirrored recursion back to
// front: the per-state emission gradient -exp(alpha + beta - logZ) is folded
// into a per-(height, class) row with shared-memory atomics and written once
// as a row of the (B, T, H, C) output; the transition gradient
// xi[h', h] = -sum_s exp(lblmove(alpha[t-1])[h', s] + A_t[h', h]
//                         + emit[t, h, s] + beta[t, h, s] - logZ)
// is reduced over s with warp shuffles (each warp one h) and one shared
// atomic per warp into an H x H tile, then written once.

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

inline int padded_states(int L) { return ((2 * L + 1 + 31) / 32) * 32; }

// emit (B, T, H, C); trans (B, T, H, H) with rows h_prev; init (B, H);
// labels (B, L); alpha out (B, T, H, S); nll out (B,).
// Block: H * Sp threads, thread i = h * Sp + s.
// Dynamic shared memory: alpha plane H x (Sp + 2) (two leading NEG_INF
// slots per row stand for s-1, s-2 < 0), label-move plane H x Sp, A_t H x H.
__global__ void ctc2d_alpha_kernel(const float* __restrict__ emit,
                                   const float* __restrict__ trans,
                                   const float* __restrict__ init,
                                   const int* __restrict__ logit_lengths,
                                   const int* __restrict__ labels,
                                   const int* __restrict__ label_lengths, int T, int H, int C,
                                   int L, int blank, float* __restrict__ alpha,
                                   float* __restrict__ nll) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  const int Sp = blockDim.x / H;
  const int W = Sp + 2;
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int h = i / Sp;
  const int s = i % Sp;
  const int HH = H * H;
  float* ap = smem;             // [h * W + 2 + s]
  float* lbl = smem + H * W;    // [h * Sp + s]
  float* At = lbl + H * Sp;     // [h_prev * H + h]
  const float* em = emit + (size_t)b * T * H * C;
  const float* tr = trans + (size_t)b * T * HH;
  float* out = alpha + (size_t)b * T * H * S;
  const int raw_lab_len = label_lengths[b];
  const int lab_len = min(max(raw_lab_len, 0), L);
  const int len = min(max(logit_lengths[b], 1), T);
  const State st = make_state(labels + (size_t)b * L, s, S, lab_len, C, blank);
  const bool any_bad =
      __syncthreads_or(st.bad || (i == 0 && (raw_lab_len < 0 || raw_lab_len > L)));

  float a = NEG_INF;
  if (st.valid && (s == 0 || (s == 1 && lab_len > 0)))
    a = init[(size_t)b * H + h] + em[(size_t)h * C + st.cls];
  if (s < 2) ap[h * W + s] = NEG_INF;
  ap[h * W + 2 + s] = a;
  if (s < S) out[(size_t)h * S + s] = a;

  float e_next = len > 1 ? em[((size_t)H + h) * C + st.cls] : 0.f;
  float A_next = (len > 1 && i < HH) ? tr[HH + i] : 0.f;
  for (int t = 1; t < len; ++t) {
    __syncthreads();  // alpha[t-1] complete; the last step's reads of lbl and At done
    const float e = e_next;
    if (i < HH) At[i] = A_next;
    if (t + 1 < len) {
      e_next = em[((size_t)(t + 1) * H + h) * C + st.cls];
      if (i < HH) A_next = tr[(size_t)(t + 1) * HH + i];
    }
    const float* row = ap + h * W;
    lbl[h * Sp + s] = logsumexp3(row[2 + s], row[1 + s], st.skip ? row[s] : NEG_INF);
    __syncthreads();  // label moves and A_t complete; every read of ap done
    float m = lbl[s] + At[h];
    for (int hp = 1; hp < H; ++hp) m = fmaxf(m, lbl[hp * Sp + s] + At[hp * H + h]);
    float sum = 0.f;
    for (int hp = 0; hp < H; ++hp) sum += expf(lbl[hp * Sp + s] + At[hp * H + h] - m);
    a = st.valid ? (logf(sum) + m) + e : NEG_INF;
    ap[h * W + 2 + s] = a;
    if (s < S) out[((size_t)t * H + h) * S + s] = a;
  }
  if (s < S) {  // frozen past the row's length
    for (int t = len; t < T; ++t) out[((size_t)t * H + h) * S + s] = a;
  }
  __syncthreads();
  if (i == 0) {
    float lse[2];
    for (int k = 0; k < 2; ++k) {  // height marginals of the two terminal states
      const int col = 2 + 2 * lab_len - k;
      float m = ap[col];
      for (int hh = 1; hh < H; ++hh) m = fmaxf(m, ap[hh * W + col]);
      float sum = 0.f;
      for (int hh = 0; hh < H; ++hh) sum += expf(ap[hh * W + col] - m);
      lse[k] = logf(sum) + m;
    }
    const float a_last = lse[0];
    const float a_prev = lab_len > 0 ? lse[1] : NEG_INF;
    const float m = fmaxf(a_last, a_prev);
    const float ll = m + logf(expf(a_last - m) + expf(a_prev - m));
    nll[b] = any_bad ? nanf("") : -ll;
  }
}

// grad_emit out (B, T, H, C) = d(grad_nll . nll) / d emit,
// grad_trans out (B, T, H, H) = d(grad_nll . nll) / d trans.
// Dynamic shared memory (floats): beta-side plane H x (Sp + 2) (two trailing
// NEG_INF slots per row stand for s+1, s+2 >= Sp), backward label-move plane
// H x Sp, label-move plane of alpha[t-1] H x Sp, A_t twice H x H (by the
// step's parity: the last phase of step t still reads it while the first of
// step t-1 writes), xi H x H, class rows H x C; then Sp + 2 ints of skip
// flags.
__global__ void ctc2d_beta_kernel(const float* __restrict__ emit,
                                  const float* __restrict__ trans,
                                  const int* __restrict__ logit_lengths,
                                  const int* __restrict__ labels,
                                  const int* __restrict__ label_lengths, int T, int H, int C,
                                  int L, int blank, const float* __restrict__ alpha,
                                  const float* __restrict__ nll,
                                  const float* __restrict__ grad_nll,
                                  float* __restrict__ grad_emit,
                                  float* __restrict__ grad_trans) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  const int nt = blockDim.x;
  const int Sp = nt / H;
  const int W = Sp + 2;
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int h = i / Sp;
  const int s = i % Sp;
  const int HH = H * H;
  const int HC = H * C;
  float* nx = smem;             // [h * W + s]: beta[t] + emit[t] on valid states
  float* mv = nx + H * W;       // [h * Sp + s]: label move of nx, backwards
  float* lb = mv + H * Sp;      // [h * Sp + s]: label move of alpha[t-1]
  float* At2 = lb + H * Sp;     // [(t & 1) * HH + h_prev * H + h]
  float* xi = At2 + 2 * HH;     // [h_prev * H + h]
  float* acc = xi + HH;         // [h * C + c]
  int* skip = reinterpret_cast<int*>(acc + HC);
  const float* em = emit + (size_t)b * T * HC;
  const float* tr = trans + (size_t)b * T * HH;
  const float* al = alpha + (size_t)b * T * H * S;
  float* ge = grad_emit + (size_t)b * T * HC;
  float* gt = grad_trans + (size_t)b * T * HH;
  const int lab_len = min(max(label_lengths[b], 0), L);
  const int t_last = min(max(logit_lengths[b], 1), T) - 1;
  const float logz = -nll[b];
  const float g = grad_nll[b];
  const State st = make_state(labels + (size_t)b * L, s, S, lab_len, C, blank);

  for (int t = t_last + 1; t < T; ++t) {  // frozen steps carry no gradient
    for (int k = i; k < HC; k += nt) ge[(size_t)t * HC + k] = 0.f;
    for (int k = i; k < HH; k += nt) gt[(size_t)t * HH + k] = 0.f;
  }
  for (int k = i; k < HH; k += nt) gt[k] = 0.f;  // trans[:, 0] is never used

  if (!(logz > HALF_NEG_INF)) {
    // No alignment: the XLA scan's sentinel arithmetic gives each terminal
    // state -1/2 of the row's gradient at the last step, spread evenly over
    // the H heights (-1/(2H) on each height's emission of the state's class)
    // and then over the H previous heights (-1/(2H^2) on each transition);
    // nothing at t = 0, where the terminal states are constants. A row with
    // a bad label (NaN loss) gets a NaN gradient.
    const float gg = isnan(logz) ? logz : g;
    const int c_prev = lab_len > 0 ? labels[(size_t)b * L + lab_len - 1] : -1;
    const float w = 0.5f / H;
    for (int t = 0; t <= t_last; ++t) {
      for (int k = i; k < HC; k += nt) {
        const int c = k % C;
        float v = 0.f;
        if (t == t_last && t > 0) {
          if (c == blank) v -= w;
          if (c == c_prev) v -= w;
        }
        ge[(size_t)t * HC + k] = v * gg;
      }
      if (t > 0) {
        const float v = t == t_last ? -(lab_len > 0 ? 2.f : 1.f) * w / H : 0.f;
        for (int k = i; k < HH; k += nt) gt[(size_t)t * HH + k] = v * gg;
      }
    }
    return;
  }

  for (int k = i; k < HC; k += nt) acc[k] = 0.f;
  for (int k = i; k < HH; k += nt) xi[k] = 0.f;
  if (h == 0) skip[s] = st.skip;
  if (i < 2) skip[Sp + i] = 0;
  if (s < 2) nx[h * W + Sp + s] = NEG_INF;
  const bool terminal = s == 2 * lab_len || (lab_len > 0 && s == 2 * lab_len - 1);
  const bool in_range = s < S;
  __syncthreads();

  // alpha[t-1] at s, s-1, s-2 (NEG_INF outside the states), for the label
  // move the transition gradient of step t needs; loaded one step ahead
  float p0 = NEG_INF, p1 = NEG_INF, p2 = NEG_INF;
  auto load_prev = [&](int t) {
    const float* r = al + ((size_t)t * H + h) * S;
    p0 = in_range ? r[s] : NEG_INF;
    p1 = (in_range && s >= 1) ? r[s - 1] : NEG_INF;
    p2 = (in_range && s >= 2) ? r[s - 2] : NEG_INF;
  };
  float e = em[((size_t)t_last * H + h) * C + st.cls];
  float a_t = in_range ? al[((size_t)t_last * H + h) * S + s] : NEG_INF;
  float A_cur = 0.f;
  if (t_last >= 1) {
    load_prev(t_last - 1);
    if (i < HH) A_cur = tr[(size_t)t_last * HH + i];
  }
  float beta = terminal ? 0.f : NEG_INF;
  for (int t = t_last; t >= 0; --t) {
    float* At = At2 + (t & 1) * HH;
    const float nxv = st.valid ? beta + e : NEG_INF;
    nx[h * W + s] = nxv;
    if (st.valid) atomicAdd(&acc[h * C + st.cls], -expf(a_t + beta - logz));
    if (t >= 1) {
      lb[h * Sp + s] = logsumexp3(p0, p1, st.skip ? p2 : NEG_INF);
      if (i < HH) At[i] = A_cur;
      e = em[((size_t)(t - 1) * H + h) * C + st.cls];  // the next step's operands
      a_t = p0;
      if (t >= 2) {
        load_prev(t - 2);
        if (i < HH) A_cur = tr[(size_t)(t - 1) * HH + i];
      }
    }
    __syncthreads();  // nx, lb, At and the class rows of step t complete
    for (int k = i; k < HC; k += nt) {
      ge[(size_t)t * HC + k] = acc[k] * g;
      acc[k] = 0.f;
    }
    if (t >= 1) {
      for (int hp = 0; hp < H; ++hp) {
        float v = st.valid ? expf(lb[hp * Sp + s] + At[hp * H + h] + nxv - logz) : 0.f;
        v = warp_sum(v);
        if ((i & 31) == 0) atomicAdd(&xi[hp * H + h], -v);
      }
      const float* r = nx + h * W;
      mv[h * Sp + s] = logsumexp3(r[s], r[s + 1], skip[s + 2] ? r[s + 2] : NEG_INF);
    }
    __syncthreads();  // mv and xi of step t complete; every read of nx done
    if (t >= 1) {
      // beta[t-1][h][s] = lse over h'' of mv[h''][s] + A_t[h][h'']
      float m = mv[s] + At[h * H];
      for (int hn = 1; hn < H; ++hn) m = fmaxf(m, mv[hn * Sp + s] + At[h * H + hn]);
      if (m <= HALF_NEG_INF) {
        beta = NEG_INF;
      } else {
        float sum = 0.f;
        for (int hn = 0; hn < H; ++hn) sum += expf(mv[hn * Sp + s] + At[h * H + hn] - m);
        beta = m + logf(sum);
      }
      if (i < HH) {
        gt[(size_t)t * HH + i] = xi[i] * g;
        xi[i] = 0.f;
      }
    }
  }
}

size_t alpha_smem(int H, int L) {
  const size_t sp = padded_states(L);
  return (H * (sp + 2) + H * sp + (size_t)H * H) * sizeof(float);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the beta kernel, for the wrapper's check
// (the alpha kernel's are fewer).
size_t mr_ctc2d_beta_smem(int H, int L, int C) {
  const size_t sp = padded_states(L);
  return (H * (sp + 2) + 2 * H * sp + 3 * (size_t)H * H + (size_t)H * C) * sizeof(float) +
         (sp + 2) * sizeof(int);
}

int mr_ctc2d_alpha_launch(const float* emit, const float* trans, const float* init,
                          const int* logit_lengths, const int* labels, const int* label_lengths,
                          int B, int T, int H, int C, int L, int blank, float* alpha, float* nll,
                          void* stream) {
  ctc2d_alpha_kernel<<<B, H * padded_states(L), alpha_smem(H, L), (cudaStream_t)stream>>>(
      emit, trans, init, logit_lengths, labels, label_lengths, T, H, C, L, blank, alpha, nll);
  return (int)cudaGetLastError();
}

int mr_ctc2d_beta_launch(const float* emit, const float* trans, const int* logit_lengths,
                         const int* labels, const int* label_lengths, int B, int T, int H, int C,
                         int L, int blank, const float* alpha, const float* nll,
                         const float* grad_nll, float* grad_emit, float* grad_trans,
                         void* stream) {
  ctc2d_beta_kernel<<<B, H * padded_states(L), mr_ctc2d_beta_smem(H, L, C),
                      (cudaStream_t)stream>>>(emit, trans, logit_lengths, labels, label_lengths,
                                              T, H, C, L, blank, alpha, nll, grad_nll, grad_emit,
                                              grad_trans);
  return (int)cudaGetLastError();
}

}  // extern "C"
