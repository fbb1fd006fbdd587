#!/usr/bin/env python3
"""Where the CUDA CTC kernels (``csrc/ctc.cu``) spend their time, on one NVIDIA GPU.

    python3 scripts/ctc_probe.py [--parent DIR]

Prints, with the card's name and power limit:

1. unit costs on one SM, in cycles (``clock64``): a ``__syncthreads`` of a
   block of 96 threads (the old kernels' block at L 32), one accurate
   guarded logsumexp of three values (``logf``/``expf`` behind a jump) and one
   branch-free fast one (``ex2.approx``/``lg2.approx``) in a dependent chain,
   a shared-memory ``atomicAdd`` from a warp whose 16 even lanes hit one
   address (the blank's collision in one warp), from a block of 96 threads
   whose 48 even threads hit one address, and on 32 addresses, and a
   dependent ``__shfl_up_sync``;
2. for this tree (and, with ``--parent DIR``, another checkout of the repo,
   e.g. unpacked with ``git archive``, in the order parent, this tree, this
   tree, parent, each in its own process), at config #1's training shape
   (B 64, T 25, C 37, labels padded to 32; ``chip_smoke.ctc_inputs``):
   - each wrapper call (``ctc_alpha_cuda``, ``ctc_beta_cuda``) by CUDA
     events (median of 100) and its kernel-busy time (``torch.profiler``);
   - the host time of one wrapper call with the card idle: ``perf_counter``
     over 1,000 calls, then one synchronise;
   - a copy of that tree's ``csrc/ctc.cu`` with ``%globaltimer`` and
     ``clock64`` stamps, built into ``build/probe/``: per step of the chain
     for sequence 1 (25 steps, 6 labels with repeats: one column of states)
     and sequence 3 (32 labels: three columns, no alignment, so the beta
     kernel takes its early path), with each stamp's tag. The current
     kernels carry ``CTC_STAMP(tag)`` hooks (tag 0 the kernel's start, 2
     the chain's start after staging, 1 a step of the chain, 3 the beta
     chain's end, 4 the gradient pass's start, 9 alpha's chain end or
     beta's end, 10 alpha's last barrier, 11 its end); in a source without
     hooks (before the redesign) a stamp goes at each step's head (tag 1)
     and after the n-th ``__syncthreads`` (tag 10 + n).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from ctc2d_probe import build, summarize  # noqa: E402  (this script's directory)

PROBE_BLOCKS = (1, 3)

# A stamp per call by thread 0 of the two probed blocks; the count lives in
# shared memory, so that stamps in device functions share it.
STAMPS = r'''
#define PROBE_B0 %d
#define PROBE_B1 %d
__device__ long long g_t[2][1024];
__device__ long long g_c[2][1024];
__device__ int g_id[2][1024];
__device__ int g_n[2];
__shared__ int probe_n;
__device__ __forceinline__ void probe_stamp(int id) {
  if (threadIdx.x != 0) return;
  const int slot = blockIdx.x == PROBE_B0 ? 0 : (blockIdx.x == PROBE_B1 ? 1 : -1);
  const int n = probe_n;
  if (slot < 0 || n >= 1024) return;
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  g_t[slot][n] = t;
  g_c[slot][n] = clock64();
  g_id[slot][n] = id;
  g_n[slot] = n + 1;
  probe_n = n + 1;
}
#define CTC_STAMP_INIT if (threadIdx.x == 0) probe_n = 0;
#define CTC_STAMP(id) probe_stamp(id);
extern "C" int probe_read(long long* t, long long* c, int* id, int* n) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(n, g_n, sizeof(int) * 2);
  cudaMemcpyFromSymbol(t, g_t, sizeof(long long) * 2048);
  cudaMemcpyFromSymbol(c, g_c, sizeof(long long) * 2048);
  cudaMemcpyFromSymbol(id, g_id, sizeof(int) * 2048);
  int z[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_n, z, sizeof(int) * 2);
}
''' % PROBE_BLOCKS

MICRO = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= -5e29f) return -1e30f;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}
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
__device__ __forceinline__ float lse3_fast(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float r = m + flog(fexp(a - m) + fexp(b - m) + fexp(c - m));
  return m <= -5e29f ? -1e30f : r;
}
__global__ void micro(int n, float seed, long long* out) {
  __shared__ float acc[96];
  const int i = threadIdx.x;
  acc[i] = 0.f;
  __syncthreads();
  long long t0 = clock64();
  for (int k = 0; k < n; ++k) __syncthreads();
  long long t1 = clock64();
  if (i == 0) out[0] = t1 - t0;
  t0 = clock64();
  for (int k = 0; k < n; ++k) atomicAdd(&acc[(i & 1) ? i : 0], 1.f);  // 48 threads on acc[0]
  __syncthreads();
  t1 = clock64();
  if (i == 0) out[6] = t1 - t0;
  if (i < 32) {
    float x = seed + i;
    t0 = clock64();
    for (int k = 0; k < n; ++k) x = lse3(x, 0.5f * x, x - 1.f);
    t1 = clock64();
    if (i == 0) { out[1] = t1 - t0; out[7] = __float_as_int(x); }
    x = seed + i;
    t0 = clock64();
    for (int k = 0; k < n; ++k) x = lse3_fast(x, 0.5f * x, x - 1.f);
    t1 = clock64();
    if (i == 0) { out[2] = t1 - t0; out[8] = __float_as_int(x); }
    t0 = clock64();
    for (int k = 0; k < n; ++k) atomicAdd(&acc[(i & 1) ? i : 0], 1.f);  // 16 lanes on acc[0]
    __syncwarp();
    t1 = clock64();
    if (i == 0) out[3] = t1 - t0;
    t0 = clock64();
    for (int k = 0; k < n; ++k) atomicAdd(&acc[i], 1.f);
    __syncwarp();
    t1 = clock64();
    if (i == 0) out[4] = t1 - t0;
    x = seed + i;
    t0 = clock64();
    for (int k = 0; k < n; ++k) x = __shfl_up_sync(0xffffffffu, x, 1) + 1.f;
    t1 = clock64();
    if (i == 0) { out[5] = t1 - t0; out[9] = __float_as_int(x + acc[0]); }
  }
}
extern "C" int micro_launch(int n, void* out) {
  micro<<<1, 96>>>(n, 0.25f, (long long*)out);
  return (int)cudaDeviceSynchronize();
}
'''


def probe_micro() -> None:
    from megreader_tpu_torch import kernels

    lib = build("ctc_micro", MICRO, kernels._nvcc(), kernels.NVCC_FLAGS)
    fn = lib.micro_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(10, dtype=torch.int64, device="cuda")
    n = 1000
    fn(n, out.data_ptr())
    kernels.check(fn(n, out.data_ptr()), "micro kernel")
    c = out.tolist()
    print("unit costs (cycles, clock64, one block on one SM): __syncthreads at 96 threads "
          f"{c[0] / n:.1f}; dependent guarded logsumexp3 accurate {c[1] / n:.1f}, fast "
          f"branch-free {c[2] / n:.1f}; shared atomicAdd of a warp with 16 lanes on one "
          f"address {c[3] / n:.1f}, of 96 threads with 48 on one address {c[6] / n:.1f}, "
          f"on 32 addresses {c[4] / n:.1f}; dependent __shfl_up_sync + add {c[5] / n:.1f}",
          flush=True)


def stamped_source(text: str) -> str:
    """The source with stamps: its own hooks, or a stamp at each step's head
    and after each ``__syncthreads`` where it has none."""
    if "CTC_STAMP(" not in text:
        text = text.replace("extern __shared__ float smem[];",
                            "extern __shared__ float smem[];\n  CTC_STAMP_INIT")
        for head in ("for (int t = 1; t < len; ++t) {", "for (int t = t_last; t >= 0; --t) {"):
            text = text.replace(head, head + " CTC_STAMP(1)")
        parts = text.split("__syncthreads();")
        text = parts[0] + "".join(f"__syncthreads(); CTC_STAMP({10 + n})" + p
                                  for n, p in enumerate(parts[1:]))
    return STAMPS + text


def one_tree(root: str) -> None:
    """This tree's wrapper times and per-step stamps, from that tree's code."""
    os.chdir(root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("megreader_tpu_torch") or m == "chip_smoke"]:
        del sys.modules[name]
    import chip_smoke as tree
    import torch.nn.functional as F
    from megreader_tpu_torch import kernels
    from megreader_tpu_torch.ops import ctc

    B, T, C, L = 64, 25, 37, 32
    rng = np.random.default_rng(tree.SEED + 4)
    logits, ll, lb, lbl, _ = tree.ctc_inputs(rng, B, T, C, L)
    lp = F.log_softmax(torch.from_numpy(logits).cuda(), -1).contiguous()
    ll, lb, lbl = (torch.from_numpy(a).cuda() for a in (ll, lb, lbl))
    ones = torch.ones(B, device="cuda")
    nll, alpha = ctc.ctc_alpha_cuda(lp, ll, lb, lbl)

    def fwd():
        return ctc.ctc_alpha_cuda(lp, ll, lb, lbl)

    def bwd():
        return ctc.ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones)

    out = {"tree": root}
    for name, fn in (("alpha", fwd), ("beta", bwd)):
        row = {"ms": tree.cuda_ms(fn, reps=100), "busy_ms": tree.device_busy_ms(fn, reps=20)}
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        row["host_us_per_call"] = (t1 - t0) / 1000 * 1e6
        out[name] = row

    tag = "parent" if Path(root).resolve() != ROOT else "this"
    lib = build(f"ctc_stamped_{tag}", stamped_source((kernels.CSRC / "ctc.cu").read_text()),
                kernels._nvcc(), kernels.NVCC_FLAGS)
    kernels._loaded["ctc"] = lib
    getattr(kernels, "_bound", {}).pop("ctc", None)  # bind the stamped copy's functions
    read = lib.probe_read
    read.argtypes = [ctypes.c_void_p] * 4
    t = (ctypes.c_longlong * 2048)()
    c = (ctypes.c_longlong * 2048)()
    ids = (ctypes.c_int * 2048)()
    n = (ctypes.c_int * 2)()
    nll, alpha = fwd()  # the stamped library's own forward, warm-up
    bwd()
    read(t, c, ids, n)
    for name, fn in (("alpha", fwd), ("beta", bwd)):
        fn()
        read(t, c, ids, n)
        for slot, b in enumerate(PROBE_BLOCKS):
            k = n[slot]
            rows = [t[slot * 1024 + i] for i in range(k)]
            cyc = [c[slot * 1024 + i] for i in range(k)]
            tags = [ids[slot * 1024 + i] for i in range(k)]
            out[name][f"stamps_seq{b}"] = summarize(rows, cyc, tags)
    print("tree " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to compare the kernels with")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one tree, in a child process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ctc_probe: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if args.tree:
        one_tree(args.tree)
        return 0
    sys.path.insert(0, str(ROOT))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    probe_micro()
    trees = [str(ROOT)]
    if args.parent:
        trees = [os.path.abspath(args.parent), str(ROOT), str(ROOT), os.path.abspath(args.parent)]
    for root in trees:
        subprocess.run([sys.executable, "-u", __file__, "--tree", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
