#!/usr/bin/env python3
"""Where the CUDA connected-components kernel spends its time, on one NVIDIA GPU.

    python3 scripts/ccl_probe.py [--parent DIR]

Prints, with the card's name and power limit:

1. the cost of one cooperative-groups grid barrier at the kernel's grid
   (a kernel of 1 and of 101 ``grid.sync()``, CUDA events);
2. the latency of one L2 hit (one thread chasing a random permutation of
   128-byte lines through 13 MB, ``ld.global.cg``; cycles by ``clock64``,
   ns by ``%globaltimer``);
3. the time of each phase of each sweep of ``megreader_tpu_torch/csrc/ccl.cu``
   at ``chip_smoke.py``'s serving masks (8x640x640, cap 24) and at its
   serpentine page alone: a copy of the kernel with a ``%globaltimer`` stamp
   after every grid barrier (block 0, thread 0), built into ``build/probe/``;
4. with ``--parent DIR`` (another checkout of the repo, e.g. unpacked with
   ``git archive``): the serving batch of ``chip_smoke.py``'s phase e2e
   (8x640x640 pages, K 32, cap 24) for each ``extract_impl`` of 'xla' and
   'pallas_full', in the order parent, this tree, this tree, parent, each in
   its own process: batch ms by CUDA events and kernel-busy, and the ``ccl``
   stage's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from megreader_tpu_torch import kernels  # noqa: E402

OUT = ROOT / "build" / "probe"

STAMPS = r'''
__device__ long long g_t[4096];
__device__ int g_n;
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP if (blockIdx.x == 0 && threadIdx.x == 0 && g_n < 4096) g_t[g_n++] = gtime();
extern "C" int probe_read(long long* out, int* n) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(n, g_n, sizeof(int));
  cudaMemcpyFromSymbol(out, g_t, sizeof(long long) * 4096);
  int z = 0;
  return (int)cudaMemcpyToSymbol(g_n, &z, sizeof(int));
}
'''

MICRO = r'''
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void bar_kernel(int k, int* x) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < k; ++i) g.sync();
  if (!threadIdx.x && !blockIdx.x) x[0] = k;
}
extern "C" int bar_launch(int grid, int threads, int k, void* x, void* stream) {
  void* args[] = {&k, &x};
  return (int)cudaLaunchCooperativeKernel((const void*)bar_kernel, dim3(grid), dim3(threads),
                                          args, 0, (cudaStream_t)stream);
}
__global__ void chase(const int* nxt, int steps, long long* out) {
  int i = 0;
  long long t0 = clock64(), g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  for (int s = 0; s < steps; ++s) i = __ldcg(nxt + i);
  long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = t1 - t0;
  out[1] = g1 - g0;
  out[2] = i;
}
extern "C" int chase_launch(const void* nxt, int steps, void* out) {
  chase<<<1, 1>>>((const int*)nxt, steps, (long long*)out);
  return (int)cudaDeviceSynchronize();
}
'''


def build(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(source)
    lib = OUT / f"lib{name}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def probe_micro(grid: int) -> None:
    lib = build("micro", MICRO)
    bar = lib.bar_launch
    bar.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    x = torch.zeros(1, dtype=torch.int32, device="cuda")
    t = {k: cs.cuda_ms(lambda: bar(grid, 256, k, x.data_ptr(), stream()), reps=30)
         for k in (1, 101)}
    print(f"grid barrier at {grid} blocks of 256: {(t[101] - t[1]) / 100 * 1e3:.3f} us a "
          f"barrier (CUDA events, 101 vs 1 barriers)", flush=True)
    chase = lib.chase_launch
    chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    n = 13 * 1024 * 1024 // 4
    perm = np.random.default_rng(0).permutation(n // 32) * 32  # one load per 128-B line
    nxt = np.zeros(n, np.int32)
    nxt[perm] = np.roll(perm, -1)
    d = torch.from_numpy(nxt).cuda()
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    chase(d.data_ptr(), 2000, out.data_ptr())  # bring the lines into L2
    chase(d.data_ptr(), 20000, out.data_ptr())
    cycles, ns, _ = out.tolist()
    print(f"L2 hit (13 MB, ld.global.cg): {cycles / 20000:.1f} cycles, {ns / 20000:.1f} ns; "
          f"SM clock {cycles / ns:.3f} GHz", flush=True)


def probe_phases() -> None:
    text = (kernels.CSRC / "ccl.cu").read_text()
    text = text.replace("namespace cg = cooperative_groups;",
                        "namespace cg = cooperative_groups;\n" + STAMPS)
    text = text.replace("cg::grid_group grid = cg::this_grid();",
                        "cg::grid_group grid = cg::this_grid();\n  STAMP")
    text = text.replace("grid.sync();", "grid.sync(); STAMP")
    lib = build("ccl_stamped", text)
    fn = lib.mr_ccl_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    size = lib.mr_ccl_scratch_size
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_int64
    buf = (ctypes.c_longlong * 4096)()
    count = ctypes.c_int()
    main = cs.ccl_cases(np.random.default_rng(cs.SEED))["serving 8x640x640"]
    for label, m in (("serving 8x640x640", main), ("serpentine alone", main[6:7].copy())):
        mask = torch.from_numpy(m).cuda()
        B, H, W = mask.shape
        labels = torch.empty((B, H, W), dtype=torch.int32, device="cuda")
        scratch = torch.empty(size(B), dtype=torch.int32, device="cuda")

        def run():
            err = fn(mask.data_ptr(), labels.data_ptr(), scratch.data_ptr(), B, H, W, 24, stream())
            kernels.check(err, "stamped ccl kernel")

        for _ in range(3):
            run()
        lib.probe_read(buf, ctypes.byref(count))
        run()
        lib.probe_read(buf, ctypes.byref(count))
        t = [buf[i] for i in range(count.value)]
        d = [round((t[i + 1] - t[i]) / 1e3, 2) for i in range(len(t) - 1)]
        print(f"ccl phases, {label}, cap 24 (us, barrier included): set-up {d[0]}; "
              f"(row, column) per sweep {list(zip(d[1::2], d[2::2]))}; "
              f"total {(t[-1] - t[0]) / 1e3:.1f} us", flush=True)


def serving_batch(root: str) -> None:
    """One tree's serving batch; runs in its own process, from that tree."""
    os.chdir(root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("megreader_tpu_torch") or m == "chip_smoke"]:
        del sys.modules[name]
    import chip_smoke as tree
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(tree.SEED + 1)
    det = SegDetector(device="cuda")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    tree.seeded_weights(det.net, tree.SEED + 2)
    tree.seeded_weights(rec.net, tree.SEED + 3)
    pages = torch.from_numpy(tree.make_pages(rng, 8, 640, 640)).cuda()
    out = {"tree": root}
    for i, impl in enumerate(("xla", "pallas_full")):
        pipe = E2EPipeline(det, rec, max_regions=32, rectify="perspective", ccl_iters=24,
                           box_thresh=0.3, device="cuda", extract_impl=impl)
        if i == 0:
            tree.calibrate_prob_head(pipe, det.net, pages)
        with torch.no_grad():
            prob = pipe.detect(det.net, pages)

            def batch():
                return pipe.run(None, None, pages)

            def label():
                return pipe.label(prob)

            row = {"run_ms": tree.cuda_ms(batch, reps=20), "run_busy_ms": tree.device_busy_ms(batch),
                   "ccl_ms": tree.cuda_ms(label, reps=20),
                   "ccl_busy_ms": tree.device_busy_ms(label, reps=10)}
        row["pages_per_s"] = 8 / row["run_ms"] * 1e3
        out[impl] = row
    print("serving " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to compare the serving batch with")
    ap.add_argument("--serving-batch", help=argparse.SUPPRESS)  # one tree, in a child process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ccl_probe: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if args.serving_batch:
        serving_batch(args.serving_batch)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from megreader_tpu_torch.ops.ccl import connected_components_cuda_config

    cfg = connected_components_cuda_config(8, 640, 640)
    print(f"ccl launch at 8x640x640: {cfg}", flush=True)
    probe_micro(cfg["grid"])
    probe_phases()
    if args.parent:
        for root in (args.parent, str(ROOT), str(ROOT), args.parent):
            subprocess.run([sys.executable, "-u", __file__, "--serving-batch",
                            os.path.abspath(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
