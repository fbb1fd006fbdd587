#!/usr/bin/env python3
"""The CUDA extraction wrappers (``ops/extract.py``) timed on one NVIDIA GPU.

    python3 scripts/extract_probe.py [--parent DIR] [--stamps]

At phase extract's serving shape (8 CCL-labelled 640x640 pages, K 32), for this
tree and with ``--parent`` another checkout (parent, this, this, parent; a process
each): each wrapper by CUDA events, device us by operation, host us a call.

``--stamps`` then builds a copy of this tree's ``csrc/extract.cu`` into
``build/probe/`` with its ``EXTRACT_STAMP(kernel, tag)`` hooks recording
``%globaltimer`` from lane 0 of every warp, runs each wrapper once through it,
and prints, for each stamped kernel (0 rank, 1 areas, 2 extents), the span of
its blocks, their lifetimes and each tag's time from the block's start
(median, p90, max), the slowest blocks by page and tile, and the most blocks
that ran at once."""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_tree(root: str, with_stamps: bool = False) -> None:
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as tree
    from megreader_tpu_torch.ops import ccl, extract as ex

    rng = np.random.default_rng(tree.SEED + 17)
    m = tree.extract_masks(rng, 8, 640, 640)
    labels = ccl.connected_components_cuda(torch.from_numpy(m).cuda(), 24)
    scores = torch.from_numpy(rng.random(m.shape, dtype=np.float32)).cuda()
    K2 = ex.pallas_k2(32)
    area, roots, _ = ccl._top_k_slots(*ex.candidates_reference(labels, K2), 32)
    roots, a = roots.to(torch.int32).contiguous(), area.clamp(min=1.0)
    M = ex.moments_reference(labels, scores, roots)
    theta = 0.5 * torch.atan2(2.0 * M[..., 6] / a, (M[..., 4] - M[..., 5]) / a)
    params = torch.stack([M[..., 2] / a, M[..., 3] / a, theta.cos(), theta.sin()], 2).contiguous()
    if with_stamps:
        stamps(root, labels, scores, roots, params, K2)
        return
    out = {"tree": root}
    for name, fn in (("candidates", lambda: ex.candidates_cuda(labels, K2)),
                     ("moments", lambda: ex.moments_cuda(labels, scores, roots)),
                     ("extents", lambda: ex.extents_cuda(labels, roots, params))):
        out[name] = row = {"ms": tree.cuda_ms(fn, reps=100)}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        ops = {e.key[:60]: e.self_device_time_total / 20 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        row.update(device_us_by_op=ops, busy_ms=sum(ops.values()) / 1e3)
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        row["host_us_per_call"] = (time.perf_counter() - t0) / 1000 * 1e6
        torch.cuda.synchronize()
    print("tree " + json.dumps(out), flush=True)


STAMP_WORDS = 48  # a block: 5 tags x 8 warps, then its SM at word 40
STAMP_HEAD = r"""
#include <cuda_runtime.h>
__device__ unsigned long long* g_extract_stamps;
__device__ int g_extract_stamp_blocks;
#define EXTRACT_STAMP(kernel, tag)                                                        \
  do {                                                                                    \
    if ((threadIdx.x & 31) == 0) {                                                        \
      unsigned long long t_;                                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                              \
      const long long blk_ = blockIdx.x + (long long)gridDim.x * blockIdx.y;              \
      if (blk_ < g_extract_stamp_blocks) {                                                \
        unsigned long long* s_ =                                                          \
            g_extract_stamps + ((long long)(kernel) * g_extract_stamp_blocks + blk_) * 48; \
        s_[(tag) * 8 + (threadIdx.x >> 5)] = t_;                                          \
        if ((tag) == 0 && threadIdx.x == 0) {                                             \
          unsigned sm_;                                                                   \
          asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                                \
          s_[40] = sm_;                                                                   \
        }                                                                                 \
      }                                                                                   \
    }                                                                                     \
  } while (0)
"""
STAMP_TAIL = r"""
extern "C" int mr_probe_set_stamps(void* p, int blocks) {
  cudaMemcpyToSymbol(g_extract_stamps, &p, sizeof(p));
  cudaMemcpyToSymbol(g_extract_stamp_blocks, &blocks, sizeof(blocks));
  return (int)cudaGetLastError();
}
"""


def summarize_stamps(st: np.ndarray, per_page: int) -> dict:
    """One kernel's stamps (blocks, 48) in ns -> block lifetimes and tag times."""
    st = st[st[:, 0] > 0]
    if not len(st):
        return {}
    tags = st[:, :40].reshape(len(st), 5, 8).astype(np.float64)
    warp0 = tags[:, :, 0]
    start = warp0[:, 0]
    last_tag = max(t for t in range(5) if (warp0[:, t] > 0).all())
    end = warp0[:, last_tag]
    life = (end - start) / 1e3

    def q(v):
        return {"p50": float(np.median(v)), "p90": float(np.percentile(v, 90)),
                "max": float(v.max())}

    out = {"blocks": len(st), "span_us": float((end.max() - start.min()) / 1e3),
           "life_us": q(life)}
    for t in range(1, last_tag + 1):
        live = np.where(tags[:, t] > 0, tags[:, t], np.nan)
        out[f"tag{t}_us"] = q((np.nanmax(live, 1) - start) / 1e3)
    events = np.concatenate([np.stack([start, np.ones_like(start)], 1),
                             np.stack([end, -np.ones_like(end)], 1)])
    out["most_at_once"] = int(np.cumsum(events[np.lexsort((events[:, 1], events[:, 0]))][:, 1]).max())
    blk = np.flatnonzero(st[:, 0] > 0)
    slow = np.argsort(-life)[:5]
    out["slowest"] = [{"page": int(blk[i] // per_page), "tile": int(blk[i] % per_page),
                       "sm": int(st[i, 40]), "life_us": float(life[i])} for i in slow]
    out["page_max_life_us"] = {}
    for page in range(int(blk.max() // per_page) + 1):
        sel = blk // per_page == page
        if sel.any():
            out["page_max_life_us"][page] = float(life[sel].max())
    return out


def stamps(root: str, labels, scores, roots, params, K2) -> None:
    """Build the stamped copy of csrc/extract.cu, run each wrapper once
    through it and print the stamps' summary."""
    import ctypes
    from megreader_tpu_torch import kernels
    from megreader_tpu_torch.ops import extract as ex

    src = (kernels.CSRC / "extract.cu").read_text()
    out_dir = os.path.join(root, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "extract_stamped.cu"), os.path.join(out_dir, "extract_stamped.so")
    with open(cu, "w") as f:
        f.write(STAMP_HEAD + src + STAMP_TAIL)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for name, (argtypes, restype) in ex._PROTOTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), restype
        fns[name] = fn
    lib.mr_probe_set_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels._bound["extract"] = fns
    B, H, W = labels.shape
    blocks = 8192
    buf = torch.zeros((3, blocks, STAMP_WORDS), dtype=torch.int64, device="cuda")
    assert lib.mr_probe_set_stamps(buf.data_ptr(), blocks) == 0
    rows = 4096 // W if W < 4096 else 1
    tiles = -(-H * W // 4096)
    per_page = {0: tiles, 1: tiles, 2: -(-H // rows)}
    for name, fn in (("candidates", lambda: ex.candidates_cuda(labels, K2)),
                     ("extents", lambda: ex.extents_cuda(labels, roots, params))):
        fn()
        torch.cuda.synchronize()
        buf.zero_()
        fn()
        torch.cuda.synchronize()
        st = buf.cpu().numpy()
        for kid in ((0, 1) if name == "candidates" else (2,)):
            print("stamps " + json.dumps({"kernel": kid, "wrapper": name,
                                          **summarize_stamps(st[kid], per_page[kid])}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to compare the wrappers with")
    ap.add_argument("--stamps", action="store_true",
                    help="then the stamped kernels' block times (this tree)")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one tree, in a child process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("extract_probe: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if args.tree:
        one_tree(args.tree, args.stamps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = [os.path.abspath(args.parent)] if args.parent else []
    for root in parent + [ROOT] + ([ROOT] + parent if parent else []):
        subprocess.run([sys.executable, "-u", __file__, "--tree", root], check=True)
    if args.stamps:
        subprocess.run([sys.executable, "-u", __file__, "--tree", ROOT, "--stamps"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
