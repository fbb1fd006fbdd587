#!/usr/bin/env python3
"""The CUDA extraction wrappers (``ops/extract.py``) timed on one NVIDIA GPU.

    python3 scripts/extract_probe.py [--parent DIR]

At phase extract's serving shape (8 CCL-labelled 640x640 pages, K 32), for this
tree and with ``--parent`` another checkout (parent, this, this, parent; a process
each): each wrapper by CUDA events, device us by operation, host us a call."""

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


def one_tree(root: str) -> None:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to compare the wrappers with")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one tree, in a child process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("extract_probe: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    if args.tree:
        one_tree(args.tree)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = [os.path.abspath(args.parent)] if args.parent else []
    for root in parent + [ROOT] + ([ROOT] + parent if parent else []):
        subprocess.run([sys.executable, "-u", __file__, "--tree", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
