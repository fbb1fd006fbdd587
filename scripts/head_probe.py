#!/usr/bin/env python3
"""Where the detector's map head spends its time, on one NVIDIA GPU.

    python3 scripts/head_probe.py [--root DIR] [--reps N] [--tag NAME] [--asset]

Imports ``megreader_tpu_torch`` from ``--root`` (default: this checkout;
another checkout, e.g. unpacked with ``git archive``, compares two trees:
run the script once per tree, in turns). Builds the prob head
(``models/detector.py::MapHead``, 256 -> 64 channels) with seeded random
weights and non-identity BatchNorm statistics on a seeded (8, 256, 160, 160)
input, channels-last, the head's input at the serving shape (8 pages of
640x640; the trunk hands it on channels-last), or with
``--asset`` the trained asset's prob head on its FPN feature of 8 TextPages
(as ``chip_smoke.py``'s phase head takes them), and for
the plain head (``fused_upsample=False``) and the default one prints, with
the card's name and power limit:

- eval forward in float32 and under the bf16 serving cast, train forward +
  backward in float32 and in mixed bf16 (``compute_dtype`` bf16);
- ms by CUDA events (median of ``--reps``), the host's ms to issue one call
  (``perf_counter`` around 20 calls without a synchronise, the card idle
  before them, so a queue that drains faster than the host issues reads as
  host time), kernel-busy ms (``torch.profiler``, mean of 3; null where the
  trace holds no device time or more than the events), the number of aten
  ops one call dispatches, the kernel records and kernel-launch calls of
  the trace per call, the 8 device kernels with the most time and the 8
  host ops with the most self time.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def cuda_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, calls: int = 20) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def aten_ops(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def busy_and_top(fn, events_ms: float, reps: int = 3):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    kernels = sum(e.count for e in dev if not e.key.startswith(("Memcpy", "Memset"))) // reps
    launches = sum(e.count for e in cpu
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))) // reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    host = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]
    return (busy if 0 < busy <= events_ms else None, kernels, launches,
            [[e.key[:90], round(e.self_device_time_total / 1e3 / reps, 4), e.count // reps]
             for e in top],
            [[e.key[:90], round(e.self_cpu_time_total / 1e3 / reps, 4), e.count // reps]
             for e in host])


def asset_input():
    """The prob head's input and weights as ``chip_smoke.py``'s phase head
    takes them: the trained asset's FPN feature of 8 TextPages of 640x640
    (seed 5) and its prob head's state."""
    import numpy as np
    import torch

    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.ops.image import normalize

    det = SegDetector(device="cuda")
    load_flax_variables(det.net, load_flax_msgpack(chip_smoke.ASSET)[0])
    data = chip_smoke.TextPages(8, 5, (640, 640))
    pages = torch.from_numpy(np.stack([data[i]["image"] for i in range(8)]).astype(
        np.float32)).cuda()
    with torch.no_grad():
        x = det.net.fpn(det.net.backbone(normalize(pages).permute(0, 3, 1, 2)))
    return x, det.net.prob_head.state_dict()


def run(root: str, reps: int, tag: str, asset: bool) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from megreader_tpu_torch.models.detector import MapHead
    from megreader_tpu_torch.ops.precision import cast_floats

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = None
    if asset:
        x, state = asset_input()
    else:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((8, 256, 160, 160), np.float32)).cuda()
        # channels-last, as the trunk hands the feature on (pages come NHWC)
        x = x.contiguous(memory_format=torch.channels_last)

    def head(fused: bool, dtype=None):
        h = MapHead(256, 64, dtype, fused_upsample=fused)
        if state is not None:
            h.load_state_dict(state)
            return h.cuda()
        g = np.random.default_rng(1)
        with torch.no_grad():
            for name, p in h.state_dict().items():
                if name.endswith("running_var"):
                    p.copy_(torch.from_numpy(g.uniform(0.5, 1.5, p.shape).astype(np.float32)))
                elif p.dtype.is_floating_point:
                    scale = 1.0 if "bn" in name else (2.0 / np.prod(p.shape[1:])) ** 0.5
                    p.copy_(torch.from_numpy((scale * g.standard_normal(p.shape)).astype(
                        np.float32)) + (1.0 if name.endswith("bn.weight") else 0.0))
        return h.cuda()

    out = {}
    for fused in (False, True):
        name = "default" if fused else "plain"
        cases = {}
        h = head(fused).eval()
        cases["eval float32"] = (lambda h=h: h(x), True)
        hb = cast_floats(copy.deepcopy(h))
        xb = x.to(torch.bfloat16)
        cases["eval bf16"] = (lambda h=hb: h(xb), True)
        ht = head(fused).train()
        cases["train float32"] = (lambda h=ht: h(x).sum().backward(), False)
        hm = head(fused, torch.bfloat16).train()
        cases["train bf16 mixed"] = (lambda h=hm: h(x).sum().backward(), False)
        for case, (fn, nograd) in cases.items():
            ctx = torch.no_grad() if nograd else torch.enable_grad()
            with ctx:
                ms = cuda_ms(fn, reps)
                busy, kernels, launches, top, host = busy_and_top(fn, ms)
                out.setdefault(case, {})[name] = {
                    "ms": ms, "host_ms": host_ms(fn), "busy_ms": busy, "aten_ops": aten_ops(fn),
                    "kernels": kernels, "launch_calls": launches, "top": top, "host": host}
        del h, hb, ht, hm
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"head probe [{card.strip()}] tree {tag} ({root}), "
          f"{'the asset on its FPN feature' if asset else 'random weights and input'}:")
    for case, forms in out.items():
        for name, r in forms.items():
            print(f"  {case} {name}: " + json.dumps(
                {k: v for k, v in r.items() if k not in ("top", "host")}))
            for row in r["top"]:
                print(f"      {row[1]:9.4f} ms x{row[2]:<4d} {row[0]}")
            for row in r["host"]:
                print(f"      host {row[1]:9.4f} ms x{row[2]:<4d} {row[0]}")
    sys.stdout.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--asset", action="store_true",
                    help="the trained asset's prob head on its FPN feature of 8 TextPages")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("head_probe: no CUDA device", file=sys.stderr)
        return 1
    run(str(Path(args.root).resolve()), args.reps, args.tag, args.asset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
