#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's page-serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. setup: print the card's name and power limit, build every CUDA kernel in
   ``megreader_tpu_torch/csrc`` with nvcc (one process per source, in
   parallel), turn TF32 off for the comparisons.
2. ccl: the CUDA connected-components kernel against its plain PyTorch
   version on the card, bit-exact, at the serving shape 8x640x640 with the
   sweep cap 24 (text-like rectangles, a serpentine that hits the cap, an
   empty page), then unaligned 641x637 pages and an empty/full pair. Times
   the kernel and the plain version with CUDA events, and computes the
   kernel's bound for this run's masks.
3. e2e: the full-width serving path (ResNet-18 det + FPN 256 + head 64;
   ResNet-18 rec + 2x BiLSTM 256, 37 classes) on seeded random weights, 8
   numpy-made pages of 640x640, through ``E2EPipeline.predict``. Checks finite
   outputs and shapes, that the CCL kernel ran once per batch, times each
   stage with CUDA events and its kernel-busy time with ``torch.profiler``
   (and the whole batch's device idle share), and holds every stage of the
   card's path against the same stage on the CPU (plain versions), on two
   128x128 crops and on one full 640x640 page with K = 32 slots.

Prints a JSON line of per-kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks at the 700 W limit. HBM3 bandwidth: NVIDIA data sheet. The
# kernel's compares, mins and selects are INT32 instructions: 132 SMs x 64
# INT32 lanes (16 per SM sub-partition, NVIDIA Hopper architecture white
# paper) x 1.98 GHz boost clock, one instruction per lane per cycle
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
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


def device_busy_ms(fn, reps: int = 3):
    """Milliseconds of kernel time per ``fn()`` on the card (sum over the
    device events of a ``torch.profiler`` trace), or None if the trace holds
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def text_masks(rng, B: int, H: int, W: int, n: int = 30) -> np.ndarray:
    """Word-like rotated rectangles, ``n`` per page."""
    out = np.zeros((B, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for b in range(B):
        for _ in range(n):
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            hw, hh = rng.uniform(15, 100), rng.uniform(4, 14)
            th = rng.uniform(-0.6, 0.6) if rng.random() < 0.5 else 0.0
            c, s = np.cos(th), np.sin(th)
            u = (xx - cx) * c + (yy - cy) * s
            v = -(xx - cx) * s + (yy - cy) * c
            out[b] |= (np.abs(u) <= hw) & (np.abs(v) <= hh)
    return out


def serpentine(H: int, W: int) -> np.ndarray:
    """One snake of 4-px rows joined at alternate ends: ~H/8 bends."""
    m = np.zeros((H, W), bool)
    for k, r in enumerate(range(4, H - 8, 8)):
        m[r:r + 4, 4:W - 4] = True
        c = slice(W - 8, W - 4) if k % 2 == 0 else slice(4, 8)
        m[r + 4:r + 8, c] = True
    return m


def phase_setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from megreader_tpu_torch import kernels

    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_ccl():
    from megreader_tpu_torch.ops.ccl import (
        connected_components_cuda,
        connected_components_reference,
    )

    rng = np.random.default_rng(SEED)
    B, H, W, cap = 8, 640, 640, 24
    main = text_masks(rng, B, H, W)
    main[6] = serpentine(H, W)
    main[7] = False
    unaligned = text_masks(rng, 2, 641, 637)
    unaligned[1] = rng.random((641, 637)) < 0.45
    edge = np.stack([np.zeros((H, W), bool), np.ones((H, W), bool)])

    max_err = 0
    sweeps = None
    for name, m in (("serving 8x640x640", main), ("unaligned 641x637", unaligned),
                    ("empty/full", edge)):
        mask = torch.from_numpy(m).cuda()
        got = connected_components_cuda(mask, cap)
        ref, sw = connected_components_reference(mask, cap, return_sweeps=True)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        log(f"ccl {name}: max |kernel - plain| = {err}, sweeps per page {sw.tolist()}")
        if not torch.equal(got, ref):
            raise AssertionError(f"ccl kernel disagrees with the plain version on {name}")
        max_err = max(max_err, err)
        if sweeps is None:
            sweeps = sw
    if int(sweeps[6]) != cap:
        raise AssertionError(f"the serpentine page ran {int(sweeps[6])} sweeps, not the cap {cap}")

    mask = torch.from_numpy(main).cuda()
    ms = cuda_ms(lambda: connected_components_cuda(mask, cap), reps=50)
    plain_ms = cuda_ms(lambda: connected_components_reference(mask, cap), reps=20)
    one_sweep_ms = cuda_ms(lambda: connected_components_cuda(mask, 1), reps=50)
    n = B * H * W
    bytes_moved = n * (1 + 4)  # mask read once, labels written once
    ops = int(sweeps.sum()) * H * W * 4 * 2  # 4 passes, compare + select per pixel
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    sweep_bytes = n * 4 * 8  # per sweep: 4 passes, each reads and writes labels
    log(f"ccl time: kernel {ms} ms, plain {plain_ms} ms, kernel capped at one sweep "
        f"{one_sweep_ms} ms (median, CUDA events)")
    log(f"ccl bound: bytes {bytes_moved} -> {bytes_ms:.5f} ms, ops {ops} -> {ops_ms:.5f} ms; "
        f"sweeps {sweeps.tolist()} (sum {int(sweeps.sum())}); multi-pass traffic "
        f"{sweep_bytes} B per sweep = {sweep_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms at HBM rate")
    return {
        "name": "ccl",
        "route": "cuda",
        "source": "megreader_tpu_torch/csrc/ccl.cu",
        "replaces": "megreader_tpu/ops/pallas_ccl.py:70",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def seeded_weights(module: torch.nn.Module, seed: int) -> None:
    """Fill every parameter and BN statistic from a numpy generator."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                a = rng.uniform(0.5, 1.5, t.shape)
            elif name.endswith("running_mean"):
                a = 0.05 * rng.standard_normal(t.shape)
            elif t.dim() == 1:
                base = 1.0 if name.endswith("weight") else 0.0  # BN scale
                a = base + 0.05 * rng.standard_normal(t.shape)
            else:
                fan_in = int(np.prod(t.shape[1:]))
                a = rng.standard_normal(t.shape) * np.sqrt(2.0 / fan_in)
            t.copy_(torch.from_numpy(a.astype(np.float32)))


def make_pages(rng, B: int, H: int, W: int) -> np.ndarray:
    """Light pages with dark word-like rectangles and a little noise."""
    words = text_masks(rng, B, H, W, n=25)
    pages = 220.0 + 20.0 * rng.standard_normal((B, H, W, 3))
    pages[words] = 40.0 + 20.0 * rng.standard_normal((int(words.sum()), 3))
    return np.clip(pages, 0, 255).astype(np.float32)


def calibrate_prob_head(pipe, det_net, pages) -> None:
    """Random weights give saturated prob maps. Rescale the head's last conv so
    that its logits on these pages have std 2 and 20% of the pixels lie above
    ``bin_thresh``: blobs for the CCL, margins for the comparisons."""
    up2 = det_net.prob_head.up2
    seen = []
    hook = up2.register_forward_hook(lambda mod, inp, out: seen.append(out))
    with torch.no_grad():
        pipe.detect(det_net, pages)
        hook.remove()
        z = seen[0][:, 0, ::4, ::4].reshape(-1)
        a = 2.0 / z.std()
        c = torch.logit(torch.tensor(pipe.bin_thresh)).item() - a * torch.quantile(z, 0.8)
        up2.weight.mul_(a)
        up2.bias.mul_(a).add_(c)
        frac = float((pipe.detect(det_net, pages) > pipe.bin_thresh).float().mean())
    log(f"prob head calibrated: logit scale {float(a):.4g}, foreground {frac:.3f}")


def cross_check(pipe, det_net, rec_net, pages_np, device="cuda") -> None:
    """Each stage of the path on ``device`` against the same stage on the CPU
    (plain versions), both fed the CPU's output of the stage before. Float
    tolerances are relative to the reference's magnitude (f32 sums in
    another order, TF32 off)."""
    det_cpu = copy.deepcopy(det_net).cpu()
    rec_cpu = copy.deepcopy(rec_net).cpu()
    pg = torch.from_numpy(pages_np)
    diffs = {}

    def compare(what, got, ref, tol):
        d = float((got.cpu() - ref).abs().max()) if ref.numel() else 0.0
        scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
        diffs[what] = d
        if not d <= tol * scale:
            raise AssertionError(f"e2e cross-check: {what} differs by {d} > {tol} x {scale}")

    with torch.no_grad():
        prob = pipe.detect(det_cpu, pg)
        compare("prob", pipe.detect(det_net, pg.to(device)), prob, 1e-3)
        labels = pipe.label(prob)
        if not torch.equal(pipe.label(prob.to(device)).cpu(), labels):
            raise AssertionError("e2e cross-check: labels differ")
        reg = pipe.regions(labels, prob)
        reg_d = pipe.regions(labels.to(device), prob.to(device))
        if not torch.equal(reg_d["valid"].cpu(), reg["valid"]):
            raise AssertionError("e2e cross-check: valid slots differ")
        found = reg["stats"]["valid"]
        if not found.any():
            raise AssertionError("e2e cross-check: no region in the input")
        compare("quads_px", reg_d["quads"][found.to(device)], reg["quads"][found], 1e-5)
        crops = pipe.crops(pg, reg)
        crops_d = pipe.crops(pg.to(device), {k: reg[k].to(device) for k in ("quads", "boxes")})
        keep = found.reshape(-1)
        compare("crops", crops_d[keep.to(device)], crops[keep], 1e-4)
        compare("logits", rec_net(crops[keep].to(device)), rec_cpu(crops[keep]), 1e-4)
    log(f"e2e cross-check ({device} vs CPU, pages {tuple(pg.shape)}, {int(found.sum())} "
        f"regions, {int(reg['valid'].sum())} valid): max abs diff " + json.dumps(diffs))


def phase_e2e():
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ccl import (
        connected_components_cuda,
        connected_components_reference,
    )
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    rng = np.random.default_rng(SEED + 1)
    det = SegDetector(device="cuda")
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(det.net, SEED + 2)
    seeded_weights(rec.net, SEED + 3)
    B, H, W = 8, 640, 640
    pages_np = make_pages(rng, B, H, W)
    pages = torch.from_numpy(pages_np).cuda()
    pipe = E2EPipeline(det, rec, max_regions=32, rectify="perspective", ccl_iters=24,
                       box_thresh=0.3, device="cuda")

    calibrate_prob_head(pipe, det.net, pages)
    cross_check(pipe, det.net, rec.net, pages_np[:2, :128, :128])
    cross_check(pipe, det.net, rec.net, pages_np[:1])  # one page at the timed size

    pipe.predict(None, None, pages)  # warm-up
    torch.cuda.synchronize()
    reps = 5
    connected_components_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        results = pipe.predict(None, None, pages)
    wall = time.perf_counter() - t0
    launches = connected_components_cuda.launches
    log(f"e2e: {reps} batches of {B} pages, ccl kernel launches {launches}, "
        f"{B * reps / wall:.2f} pages/s (host clock, predict incl. host decode)")
    if launches != reps:
        raise AssertionError(f"ccl kernel launched {launches} times for {reps} batches")

    out = pipe.run(None, None, pages)
    K = pipe.max_regions
    shapes = {"ids": (B, K, 25), "lengths": (B, K), "quads": (B, K, 4, 2),
              "boxes": (B, K, 4), "scores": (B, K), "valid": (B, K)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"e2e {key} shape {tuple(out[key].shape)} != {shape}")
    valid = out["valid"]
    for key in ("quads", "boxes", "scores"):
        if not torch.isfinite(out[key][valid]).all():
            raise AssertionError(f"e2e {key} not finite on valid slots")
    n_valid = int(valid.sum())
    if n_valid == 0:
        raise AssertionError("e2e found no valid region on any page")
    log(f"e2e: {n_valid} valid regions, first page texts {[r['text'] for r in results[0]][:8]}")

    # per-stage device time, CUDA events, stages fed the previous stage's output
    with torch.no_grad():
        prob = pipe.detect(det.net, pages)
        labels = pipe.label(prob)
        reg = pipe.regions(labels, prob)
        crops = pipe.crops(pages, reg)
        stages = {
            "detector": lambda: pipe.detect(det.net, pages),
            "ccl": lambda: pipe.label(prob),
            "extract": lambda: pipe.regions(labels, prob),
            "rectify": lambda: pipe.crops(pages, reg),
            "recognizer": lambda: pipe.recognize(rec.net, crops),
        }
        stage_ms = {k: cuda_ms(f, reps=10) for k, f in stages.items()}
        busy_ms = {k: device_busy_ms(f) for k, f in stages.items()}
        run_ms = cuda_ms(lambda: pipe.run(None, None, pages), reps=5)
        run_busy = device_busy_ms(lambda: pipe.run(None, None, pages))
        _, sweeps = connected_components_reference(prob > pipe.bin_thresh, pipe.ccl_iters,
                                                   return_sweeps=True)
    log(f"e2e ccl sweeps per page {sweeps.tolist()}")
    total = sum(stage_ms.values())
    log("e2e stage ms (median, CUDA events): " + json.dumps(stage_ms)
        + f", sum {total:.3f} ms = {B / total * 1e3:.2f} pages/s")
    log("e2e stage kernel-busy ms (torch.profiler device time, None = no device "
        "time in the trace): " + json.dumps(busy_ms))
    idle = "not measured" if run_busy is None else f"{1.0 - run_busy / run_ms:.4f}"
    log(f"e2e run: {run_ms} ms per batch of {B} (CUDA events) = {B / run_ms * 1e3:.2f} "
        f"pages/s; kernel-busy {run_busy} ms; device idle share {idle}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    phase_setup()
    ccl_row = phase_ccl()
    ccl_row["launches"] = phase_e2e()
    log(json.dumps({"kernels": [ccl_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
