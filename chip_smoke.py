#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: the page-serving
path and the training of the config-#1 recognizer.

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
3. ctc: the CUDA CTC kernels (alpha forward, beta backward) against the plain
   PyTorch version on the card at config #1's training shape (B 64, T 25,
   C 37, labels padded to 32): varied logit lengths, repeated labels, an
   empty label and rows without an alignment. Times the kernels, the plain
   version and ``torch.nn.functional.ctc_loss`` with CUDA events, and computes
   the kernels' bounds for this run's lengths.
4. e2e: the full-width serving path (ResNet-18 det + FPN 256 + head 64;
   ResNet-18 rec + 2x BiLSTM 256, 37 classes) on seeded random weights, 8
   numpy-made pages of 640x640, through ``E2EPipeline.predict``. Checks finite
   outputs and shapes, that the CCL kernel ran once per batch, times each
   stage with CUDA events and its kernel-busy time with ``torch.profiler``
   (and the whole batch's device idle share), and holds every stage of the
   card's path against the same stage on the CPU (plain versions), on two
   128x128 crops and on one full 640x640 page with K = 32 slots.
5. train: config #1 at full width (ResNet-18 rec + 2x BiLSTM 256, 37
   classes, batch 64, Adam at lr 1e-3 with 200 warm-up steps of a 20 000-step
   cosine) through ``Experiment``/``Trainer`` on a numpy-made dataset of 4
   batches for 24 steps: finite, falling losses, one launch of each CTC
   kernel per step, a checkpoint that resumes at its step. Then one step's
   loss and gradients through the kernels against the plain loss, and the
   time of a step split into prepare, forward, CTC forward, backward and
   optimizer (CUDA events), with the device idle share (``torch.profiler``).

Prints a JSON line of per-kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks at the 700 W limit. HBM3 bandwidth: NVIDIA data sheet. The
# kernel's compares, mins and selects are INT32 instructions: 132 SMs x 64
# INT32 lanes (16 per SM sub-partition, NVIDIA Hopper architecture white
# paper) x 1.98 GHz boost clock, one instruction per lane per cycle
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 outside the tensor cores (the guide's table), for the CTC kernels'
# logsumexp arithmetic
FP32_OPS_PER_S = 67e12
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


def ctc_inputs(rng, B: int = 64, T: int = 25, C: int = 37, L: int = 32):
    """Config #1's training shape with every case the kernels must cover:
    word-like label lengths 1-12, varied logit lengths, repeated labels, an
    empty label, and rows without an alignment (a label of 32, and 14 copies
    of one class, which need 27 steps). Returns numpy (logits, logit_lengths,
    labels, label_lengths) and the rows that have an alignment."""
    logits = (2.0 * rng.standard_normal((B, T, C))).astype(np.float32)
    logit_lengths = np.full(B, T, np.int32)
    logit_lengths[::5] = rng.integers(13, T, size=len(logit_lengths[::5]))
    label_lengths = rng.integers(1, 13, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    labels[1, :6] = [5, 5, 5, 7, 7, 5]  # repeats: no skip between equal labels
    label_lengths[1] = 6
    labels[2], label_lengths[2] = 0, 0  # empty label: all blanks
    labels[3] = rng.integers(1, C, size=L)  # 32 labels in 25 steps
    label_lengths[3] = L
    labels[4] = 0
    labels[4, :14] = 9  # 14 repeats need 27 steps
    label_lengths[4] = 14
    logit_lengths[1:5] = T
    # a row has an alignment iff its labels and the blanks forced between
    # equal neighbours fit in its steps
    words = [labels[b, :label_lengths[b]] for b in range(B)]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    possible = label_lengths + repeats <= logit_lengths
    assert not possible[3] and not possible[4] and possible.sum() > B // 2
    return logits, logit_lengths, labels, label_lengths, possible


def ctc_bounds(logit_lengths, label_lengths, T: int, C: int, L: int):
    """(forward, backward) least times in ms and what bounds each: every input
    read once and every output written once at the HBM rate, against the
    logsumexp arithmetic of the states this run's lengths make live at the
    float32 rate (about 10 operations a state and step forward, 15 backward:
    three exps, a log, maxes, sums; the gradient's exp and add)."""
    B = len(logit_lengths)
    S = 2 * L + 1
    lens = np.clip(logit_lengths, 1, T).astype(np.int64)
    states = (2 * label_lengths.astype(np.int64) + 1)
    inputs = B * T * C * 4 + B * L * 4 + 2 * B * 4
    fwd_bytes = inputs + B * T * S * 4 + B * 4  # + alpha and nll written
    bwd_bytes = inputs + B * T * S * 4 + 2 * B * 4 + B * T * C * 4  # alpha, nll, grad_nll in; grad out
    fwd_ops = 10 * int(((lens - 1) * states).sum())
    bwd_ops = 15 * int((lens * states).sum())
    out = []
    for nbytes, ops in ((fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        out.append((max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
                    nbytes, ops))
    return out


def phase_ctc():
    import torch.nn.functional as F

    from megreader_tpu_torch.ops.ctc import (
        ctc_alpha_cuda,
        ctc_beta_cuda,
        ctc_loss,
        ctc_loss_reference,
        ctc_nll_reference,
    )

    rng = np.random.default_rng(SEED + 4)
    B, T, C, L = 64, 25, 37, 32
    logits_np, ll_np, lb_np, lbl_np, possible = ctc_inputs(rng, B, T, C, L)
    logits = torch.from_numpy(logits_np).cuda()
    ll, lb, lbl = (torch.from_numpy(a).cuda() for a in (ll_np, lb_np, lbl_np))
    lp = F.log_softmax(logits, -1).contiguous()
    ok = torch.from_numpy(possible).cuda()

    # forward: the alpha kernel against the plain DP (loss rtol 1e-4 / atol
    # 1e-4: a log-space DP summed in another order)
    nll, alpha = ctc_alpha_cuda(lp, ll, lb, lbl)
    ref = ctc_nll_reference(lp, ll, lb, lbl)
    torch.cuda.synchronize()
    fwd_err = float((nll - ref)[ok].abs().max())
    log(f"ctc forward: max |kernel - plain| on rows with an alignment {fwd_err:.3g}; "
        f"rows without one: kernel {nll[~ok].tolist()}, plain {ref[~ok].tolist()}")
    if not torch.allclose(nll, ref, rtol=1e-4, atol=1e-4):
        raise AssertionError("ctc alpha kernel disagrees with the plain version")
    if not (torch.isfinite(nll).all() and bool((nll[~ok] > 1e29).all())):
        raise AssertionError("ctc: a row without an alignment must give a finite ~1e30 loss")

    # backward: the beta kernel against autograd through the plain DP
    # (gradient rtol 1e-3 / atol 1e-4), for d(sum nll)/d log_probs
    ones = torch.ones(B, device="cuda")
    grad = ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones)
    lp_ref = lp.detach().clone().requires_grad_()
    ctc_nll_reference(lp_ref, ll, lb, lbl).sum().backward()
    torch.cuda.synchronize()
    bwd_err = float((grad - lp_ref.grad).abs().max())
    log(f"ctc backward: max |kernel - plain| of d nll / d log_probs {bwd_err:.3g}")
    if not torch.allclose(grad, lp_ref.grad, rtol=1e-3, atol=1e-4):
        raise AssertionError("ctc beta kernel disagrees with the plain version")

    # the whole loss from logits, kernels under autograd, mean reduction
    x = logits.clone().requires_grad_()
    loss = ctc_loss(x, ll, lb, lbl)
    loss.backward()
    x_ref = logits.clone().requires_grad_()
    loss_ref = ctc_loss_reference(x_ref, ll, lb, lbl)
    loss_ref.backward()
    log(f"ctc_loss (mean): kernels {loss.item()}, plain {loss_ref.item()}; d/d logits max "
        f"|diff| {float((x.grad - x_ref.grad).abs().max()):.3g}")
    if not (torch.allclose(loss, loss_ref, rtol=1e-4, atol=1e-4)
            and torch.allclose(x.grad, x_ref.grad, rtol=1e-3, atol=1e-4)):
        raise AssertionError("ctc_loss through the kernels disagrees with the plain version")

    # times, CUDA events, median of 100 (plain: 20)
    ms_fwd = cuda_ms(lambda: ctc_alpha_cuda(lp, ll, lb, lbl), reps=100)
    ms_bwd = cuda_ms(lambda: ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones), reps=100)
    def kernels_both():
        n, a = ctc_alpha_cuda(lp, ll, lb, lbl)
        ctc_beta_cuda(lp, ll, lb, lbl, a, n, ones)

    ms_both = cuda_ms(kernels_both, reps=100)
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: ctc_nll_reference(lp, ll, lb, lbl), reps=20)
    out_ref = ctc_nll_reference(lp_ref, ll, lb, lbl).sum()
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(out_ref, lp_ref, retain_graph=True), reps=20)

    def plain_both():
        torch.autograd.grad(ctc_nll_reference(lp_ref, ll, lb, lbl).sum(), lp_ref)

    plain_ms_both = cuda_ms(plain_both, reps=20)
    # torch.nn.functional.ctc_loss: (T, B, C) log-probs, padded targets;
    # rows without an alignment give inf there (zeroed, with their gradient)
    lp_lib = lp.detach().transpose(0, 1).requires_grad_()
    tl, il = lbl.long(), ll.long()

    def lib_loss():
        return F.ctc_loss(lp_lib, lb.long(), il, tl, blank=0, reduction="sum", zero_infinity=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(lib_loss, reps=100)
    out_lib = lib_loss()
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_lib, lp_lib, retain_graph=True), reps=100)
    lib_both = cuda_ms(lambda: torch.autograd.grad(lib_loss(), lp_lib), reps=100)
    lib_nll = F.ctc_loss(lp_lib.detach(), lb.long(), il, tl, blank=0, reduction="none")
    log(f"F.ctc_loss on the rows with an alignment: max |kernel - F.ctc_loss| "
        f"{float((nll - lib_nll)[ok].abs().max()):.3g}")

    # the kernels' own device time, without the wrapper's host time that
    # the events above also see when the card waits for the launch
    busy_fwd = device_busy_ms(lambda: ctc_alpha_cuda(lp, ll, lb, lbl), reps=20)
    busy_bwd = device_busy_ms(lambda: ctc_beta_cuda(lp, ll, lb, lbl, alpha, nll, ones), reps=20)
    log(f"ctc kernel-busy ms per launch (torch.profiler device time): forward {busy_fwd}, "
        f"backward {busy_bwd}")
    (fwd_bound, fwd_by, fwd_bytes, fwd_ops), (bwd_bound, bwd_by, bwd_bytes, bwd_ops) = ctc_bounds(
        ll_np, lbl_np, T, C, L)
    log(f"ctc time (ms, median, CUDA events): kernels forward {ms_fwd}, backward {ms_bwd}, "
        f"forward+backward {ms_both}; plain forward {plain_fwd}, backward {plain_bwd}, "
        f"forward+backward {plain_ms_both}; F.ctc_loss forward {lib_fwd}, backward {lib_bwd}, "
        f"forward+backward {lib_both}")
    log(f"ctc bound: forward {fwd_bytes} B, {fwd_ops} ops -> {fwd_bound:.6f} ms by {fwd_by}; "
        f"backward {bwd_bytes} B, {bwd_ops} ops -> {bwd_bound:.6f} ms by {bwd_by}; "
        f"dependent steps per launch: {int(ll_np.max()) - 1} forward, {int(ll_np.max())} backward")
    common = {"route": "cuda", "source": "megreader_tpu_torch/csrc/ctc.cu", "launches": 0}
    return [
        {"name": "ctc_alpha", **common, "replaces": "megreader_tpu/ops/pallas_ctc.py:69",
         "max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": plain_fwd, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": lib_fwd},
        {"name": "ctc_beta", **common, "replaces": "megreader_tpu/ops/pallas_ctc.py:95",
         "max_abs_err": bwd_err, "ms": ms_bwd, "plain_ms": plain_bwd, "bound_ms": bwd_bound,
         "bound_by": bwd_by, "library_ms": lib_bwd},
    ]


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


class WordCrops:
    """Numpy-made word crops with the item contract of the port's
    ``SyntheticRecognitionDataset``: {"image": (64, 256, 3) uint8 canvas with
    the crop at its top left, "size": (h, w) int32, "text": 3-10 characters}.
    Each character is a fixed random 20x10 glyph, bright on dark noise."""

    ALPHABET = "0123456789abcdefghijklmnopqrstuvwxyz"

    def __init__(self, n: int, seed: int, canvas_hw=(64, 256)):
        self.n = n
        self.seed = seed
        self.canvas_hw = canvas_hw
        self.glyphs = np.random.default_rng(seed).random((len(self.ALPHABET), 20, 10)) < 0.45

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        ids = rng.integers(0, len(self.ALPHABET), int(rng.integers(3, 11)))
        left, top, right, bottom = (int(v) for v in rng.integers(0, 6, 4))
        h, w = 20 + top + bottom, 10 * len(ids) + left + right
        crop = rng.integers(0, 50, (h, w, 3), dtype=np.uint8)
        for j, c in enumerate(ids):
            crop[top:top + 20, left + 10 * j:left + 10 * j + 10][self.glyphs[c]] = 235
        canvas = np.zeros((*self.canvas_hw, 3), np.uint8)
        canvas[:h, :w] = crop
        return {"image": canvas, "size": np.array([h, w], np.int32),
                "text": "".join(self.ALPHABET[c] for c in ids)}


def phase_train():
    from megreader_tpu_torch.experiment import Experiment
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.ops.ctc import (
        ctc_alpha_cuda,
        ctc_beta_cuda,
        ctc_loss,
        ctc_loss_reference,
    )
    from megreader_tpu_torch.train.checkpoint import CheckpointManager
    from megreader_tpu_torch.train.train_step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    B, per_epoch, epochs = 64, 4, 6
    steps = per_epoch * epochs
    opt = OptimizerConfig(name="adam", lr=1e-3, schedule="warmup_cosine", warmup_steps=200,
                          total_steps=20_000)
    data = WordCrops(B * per_epoch, SEED + 5)
    rec = CTCRecognizer(num_classes=37, device="cuda")
    seeded_weights(rec.net, SEED + 6)

    with tempfile.TemporaryDirectory() as ws:
        def experiment(model, n_epochs):
            return Experiment(model, data, optimizer=opt, workspace=ws, batch_size=B,
                              epochs=n_epochs, log_every=1)

        exp = experiment(rec, epochs)
        ctc_alpha_cuda.launches = 0
        ctc_beta_cuda.launches = 0
        t0 = time.perf_counter()
        state = exp.make_trainer().train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (ctc_alpha_cuda.launches, ctc_beta_cuda.launches)
        with open(os.path.join(ws, "train_metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        log(f"train: {state.step} steps of {B} crops in {wall:.2f} s (host clock, loader, "
            f"logging and checkpoint included); CTC kernel launches {launches}; loss mean "
            f"of the first 5 steps {first:.4f}, of the last 5 {last:.4f}; losses {losses}")
        if state.step != steps or len(losses) != steps:
            raise AssertionError(f"train ran {state.step} steps and logged {len(losses)}, not {steps}")
        if not all(np.isfinite(losses)) or not last < first:
            raise AssertionError("train: losses must be finite and fall")
        if launches != (steps, steps):
            raise AssertionError(f"CTC kernels launched {launches} times in {steps} steps")

        # a fresh model restores the checkpoint at the last step and trains on
        rec2 = CTCRecognizer(num_classes=37, device="cuda")
        seeded_weights(rec2.net, SEED + 7)
        restored = CheckpointManager(ws).restore(create_train_state(rec2, opt))
        same = all(torch.equal(a, b) for a, b in zip(rec.net.state_dict().values(),
                                                    rec2.net.state_dict().values()))
        if restored.step != steps or restored.optimizer.count != steps or not same:
            raise AssertionError("train: the checkpoint did not restore the trained state")
        resumed = experiment(rec2, epochs + 1).make_trainer().train(resume=True)
        if resumed.step != steps + per_epoch or ctc_alpha_cuda.launches != launches[0] + per_epoch:
            raise AssertionError(f"train: resume ended at step {resumed.step}")
        log(f"train: restored step {restored.step} into a fresh model, resumed to {resumed.step}")

    raw = exp.collate([data[i] for i in range(B)])
    batch = exp.prepare(raw)

    # one step's loss and gradients through the kernels against the plain loss,
    # the same weights and batch, TF32 off, deterministic cuDNN
    torch.backends.cudnn.deterministic = True
    net = rec.net

    def loss_and_grads(loss_fn):
        net.zero_grad(set_to_none=True)
        net.train()
        logits = net(batch["image"])
        lengths = torch.full((B,), logits.shape[1], dtype=torch.int32, device="cuda")
        loss = loss_fn(logits, lengths, batch["label"], batch["label_length"])
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}

    loss_k, grads_k = loss_and_grads(ctc_loss)
    loss_r, grads_r = loss_and_grads(ctc_loss_reference)
    torch.backends.cudnn.deterministic = False
    rel = max(float((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
              for n, g in grads_r.items())
    log(f"train one-step parity: loss kernels {loss_k}, plain {loss_r}; worst gradient leaf "
        f"max |diff| / max |plain| {rel:.3g} over {len(grads_r)} leaves")
    if abs(loss_k - loss_r) > 1e-4:
        raise AssertionError("train: the kernel loss disagrees with the plain loss")
    for n, g in grads_r.items():
        if not torch.allclose(grads_k[n], g, rtol=1e-3, atol=1e-6):
            raise AssertionError(f"train: gradient of {n} disagrees with the plain loss's")

    # time of a step and its parts (CUDA events, median of 10 after 3 warm-up)
    state = create_train_state(rec, opt)
    parts = ("prepare", "forward", "ctc_forward", "backward", "optimizer")
    times = {k: [] for k in parts + ("step",)}
    for rep in range(13):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        b = exp.prepare(raw)
        ev[1].record()
        net.train()
        logits = net(b["image"])
        ev[2].record()
        lengths = torch.full((B,), logits.shape[1], dtype=torch.int32, device="cuda")
        loss = ctc_loss(logits, lengths, b["label"], b["label_length"])
        ev[3].record()
        loss.backward()
        ev[4].record()
        state.optimizer.step()
        state.optimizer.zero_grad()
        ev[5].record()
        ev[5].synchronize()
        if rep >= 3:
            for k, (a, e) in zip(parts, zip(ev[:-1], ev[1:])):
                times[k].append(a.elapsed_time(e))
            times["step"].append(ev[0].elapsed_time(ev[5]))
    split = {k: statistics.median(v) for k, v in times.items()}
    step_fn = make_train_step(rec, prepare=exp.prepare)
    busy = device_busy_ms(lambda: step_fn(state, raw))
    step_ms = cuda_ms(lambda: step_fn(state, raw), reps=10)
    idle = "not measured" if busy is None else f"{1.0 - busy / step_ms:.4f}"
    log("train step split (ms, median of 10, CUDA events): " + json.dumps(split)
        + f"; {B / split['step'] * 1e3:.1f} crops/s")
    log(f"train step (make_train_step, CUDA events, median of 10): {step_ms} ms = "
        f"{B / step_ms * 1e3:.1f} crops/s; kernel-busy {busy} ms; device idle share {idle}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    phase_setup()
    ccl_row = phase_ccl()
    alpha_row, beta_row = phase_ctc()
    ccl_row["launches"] = phase_e2e()
    alpha_row["launches"], beta_row["launches"] = phase_train()
    log(json.dumps({"kernels": [ccl_row, alpha_row, beta_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
