"""Page OCR (judged config #5): a detector and a recognizer checkpoint ->
each page's word quads and strings, one JSON line a page.

    python -m megreader_tpu_torch.cli.pipeline \
        --detector experiments/seg_detector_synth.yaml --det-workspace W1 \
        --recognizer experiments/ctc_resnet18_synth.yaml --rec-workspace W2 \
        --images page1.png page2.png [--rectify box|deskew|perspective] [--bucketed] \
        [--out-dir vis/] [--experiment.<key> value ...]

Pages are PNG, JPEG, JPEG 2000 (JP2 or a raw codestream), BMP, PNM, PFM,
Sun raster, Radiance HDR, GIF, TIFF or WebP files (``data/imageio.py``:
the card's machine has no cv2),
resized to ``--page-size`` square with cv2's bilinear geometry, or with
``--bucketed`` each scaled (never up) into the smallest of the default
canvases that keeps it largest (``pipelines/bucketed.py``); quads come back
in the page's own pixels. Trailing dotted overrides apply to both
experiments. ``--out-dir`` writes one overlay a page, ``<out-dir>/<page
name>.png``: the page with its detections' polygons and texts
(``postproc/visualizer.py``, cv2's drawing in numpy).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core.config import parse_cli_overrides
from ..data.imageio import read_image, resize_linear
from ..experiment import Experiment
from ..pipelines.bucketed import BucketedE2E
from ..pipelines.e2e import E2EPipeline
from ..postproc.visualizer import DetectionVisualizer
from ..train.checkpoint import CheckpointManager


def _load(config, workspace, overrides):
    """The experiment with its module's weights restored (params only:
    serving does not depend on the optimizer a checkpoint was trained with)."""
    exp = Experiment.from_yaml(
        config, {**overrides, **({"experiment.workspace": workspace} if workspace else {})})
    CheckpointManager(workspace or exp.workspace).restore_variables(exp.model.net)
    return exp


def main(argv=None):
    """Returns the printed dicts, one a page."""
    ap = argparse.ArgumentParser(prog="python -m megreader_tpu_torch.cli.pipeline")
    ap.add_argument("--detector", required=True)
    ap.add_argument("--det-workspace", default=None)
    ap.add_argument("--recognizer", required=True)
    ap.add_argument("--rec-workspace", default=None)
    ap.add_argument("--images", nargs="+", required=True)
    ap.add_argument("--out-dir", default=None,
                    help="write each page with its polygons and texts to <out-dir>/<name>.png")
    ap.add_argument("--page-size", type=int, default=640)
    ap.add_argument("--max-regions", type=int, default=32)
    ap.add_argument("--box-thresh", type=float, default=0.5)
    ap.add_argument("--deskew", action="store_true",
                    help="legacy flag: upgrades the default --rectify to deskew")
    ap.add_argument("--rectify", default="perspective", choices=["box", "deskew", "perspective"],
                    help="crop geometry: axis-aligned box, box deskewed by three shears, or "
                         "the rotated quad rectified by its homography")
    ap.add_argument("--rec-mode", default="greedy", choices=["greedy", "beam"])
    ap.add_argument("--beam-width", type=int, default=8)
    ap.add_argument("--unclip", default="inverse", choices=["inverse", "ratio"],
                    help="box expansion: the exact inverse of the training shrink "
                         "(--shrink-ratio), or d = A * ratio / P (--unclip-ratio)")
    ap.add_argument("--unclip-ratio", type=float, default=1.5)
    ap.add_argument("--shrink-ratio", type=float, default=None,
                    help="the detector's training shrink ratio; default: the detector "
                         "config's train_dataset shrink_ratio, else 0.4")
    ap.add_argument("--extract-impl", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_full"],
                    help="region statistics: plain torch ('auto', 'xla') or the CUDA "
                         "extraction kernels")
    ap.add_argument("--bucketed", action="store_true",
                    help="variable-size serving: each page scaled into the smallest default "
                         "canvas bucket that keeps it largest, instead of a square "
                         "--page-size resize")
    args, rest = ap.parse_known_args(argv)
    overrides = parse_cli_overrides(rest)

    det_exp = _load(args.detector, args.det_workspace, overrides)
    rec_exp = _load(args.recognizer, args.rec_workspace, overrides)
    shrink = args.shrink_ratio
    if shrink is None:
        shrink = float(getattr(det_exp.train_loader and det_exp.train_loader.dataset,
                               "shrink_ratio", 0.4) or 0.4)
    pipe = E2EPipeline(
        det_exp.model, rec_exp.model, rec_exp.charset, max_regions=args.max_regions,
        box_thresh=args.box_thresh, unclip=args.unclip, unclip_ratio=args.unclip_ratio,
        shrink_ratio=shrink, deskew=args.deskew, rectify=args.rectify,
        rec_mode=args.rec_mode, beam_width=args.beam_width, extract_impl=args.extract_impl,
        device=next(det_exp.model.net.parameters()).device,
    )

    S = args.page_size
    pages, scales, originals = [], [], []
    for path in args.images:
        img = read_image(path)
        originals.append(img)
        h, w = img.shape[:2]
        if args.bucketed:  # BucketedE2E scales the polygons itself
            pages.append(img.astype(np.float32))
            scales.append((1.0, 1.0))
        else:
            pages.append(resize_linear(img, (S, S)).astype(np.float32))
            scales.append((w / S, h / S))
    if args.bucketed:
        results = BucketedE2E(pipe).predict(None, None, pages)
    else:
        results = pipe.predict(None, None, np.stack(pages))

    vis = DetectionVisualizer(args.out_dir) if args.out_dir else None
    out = []
    for path, page, (sx, sy), orig in zip(args.images, results, scales, originals):
        dets = [{"polygon": (d["polygon"] * np.array([sx, sy])).tolist(), "text": d["text"],
                 "score": d["score"]} for d in page]
        out.append({"image": path, "detections": dets})
        print(json.dumps(out[-1]))
        if vis is not None:
            name = os.path.splitext(os.path.basename(path))[0]
            vis.visualize(name, orig, [np.array(d["polygon"]) for d in dets],
                          [d["text"] for d in dets])
    return out


if __name__ == "__main__":
    main()
