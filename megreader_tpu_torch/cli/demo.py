"""Run a trained model on one image:

    python -m megreader_tpu_torch.cli.demo experiments/<exp>.yaml --image page.jpg \\
        [--out demo_out.png] [--step N] [--experiment.<key> value ...]

A recognizer's YAML prints the image's transcription. A detector's YAML
resizes the page to 640x640 (``data/imageio.py::resize_linear``, cv2's
bilinear resize), detects its words and writes the page with their polygons,
in the page's own pixels, to ``<out without its extension>.png``
(``postproc/visualizer.py``). The weights are the workspace's latest (or
``--step``) checkpoint, the module's weights only: a port checkpoint through
``CheckpointManager.restore_variables``, else a JAX package msgpack
checkpoint through ``restore_jax_variables``. Images are any file
``read_image`` reads (PNG, JPEG, JPEG 2000, BMP, PNM, PFM, Sun raster,
Radiance HDR, GIF, TIFF, WebP).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.config import parse_cli_overrides

PAGE = 640


def main(argv=None):
    """Returns {'text': ...} for a recognizer, {'polygons': ..., 'path': ...}
    for a detector."""
    from ..data.imageio import read_image, resize_linear
    from ..experiment import Experiment
    from ..pipelines.predictors import RECOGNIZERS, DetectorPredictor, RecognizerPredictor
    from ..postproc.visualizer import DetectionVisualizer
    from ..train.checkpoint import CheckpointManager

    ap = argparse.ArgumentParser(prog="python -m megreader_tpu_torch.cli.demo")
    ap.add_argument("config")
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="demo_out.png")
    ap.add_argument("--step", type=int, default=None)
    args, rest = ap.parse_known_args(argv)

    exp = Experiment.from_yaml(args.config, parse_cli_overrides(rest))
    mgr = CheckpointManager(exp.workspace)
    if mgr.latest_step() is None and mgr.has_jax_state():
        mgr.restore_jax_variables(exp.model.net, step=args.step)
    else:
        mgr.restore_variables(exp.model.net, step=args.step)

    img = read_image(args.image)
    h, w = img.shape[:2]
    if isinstance(exp.model, RECOGNIZERS):
        canvas = np.zeros((1, max(64, h), max(256, w), 3), np.float32)
        canvas[0, :h, :w] = img
        pred = RecognizerPredictor(exp.model, exp.charset, crop_hw=exp.crop_hw)
        text = pred.predict(None, canvas, np.array([[h, w]], np.int32))[0]
        print(f"transcription: {text!r}")
        return {"text": text}
    resized = resize_linear(img, (PAGE, PAGE))
    res = DetectorPredictor(exp.model).predict(
        None, resized[None].astype(np.float32),
        scales=np.array([[w / PAGE, h / PAGE]], np.float32))[0]
    path = DetectionVisualizer(".").visualize(args.out.rsplit(".", 1)[0], img, res["polygons"])
    print(f"{len(res['polygons'])} regions -> {path}")
    return {"polygons": res["polygons"], "path": path}


if __name__ == "__main__":
    main()
