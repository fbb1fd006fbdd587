"""Evaluate a checkpoint:

    python -m megreader_tpu_torch.cli.eval experiments/<exp>.yaml [--step N]
        [--mode greedy|beam] [--protocol icdar2015|deteval] [--representer quad|poly]
        [--experiment.<key> value ...]

Restores the module's weights only (``CheckpointManager.restore_variables``:
evaluation does not depend on the optimizer a checkpoint was trained with)
from the latest, or the given, step of the workspace, evaluates on the
experiment's eval set and prints one JSON line: the step and the metrics.
``--representer poly`` scores a detector's chain polygons (curved text);
``--int8`` serves a detector through int8 layers (``ops/quantize.py``).
torch and the experiment are imported inside ``main``,
as in ``cli/train.py`` (the loader's process workers run this module's top
level again).
"""

from __future__ import annotations

import argparse
import json

from ..core.config import parse_cli_overrides


def main(argv=None):
    """Returns the printed dict."""
    from ..evaluation import evaluate
    from ..experiment import Experiment
    from ..train.checkpoint import CheckpointManager

    ap = argparse.ArgumentParser(prog="python -m megreader_tpu_torch.cli.eval")
    ap.add_argument("config")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--mode", default="greedy", choices=["greedy", "beam"])
    ap.add_argument("--protocol", default="icdar2015", choices=["icdar2015", "deteval"])
    ap.add_argument("--representer", default="quad", choices=["quad", "poly"],
                    help="detection output: min-area quads or chain polygons (curved "
                         "text)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 serving path (ops/quantize.py) quality gate (detection)")
    args, rest = ap.parse_known_args(argv)

    exp = Experiment.from_yaml(args.config, parse_cli_overrides(rest))
    mgr = CheckpointManager(exp.workspace)
    step = args.step if args.step is not None else mgr.latest_step()
    mgr.restore_variables(exp.model.net, step=step)
    metrics = evaluate(exp, mode=args.mode, protocol=args.protocol,
                       representer_mode=args.representer, int8=args.int8)
    out = {"step": int(step or 0), **metrics}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
