"""Train an experiment on the card:

    python -m megreader_tpu_torch.cli.train experiments/<exp>.yaml [--no-resume]
        [--experiment.batch_size 128] [--experiment.optimizer.lr 1e-3] ...

One YAML, dotted overrides, resumed from the workspace's latest checkpoint
unless ``--no-resume``. The models run on the card unless an override asks
for the CPU (``--experiment.model.device cpu``).

The experiment (and torch with it) is imported inside ``main``: the data
loader's process workers start from a forkserver, which runs this module's
top level again in each worker, and they need numpy only.
"""

from __future__ import annotations

import argparse

from ..core.config import parse_cli_overrides


def main(argv=None):
    """Returns the final train state."""
    from ..experiment import Experiment

    ap = argparse.ArgumentParser(prog="python -m megreader_tpu_torch.cli.train")
    ap.add_argument("config")
    ap.add_argument("--no-resume", action="store_true")
    args, rest = ap.parse_known_args(argv)
    exp = Experiment.from_yaml(args.config, parse_cli_overrides(rest))
    return exp.make_trainer().train(resume=not args.no_resume)


if __name__ == "__main__":
    main()
