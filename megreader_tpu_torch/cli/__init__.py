"""The port's entry points, run as ``python -m megreader_tpu_torch.cli.<name>``:
``train``, ``eval`` and ``pipeline``, the counterparts of the root ``cli/``
scripts with the same flags. Each has ``main(argv=None)``."""
