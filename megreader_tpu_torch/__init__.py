"""PyTorch/CUDA port of megreader_tpu for one NVIDIA H100.

Imports torch and numpy only: nothing of JAX and nothing of the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
