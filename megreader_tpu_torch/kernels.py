"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, and loaded with ``ctypes``.
Nothing is built when this module is imported: :func:`library` builds on its
first call, and :func:`build_all` builds every source at once (one ``nvcc``
process per source, all started together).

Libraries land in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by the hash of their source, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

#: dynamic shared memory a block may take on Hopper (227 KB); above 48 KB a
#: launcher opts its kernel in
SMEM_LIMIT = 232448

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, Dict[str, ctypes._CFuncPtr]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def sources() -> List[str]:
    """Names (stems) of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all) that is not built yet, in
    parallel. Raises with nvcc's output if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def functions(name: str, prototypes: Dict[str, Tuple[Sequence, type]]
              ) -> Dict[str, ctypes._CFuncPtr]:
    """The named C functions of ``csrc/<name>.cu``, each with its
    ``(argtypes, restype)`` from ``prototypes`` set once, when they are first
    asked for, and not again on every call."""
    fns = _bound.get(name)
    if fns is None:
        lib = library(name)
        fns = {}
        for fn_name, (argtypes, restype) in prototypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            fns[fn_name] = fn
        _bound[name] = fns
    return fns


def launch(fn, dev: torch.device, *args) -> int:
    """Call a launcher on ``dev``'s current stream, making ``dev`` current
    only where it is not. The stream is read as the raw handle
    (``torch.cuda.current_stream(dev).cuda_stream`` without building a
    ``Stream`` object on every call)."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
