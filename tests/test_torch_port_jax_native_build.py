"""The JAX package's geometry library is built before any test runs.

``megreader_tpu.native`` builds ``_geometry.so`` in place at its first call;
in a fresh checkout under ``pytest -n 6`` two workers could make that call at
once, and one ``dlopen``ed the other's half-written file ("file too short",
which failed ``test_jax_datasets_equal_the_ports_on_the_new_formats`` once).
Importing this file builds the library atomically (``jax_native_build``):
every worker imports it while collecting, before any test starts.
"""

import ctypes
import multiprocessing as mp
import os
import shutil

import jax_native_build

jax_native_build.ensure_built()


def _build_and_load(src: str, so: str, rounds: int, out) -> None:
    errors = 0
    for _ in range(rounds):
        jax_native_build.ensure_built(src, so)
        try:
            ctypes.CDLL(so)
        except OSError:
            errors += 1
        os.utime(src)  # make the next round build again
    out.put(errors)


def test_concurrent_builds_never_leave_a_partial_library(tmp_path):
    """Four processes each build the library and load it, again and again,
    into one path: no load ever meets a file in the middle of its writing."""
    from megreader_tpu import native

    src = str(tmp_path / "geometry.cpp")
    shutil.copy(native._SRC, src)
    so = str(tmp_path / "_geometry.so")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_build_and_load, args=(src, so, 3, out)) for _ in range(4)]
    for p in procs:
        p.start()
    errors = [out.get(timeout=300) for _ in procs]
    for p in procs:
        p.join(timeout=60)
    assert errors == [0, 0, 0, 0]
    assert sorted(os.listdir(tmp_path)) == ["_geometry.so", "geometry.cpp"]  # no temporaries left


def test_jax_native_library_is_whole_and_loads():
    from megreader_tpu import native

    assert os.path.getmtime(native._SO) >= os.path.getmtime(native._SRC)
    lib = native._load()
    assert lib is not None and native.AVAILABLE
