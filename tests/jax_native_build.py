"""Build the JAX package's host geometry library once, atomically.

``megreader_tpu.native`` builds ``_geometry.so`` with g++ at its first call
and writes it in place. Under ``pytest -n`` several worker processes of a
fresh checkout make that first call at once: one worker's g++ is still
writing the file when another finds it, takes it for built and ``dlopen``s
it ("file too short"). ``ensure_built`` compiles with the same command into
a file of its own and renames it into place, so any process finds either no
library or a whole one; ``test_torch_port_jax_native_build.py`` calls it
when pytest imports it, which every worker does while collecting, before any
test runs.
"""

from __future__ import annotations

import os
import subprocess
import tempfile


def ensure_built(src: str = None, so: str = None) -> bool:
    """Compile ``src`` (the JAX package's ``geometry.cpp``) to ``so`` unless
    ``so`` is as new as ``src``; False where g++ fails (the package then
    takes its numpy routes)."""
    if src is None or so is None:
        from megreader_tpu import native

        src, so = native._SRC, native._SO
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return True
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.chmod(tmp, 0o755)
        os.replace(tmp, so)  # atomic: a concurrent reader sees all or nothing
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
