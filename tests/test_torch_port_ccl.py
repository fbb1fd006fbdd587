"""Port CCL: the plain PyTorch version against the JAX XLA solve, bit-exact,
and the wrapper's dispatch (plain version only for CPU tensors, no fallback
on the CUDA branch). The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there)."""

import ast
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megreader_tpu.ops.ccl import connected_components as jax_connected_components
from megreader_tpu_torch import kernels
from megreader_tpu_torch.ops import ccl


def _text_blobs():
    m = np.zeros((64, 96), bool)
    m[10:20, 5:40] = True
    m[30:42, 50:90] = True
    m[50:54, 10:80] = True
    return m


def _diagonal():
    m = np.zeros((64, 96), bool)
    m[10:20, 10:20] = True
    m[20:30, 20:30] = True  # touches the first only at a corner: separate
    return m


def _serpentine():
    m = np.zeros((64, 96), bool)
    for k, r in enumerate(range(4, 60, 8)):
        m[r:r + 4, 4:92] = True
        c = slice(88, 92) if k % 2 == 0 else slice(4, 8)
        m[r + 4:r + 8, c] = True
    return m


def _column_snake():
    """1-px vertical stripes joined at alternate ends: one component whose
    every vertical run spans the page, joined through 1-px bends."""
    m = np.zeros((64, 96), bool)
    m[1:63, 0:95:2] = True
    for k, x in enumerate(range(1, 94, 2)):
        m[1 if k % 2 else 62, x] = True
    return m


def _edge_runs_unaligned():
    """W = 101 (not a multiple of 32): runs that cross every 32-pixel edge of
    each row at shifted offsets, joined down the page in a staircase."""
    m = np.zeros((40, 101), bool)
    for y in range(0, 40, 2):
        for edge in (32, 64, 96):
            lo = max(edge - 3 - y % 5, 0)
            m[y, lo:min(edge + 2 + y % 3, 101)] = True
        m[y + 1, (7 * y) % 101] = True  # a vertical joint to the next row
    m[:, 100] |= np.arange(40) % 3 != 0  # the ragged last column
    return m


CASES = {
    "batched_random": lambda rng: rng.random((3, 64, 96)) < 0.35,
    "text_blobs_and_diagonal": lambda rng: np.stack([_text_blobs(), _diagonal()]),
    "serpentine_capped": lambda rng: _serpentine()[None],
    "unaligned_61x97": lambda rng: rng.random((2, 61, 97)) < 0.45,
    "empty_and_full": lambda rng: np.stack(
        [np.zeros((16, 128), bool), np.ones((16, 128), bool)]
    ),
    "transposed_serpentine": lambda rng: np.ascontiguousarray(_serpentine().T)[None],
    "column_snake": lambda rng: _column_snake()[None],
    "edge_runs_unaligned_101": lambda rng: _edge_runs_unaligned()[None],
}


@pytest.mark.parametrize(
    "case,max_iters",
    [("batched_random", 64), ("text_blobs_and_diagonal", 64),
     ("serpentine_capped", 2), ("serpentine_capped", 64),
     ("unaligned_61x97", 64), ("empty_and_full", 64),
     ("transposed_serpentine", 1), ("transposed_serpentine", 2),
     ("transposed_serpentine", 3), ("transposed_serpentine", 64),
     ("column_snake", 1), ("column_snake", 64),
     ("edge_runs_unaligned_101", 64)],
)
def test_ccl_reference_matches_jax_bit_exact(case, max_iters):
    mask = CASES[case](np.random.default_rng(0))
    ref = np.asarray(
        jax_connected_components(jnp.asarray(mask), max_iters=max_iters, impl="xla")
    )
    got = ccl.connected_components(torch.from_numpy(mask), max_iters=max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_serpentine_cap_is_hit_and_counted():
    mask = torch.from_numpy(_serpentine()[None])
    _, sweeps = ccl.connected_components_reference(mask, 2, return_sweeps=True)
    assert sweeps.tolist() == [2]
    full, sweeps = ccl.connected_components_reference(mask, 64, return_sweeps=True)
    assert 2 < int(sweeps[0]) < 64
    assert len(torch.unique(full[full >= 0])) == 1  # one component when uncapped


def test_column_cases_stay_capped():
    """The transposed serpentine at cap 3 and the column snake short of its
    49 sweeps are capped states, not converged ones."""
    for mask, cap in ((_serpentine().T, 3), (_column_snake(), 24)):
        m = torch.from_numpy(np.ascontiguousarray(mask)[None])
        _, sweeps = ccl.connected_components_reference(m, cap, return_sweeps=True)
        assert sweeps.tolist() == [cap]


def test_wrapper_passes_every_launcher_argument():
    """The ctypes signature of ``mr_ccl_launch`` in the wrapper has one entry
    per parameter of the C launcher in ``csrc/ccl.cu``."""
    src = (kernels.CSRC / "ccl.cu").read_text()
    decl = src[src.index('extern "C" int mr_ccl_launch('):]
    params = decl[decl.index("(") + 1:decl.index(")")].split(",")
    tree = ast.parse(inspect.getsource(ccl.connected_components_cuda).lstrip())
    argtypes = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and [ast.unparse(t) for t in n.targets] == ["fn.argtypes"]]
    assert len(argtypes) == 1 and len(argtypes[0].elts) == len(params) == 8


def test_cpu_tensor_takes_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA wrapper called for a CPU tensor")

    monkeypatch.setattr(ccl, "connected_components_cuda", boom)
    # the choice follows the tensor's device, not whether a card is present
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mask = torch.from_numpy(_text_blobs()[None])
    got = ccl.connected_components(mask, max_iters=8)
    np.testing.assert_array_equal(
        got.numpy(), ccl.connected_components_reference(mask, 8).numpy()
    )


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    monkeypatch.setattr(
        ccl, "connected_components_reference",
        lambda *a, **k: pytest.fail("plain version used for a non-CPU tensor"),
    )
    meta = torch.zeros((1, 8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl.connected_components(meta, max_iters=4)


def test_cuda_branch_has_no_try():
    for fn in (ccl.connected_components, ccl.connected_components_cuda):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__


def test_launch_error_raises():
    kernels.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        kernels.check(9, "ccl kernel")


def test_kernel_sources_and_build_dir_are_listed():
    assert kernels.sources() == ["ccl", "ctc", "ctc2d", "extract"]
    ignored = (kernels.BUILD_DIR.parents[1] / ".gitignore").read_text().split()
    assert "build/" in ignored
