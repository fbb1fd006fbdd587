"""Port CCL: the plain PyTorch version against the JAX XLA solve, bit-exact,
flat and multigrid (``multigrid=True``: a seeded second solve), and the
wrapper's dispatch (plain version only for CPU tensors, no fallback
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
    assert len(argtypes) == 1 and len(argtypes[0].elts) == len(params) == 9


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


def _multigrid_masks():
    """``tests/test_ccl.py``'s multigrid masks (text blobs with a thin wide
    stroke, 35% random pixels with 1-px structures that erode away at half
    resolution, diagonal neighbours) and odd-sized pages."""
    rng = np.random.default_rng(0)
    m = _text_blobs()
    diag = _diagonal()
    odd = np.zeros((33, 47), bool)
    odd[5:12, 3:30] = True
    odd[20:30, 10:45] = True
    return {
        "test_ccl": np.stack([m, rng.random((64, 96)) < 0.35, diag]),
        "odd_33x47": np.stack([odd, rng.random((33, 47)) < 0.45,
                               np.ascontiguousarray(_serpentine().T[:33, :47])]),
        "one_row": rng.random((2, 1, 9)) < 0.5,
    }


@pytest.mark.parametrize("case", ["test_ccl", "odd_33x47", "one_row"])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 64])
def test_multigrid_matches_jax_bit_exact(case, max_iters):
    """The plain multigrid against the JAX XLA multigrid at every cap; uncapped
    its labels are the flat solve's."""
    mask = _multigrid_masks()[case]
    ref = np.asarray(jax_connected_components(jnp.asarray(mask), max_iters=max_iters,
                                              multigrid=True, impl="xla"))
    got = ccl.connected_components(torch.from_numpy(mask), max_iters=max_iters,
                                   multigrid=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if max_iters == 64:
        np.testing.assert_array_equal(
            got.numpy(), ccl.connected_components(torch.from_numpy(mask), 64).numpy())


def test_multigrid_runs_both_levels_through_one_solver():
    """Both levels go through the given solver, the second with seeds at each
    coarse root's full index (own index on the odd edge), and the sweeps
    come back per level."""
    mask = torch.from_numpy(_multigrid_masks()["odd_33x47"])
    calls = []

    def solve(m, max_iters, return_sweeps=False, seed=None):
        calls.append((tuple(m.shape), None if seed is None else seed.clone()))
        return ccl.connected_components_reference(m, max_iters, return_sweeps, seed=seed)

    labels, sweeps = ccl.multigrid_solve(solve, mask, 64, return_sweeps=True)
    assert [c[0] for c in calls] == [(3, 16, 23), (3, 33, 47)]
    assert calls[0][1] is None
    seed = calls[1][1]
    assert seed.dtype == torch.int32 and torch.all(seed[:, 32, :] == 33 * 47)
    assert torch.all(seed[:, :, 46] == 33 * 47)
    on = seed < 33 * 47  # a seed names a member at or before the pixel
    own = torch.arange(33 * 47, dtype=torch.int32).view(1, 33, 47).expand(3, -1, -1)
    assert torch.all(mask[on]) and torch.all(seed[on] <= own[on])
    assert torch.all(mask.flatten(1).gather(1, seed.flatten(1).clamp(max=33 * 47 - 1))
                     .view_as(mask)[on])
    assert sweeps.shape == (2, 3) and sweeps.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), ccl.connected_components(mask, 64).numpy())


def test_seeded_start_is_min_of_index_and_seed():
    """A seed lowers a pixel's start label only: the sweeps from
    min(index, seed) on a page where the seeds name real members give the flat
    labels, and a capped first sweep shows the seeds."""
    mask = torch.from_numpy(_serpentine()[None])
    flat, flat_sw = ccl.connected_components_reference(mask, 64, return_sweeps=True)
    root = int(flat[flat >= 0].min())
    seed = torch.where(mask, root, 64 * 96).to(torch.int32)
    got, sw = ccl.connected_components_reference(mask, 64, return_sweeps=True, seed=seed)
    assert torch.equal(got, flat) and sw.tolist() == [1] < flat_sw.tolist()
    none = torch.full_like(seed, 64 * 96)
    assert torch.equal(ccl.connected_components_reference(mask, 2, seed=none),
                       ccl.connected_components_reference(mask, 2))


def test_multigrid_non_cpu_tensor_never_falls_back(monkeypatch):
    """Under ``multigrid`` both levels of a non-CPU mask go to the kernel's
    wrapper; the plain version is never called."""
    monkeypatch.setattr(
        ccl, "connected_components_reference",
        lambda *a, **k: pytest.fail("plain version used for a non-CPU tensor"),
    )
    meta = torch.zeros((1, 8, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl.connected_components(meta, max_iters=4, multigrid=True)
