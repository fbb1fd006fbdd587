"""Port 2D-CTC: the plain Markov and independent losses, their gradients and
the two decodes against the JAX package's XLA versions and its Pallas kernels
(interpret mode, as ``tests/test_pallas_ctc2d.py`` runs them), and the
wrapper's dispatch (plain version only for CPU tensors, no fallback on the
CUDA branch). The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against the plain version there).

Every case lives in one batch of one shape, so that each JAX function
compiles once: varied logit lengths (1 to T), label lengths 0, 1 and L,
repeated labels, and rows without an alignment. Tolerances are those of
``tests/test_pallas_ctc2d.py``: loss rtol 1e-4 / atol 1e-4, gradients rtol
2e-3 / atol 2e-4 (a log-space DP summed in another order)."""

import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.ops.ctc2d import ctc2d_greedy_decode as jax_greedy
from megreader_tpu.ops.ctc2d import fuse_heights as jax_fuse
from megreader_tpu.ops.ctc2d import ctc2d_loss_independent as jax_loss_independent
from megreader_tpu.ops.ctc2d import ctc2d_loss_markov as jax_loss_markov
from megreader_tpu.ops.ctc2d import ctc2d_viterbi_height_decode as jax_viterbi
from megreader_tpu.ops.pallas_ctc2d import ctc2d_loss_markov_pallas
from megreader_tpu_torch.ops import ctc2d

B, T, H, C, L = 11, 10, 4, 6, 4
NO_ALIGNMENT = [3, 4, 5]


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _case(seed=0):
    """(emit, trans, init, height, logit_lengths, labels, label_lengths)."""
    rng = np.random.default_rng(seed)
    emit = _log_softmax(2.0 * rng.standard_normal((B, T, H, C)))
    trans = _log_softmax(rng.standard_normal((B, T, H, H)))
    init = _log_softmax(rng.standard_normal((B, H)))
    height = _log_softmax(rng.standard_normal((B, T, H)))
    label_lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    logit_lengths = rng.integers(2 * L + 1, T + 1, size=B).astype(np.int32)
    labels[0], label_lengths[0] = 0, 0  # empty label
    labels[1, 1:], label_lengths[1] = 0, 1
    labels[2], label_lengths[2] = [3, 3, 1, 1], L  # repeats: 6 steps at least
    labels[3], label_lengths[3], logit_lengths[3] = [2, 2, 2, 2], L, 6  # needs 7 steps
    labels[4], label_lengths[4], logit_lengths[4] = [1, 2, 3, 0], 3, 1  # 3 labels, 1 step
    labels[5], label_lengths[5], logit_lengths[5] = [1, 2, 3, 4], L, 3
    logit_lengths[6] = 1  # one step, one label
    labels[6, 1:], label_lengths[6] = 0, 1
    logit_lengths[7] = T
    return emit, trans, init, height, logit_lengths, labels, label_lengths


CASE = _case()
MARKOV = CASE[:3] + CASE[4:]
INDEPENDENT = (CASE[0], CASE[3]) + CASE[4:]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def test_case_covers_the_rows_it_names():
    *_, ll, lb, lbl = CASE
    words = [lb[b, :lbl[b]] for b in range(B)]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    aligned = lbl + repeats <= ll
    assert sorted(np.flatnonzero(~aligned)) == NO_ALIGNMENT
    assert {0, 1, L} <= set(lbl.tolist()) and 1 in ll and T in ll and B % 8


REDUCTIONS = ("none", "sum", "mean")


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's losses for each reduction and its gradients of the
    summed loss, jitted (one compile for the three reductions, one for the
    gradients)."""
    def losses(fn, args, **kw):
        f = jax.jit(lambda *a: {r: fn(*a, reduction=r, **kw) for r in REDUCTIONS})
        return jax.device_get(f(*_jax(args)))

    def grads(fn, args, n, **kw):
        rest = _jax(args[n:])
        f = jax.jit(jax.grad(lambda *x: fn(*x, *rest, reduction="sum", **kw),
                             argnums=tuple(range(n))))
        return [np.asarray(g) for g in f(*_jax(args[:n]))]

    return {
        "xla": losses(jax_loss_markov, MARKOV),
        "pallas": losses(ctc2d_loss_markov_pallas, MARKOV, interpret=True),
        "xla_grads": grads(jax_loss_markov, MARKOV, 3),
        "pallas_grads": grads(ctc2d_loss_markov_pallas, MARKOV, 3, interpret=True),
        "independent": losses(jax_loss_independent, INDEPENDENT),
        "independent_grads": grads(jax_loss_independent, INDEPENDENT, 2),
    }


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_plain_markov_loss_matches_jax_xla_and_pallas(jax_ref, reduction):
    got = ctc2d.ctc2d_loss_markov(*_torch(MARKOV), reduction=reduction).numpy()
    np.testing.assert_allclose(got, jax_ref["xla"][reduction], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, jax_ref["pallas"][reduction], rtol=1e-4, atol=1e-4)
    if reduction == "none":
        assert np.isfinite(got).all()
        assert (got[NO_ALIGNMENT] > 1e29).all()
        assert (np.delete(got, NO_ALIGNMENT) < 1e3).all()


@pytest.fixture(scope="module")
def port_grads():
    """d(sum of losses)/d (emit, trans, init) through the plain version."""
    leaves = [t.requires_grad_() for t in _torch(MARKOV[:3])]
    ctc2d.ctc2d_loss_markov(*leaves, *_torch(MARKOV[3:]), reduction="sum").backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("leaf", ["emit", "trans", "init"])
def test_plain_markov_gradient_matches_jax_xla_and_pallas(jax_ref, port_grads, leaf):
    """Against Pallas only on rows with an alignment: for a row without one,
    the Pallas alpha-beta pass takes exp(alpha + beta - logZ) of sentinels
    (with its state mask added) and gives another gradient than the XLA scan,
    which the plain version and the CUDA kernels follow."""
    k = ["emit", "trans", "init"].index(leaf)
    got, ref, pal = port_grads[k], jax_ref["xla_grads"][k], jax_ref["pallas_grads"][k]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    aligned = np.setdiff1d(np.arange(B), NO_ALIGNMENT)
    np.testing.assert_allclose(got[aligned], pal[aligned], rtol=2e-3, atol=2e-4)


def test_no_alignment_gradient_pattern(jax_ref, port_grads):
    """The XLA scan's gradient of a row with no alignment: -1/(2H) on the
    emission of the two terminal states' classes at the row's last step, at
    every height; -1/H^2 on every transition of that step; 0 elsewhere and on
    the initial heights (row 4 has one step, where both terminal states are
    constants: no gradient at all)."""
    ge, gt, gi = port_grads
    *_, ll, lb, lbl = CASE
    for b in NO_ALIGNMENT:
        t_last = int(ll[b]) - 1
        expect_e = np.zeros((T, H, C), np.float32)
        expect_t = np.zeros((T, H, H), np.float32)
        if t_last > 0:
            expect_e[t_last, :, 0] -= 0.5 / H
            expect_e[t_last, :, lb[b, lbl[b] - 1]] -= 0.5 / H
            expect_t[t_last] = -1.0 / H**2
        np.testing.assert_allclose(ge[b], expect_e, rtol=0, atol=1e-7)
        np.testing.assert_allclose(gt[b], expect_t, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(gi[b], 0.0)
        np.testing.assert_allclose(jax_ref["xla_grads"][0][b], expect_e, rtol=0, atol=1e-7)
        np.testing.assert_allclose(jax_ref["xla_grads"][1][b], expect_t, rtol=0, atol=1e-7)


def test_transitions_of_column_0_and_frozen_columns_get_no_gradient(port_grads):
    ge, gt, _ = port_grads
    ll = CASE[4]
    np.testing.assert_array_equal(gt[:, 0], 0.0)
    for b in range(B):
        np.testing.assert_array_equal(gt[b, ll[b]:], 0.0)
        np.testing.assert_array_equal(ge[b, ll[b]:], 0.0)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_plain_independent_loss_and_gradient_match_jax(jax_ref, reduction):
    leaves = [t.requires_grad_() for t in _torch(INDEPENDENT[:2])]
    got = ctc2d.ctc2d_loss_independent(*leaves, *_torch(INDEPENDENT[2:]), reduction=reduction)
    np.testing.assert_allclose(got.detach().numpy(), jax_ref["independent"][reduction],
                               rtol=1e-4, atol=1e-4)
    if reduction == "sum":
        got.backward()
        for leaf, g in zip(leaves, jax_ref["independent_grads"]):
            np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=2e-3, atol=2e-4)


def test_fuse_heights_matches_jax():
    ref = np.asarray(jax.jit(jax_fuse)(*_jax(INDEPENDENT[:2])))
    got = ctc2d.fuse_heights(*_torch(INDEPENDENT[:2])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("decode", ["greedy", "viterbi"])
def test_decodes_match_jax_exactly(decode):
    """Bit-equal ids and lengths, logit lengths from 1 to T."""
    emit, trans, init, height, ll = CASE[:5]
    if decode == "greedy":
        args = (emit, height, ll)
        ref = jax_greedy(*_jax(args))
        got = ctc2d.ctc2d_greedy_decode(*_torch(args))
    else:
        args = (emit, trans, init, ll)
        ref = jax_viterbi(*_jax(args))
        got = ctc2d.ctc2d_viterbi_height_decode(*_torch(args))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[1].max()) > 0


def test_cpu_tensor_takes_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA wrapper called for a CPU tensor")

    monkeypatch.setattr(ctc2d, "ctc2d_nll_markov_cuda", boom)
    # the choice follows the tensor's device, not whether a card is present
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = _torch(MARKOV)
    got = ctc2d.ctc2d_loss_markov(*args, reduction="none")
    ref = ctc2d.ctc2d_nll_markov_reference(*args)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _meta_args():
    b, t, h, c, lab = 2, 5, 3, 4, 2
    return (torch.zeros((b, t, h, c), device="meta"),
            torch.zeros((b, t, h, h), device="meta"),
            torch.zeros((b, h), device="meta"),
            torch.zeros((b,), dtype=torch.int32, device="meta"),
            torch.zeros((b, lab), dtype=torch.int32, device="meta"),
            torch.zeros((b,), dtype=torch.int32, device="meta"))


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    monkeypatch.setattr(ctc2d, "ctc2d_nll_markov_reference",
                        lambda *a, **k: pytest.fail("plain version used for a non-CPU tensor"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc2d.ctc2d_loss_markov(*_meta_args())


def test_launcher_error_propagates(monkeypatch):
    def launch_fails(*a, **k):
        raise RuntimeError("ctc2d alpha kernel: CUDA error 9 at launch")

    monkeypatch.setattr(ctc2d, "ctc2d_alpha_cuda", launch_fails)
    monkeypatch.setattr(ctc2d, "ctc2d_nll_markov_reference",
                        lambda *a, **k: pytest.fail("plain version used after a failed launch"))
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ctc2d.ctc2d_loss_markov(*_meta_args())


def test_cuda_branch_has_no_try():
    for fn in (ctc2d.ctc2d_nll_markov, ctc2d.ctc2d_nll_markov_cuda, ctc2d.ctc2d_alpha_cuda,
               ctc2d.ctc2d_beta_cuda, ctc2d._Ctc2dNll.forward, ctc2d._Ctc2dNll.backward):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__
