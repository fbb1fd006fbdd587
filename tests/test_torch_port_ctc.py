"""Port CTC loss: the plain version against the JAX package's XLA loss and its
Pallas kernels (interpret mode, as ``tests/test_pallas_ctc.py`` runs them), and
the wrapper's dispatch (plain version only for CPU tensors, no fallback on the
CUDA branch). The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against the plain version there).

Tolerances are those of ``tests/test_pallas_ctc.py``: loss rtol 1e-4 / atol
1e-4, gradient rtol 1e-3 / atol 1e-4 (a log-space DP summed in another
order)."""

import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from megreader_tpu.ops.pallas_ctc import ctc_loss_pallas
from megreader_tpu_torch.ops import ctc


def _random_case(seed, B, T, C, L, short_logits=False):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, T, C)) * 2.0).astype(np.float32)
    label_lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    low = 2 * L + 1 if short_logits else T
    logit_lengths = rng.integers(low, T + 1, size=B).astype(np.int32)
    return logits, logit_lengths, labels, label_lengths


def _variable_logit_lengths():
    case = _random_case(0, B=5, T=12, C=7, L=4, short_logits=True)
    assert (case[1] < 12).any()
    return case


def _label_lengths_0_1_L():
    logits, logit_lengths, labels, _ = _random_case(1, B=4, T=10, C=6, L=3)
    label_lengths = np.array([0, 1, 3, 3], np.int32)
    labels[0] = 0
    labels[1, 1:] = 0
    return logits, logit_lengths, labels, label_lengths


def _repeated_labels():
    logits, _, _, _ = _random_case(2, B=3, T=10, C=6, L=4)
    labels = np.array([[2, 2, 2, 0], [3, 3, 1, 1], [4, 4, 0, 0]], np.int32)
    label_lengths = np.array([3, 4, 2], np.int32)
    logit_lengths = np.array([10, 8, 4], np.int32)  # row 2 needs exactly 3 steps
    return logits, logit_lengths, labels, label_lengths


def _batch_not_multiple_of_8():
    return _random_case(3, B=11, T=9, C=5, L=3, short_logits=True)


def _impossible_alignment():
    logits, logit_lengths, labels, label_lengths = _random_case(4, B=3, T=8, C=5, L=4)
    labels[1] = [1, 1, 1, 1]  # needs 7 steps: 4 labels and 3 blanks between repeats
    label_lengths[1] = 4
    logit_lengths[1] = 5
    return logits, logit_lengths, labels, label_lengths


CASES = {
    "variable_logit_lengths": _variable_logit_lengths,
    "label_lengths_0_1_L": _label_lengths_0_1_L,
    "repeated_labels": _repeated_labels,
    "batch_not_multiple_of_8": _batch_not_multiple_of_8,
    "impossible_alignment": _impossible_alignment,
}
IMPOSSIBLE_ROWS = {"impossible_alignment": [1]}


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_loss_matches_jax_xla_and_pallas(case, reduction):
    args = CASES[case]()
    ref = np.asarray(jax_ctc_loss(*_jax(args), reduction=reduction))
    pallas = np.asarray(ctc_loss_pallas(*_jax(args), reduction=reduction, interpret=True))
    got = ctc.ctc_loss(*_torch(args), reduction=reduction).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    if reduction == "none":
        impossible = IMPOSSIBLE_ROWS.get(case, [])
        assert np.isfinite(got).all()
        assert (got[impossible] > 1e29).all()
        assert (np.delete(got, impossible) < 1e3).all()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_gradient_matches_jax_xla_and_pallas(case):
    """d(sum of losses)/d logits. Against Pallas only on rows that have an
    alignment: for a row without one, the Pallas alpha-beta pass takes
    exp(alpha + beta - logZ) of three sentinels and gives another gradient
    than the XLA scan, which (like the plain version and the CUDA kernel)
    gives -1/2 at the two terminal states of the last step."""
    logits, ll, lb, lbl = CASES[case]()
    rest = (ll, lb, lbl)
    g_ref = np.asarray(jax.grad(
        lambda x: jax_ctc_loss(x, *_jax(rest), reduction="sum"))(jnp.asarray(logits)))
    g_pal = np.asarray(jax.grad(
        lambda x: ctc_loss_pallas(x, *_jax(rest), reduction="sum", interpret=True)
    )(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    ctc.ctc_loss(x, *_torch(rest), reduction="sum").backward()
    got = x.grad.numpy()
    np.testing.assert_allclose(got, g_ref, rtol=1e-3, atol=1e-4)
    possible = np.setdiff1d(np.arange(len(logits)), IMPOSSIBLE_ROWS.get(case, []))
    np.testing.assert_allclose(got[possible], g_pal[possible], rtol=1e-3, atol=1e-4)


def test_impossible_row_gradient_is_half_at_the_terminal_states():
    logits, ll, lb, lbl = _impossible_alignment()
    lp = torch.log_softmax(torch.from_numpy(logits), -1).requires_grad_()
    ctc.ctc_nll(lp, *_torch((ll, lb, lbl))).sum().backward()
    g = lp.grad[1].numpy()
    t_last = int(ll[1]) - 1
    expect = np.zeros_like(g)
    expect[t_last, 0] = expect[t_last, lb[1, -1]] = -0.5
    np.testing.assert_array_equal(g, expect)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA wrapper called for a CPU tensor")

    monkeypatch.setattr(ctc, "ctc_nll_cuda", boom)
    # the choice follows the tensor's device, not whether a card is present
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = _torch(_repeated_labels())
    got = ctc.ctc_loss(*args, reduction="none")
    ref = ctc.ctc_loss_reference(*args, reduction="none")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _meta_args():
    B, T, C, L = 2, 5, 4, 2
    return (torch.zeros((B, T, C), device="meta"),
            torch.zeros((B,), dtype=torch.int32, device="meta"),
            torch.zeros((B, L), dtype=torch.int32, device="meta"),
            torch.zeros((B,), dtype=torch.int32, device="meta"))


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    monkeypatch.setattr(ctc, "ctc_nll_reference",
                        lambda *a, **k: pytest.fail("plain version used for a non-CPU tensor"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc.ctc_loss(*_meta_args())


def test_launcher_error_propagates(monkeypatch):
    def launch_fails(*a, **k):
        raise RuntimeError("ctc alpha kernel: CUDA error 9 at launch")

    monkeypatch.setattr(ctc, "ctc_alpha_cuda", launch_fails)
    monkeypatch.setattr(ctc, "ctc_nll_reference",
                        lambda *a, **k: pytest.fail("plain version used after a failed launch"))
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ctc.ctc_loss(*_meta_args())


def test_cuda_branch_has_no_try():
    for fn in (ctc.ctc_nll, ctc.ctc_nll_cuda, ctc.ctc_alpha_cuda, ctc.ctc_beta_cuda,
               ctc._CtcNll.forward, ctc._CtcNll.backward):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__
