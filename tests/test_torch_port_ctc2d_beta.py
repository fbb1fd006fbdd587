"""Port 2D-CTC backward: the plain version of the beta kernel's own
arithmetic (``ctc2d_beta_reference``: the beta planes by the mirrored
recursion, then every gradient from alpha, beta and logZ) against autograd
through the plain forward, the JAX package's XLA scan and its Pallas kernels
(interpret mode, rows with an alignment only, as in
``tests/test_torch_port_ctc2d.py``); and the CUDA wrappers' host side on the
CPU, with a stand-in for the kernels' library: prototypes bound once, limits
computed once per shape, every malformed input refused on every call and a
shape beyond the kernels' limits refused before any launch.

Two label sets: the one of ``tests/test_torch_port_ctc2d.py`` (B 11, T 10,
H 4, C 6, L 4: logit lengths 1 to T, label lengths 0, 1 and L, repeats, three
rows without an alignment) and ``chip_smoke.ctc2d_inputs`` at a small batch
(B 12, T 16, H 3, C 37, labels padded to 32: word-like lengths, an empty
label, 32 labels in too few steps, a run of one class that needs more than T
steps). Each upstream gradient is a seeded weight per row. Tolerances are
the existing ones: gradients rtol 2e-3 / atol 2e-4 against JAX (the
Pallas comparison's), rtol 1e-3 / atol 1e-4 against autograd on the same
framework (``chip_smoke.py``'s)."""

import ast
import ctypes
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from megreader_tpu.ops.ctc2d import ctc2d_loss_markov as jax_loss_markov
from megreader_tpu.ops.pallas_ctc2d import ctc2d_loss_markov_pallas
from megreader_tpu_torch import kernels
from megreader_tpu_torch.ops import ctc2d


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _small_case():
    """The label set of tests/test_torch_port_ctc2d.py."""
    B, T, H, C, L = 11, 10, 4, 6, 4
    rng = np.random.default_rng(0)
    emit = _log_softmax(2.0 * rng.standard_normal((B, T, H, C)))
    trans = _log_softmax(rng.standard_normal((B, T, H, H)))
    init = _log_softmax(rng.standard_normal((B, H)))
    label_lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])
    logit_lengths = rng.integers(2 * L + 1, T + 1, size=B).astype(np.int32)
    labels[0], label_lengths[0] = 0, 0
    labels[1, 1:], label_lengths[1] = 0, 1
    labels[2], label_lengths[2] = [3, 3, 1, 1], L
    labels[3], label_lengths[3], logit_lengths[3] = [2, 2, 2, 2], L, 6
    labels[4], label_lengths[4], logit_lengths[4] = [1, 2, 3, 0], 3, 1
    labels[5], label_lengths[5], logit_lengths[5] = [1, 2, 3, 4], L, 3
    logit_lengths[6] = 1
    labels[6, 1:], label_lengths[6] = 0, 1
    logit_lengths[7] = T
    words = [labels[b, :label_lengths[b]] for b in range(B)]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    possible = label_lengths + repeats <= logit_lengths
    return emit, trans, init, logit_lengths, labels, label_lengths, possible


def _chip_smoke_case():
    """chip_smoke.ctc2d_inputs at a small batch."""
    return chip_smoke.ctc2d_inputs(np.random.default_rng(3), B=12, T=16, H=3, C=37, L=32)


CASES = {"small": _small_case(), "chip_smoke": _chip_smoke_case()}


def _weights(case):
    return np.random.default_rng(7).uniform(0.5, 2.0, len(case[3])).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, numpy inputs, upstream weights, the plain beta's gradients,
    autograd's gradients) for one label set."""
    name = request.param
    arrays = CASES[name]
    emit, trans, init, ll, lb, lbl = (torch.from_numpy(a) for a in arrays[:6])
    g = torch.from_numpy(_weights(arrays))
    with torch.no_grad():
        nll, alpha = ctc2d.ctc2d_alpha_reference(emit, trans, init, ll, lb, lbl)
        plain = ctc2d.ctc2d_beta_reference(emit, trans, ll, lb, lbl, alpha, nll, g)
    leaves = [t.clone().requires_grad_() for t in (emit, trans, init)]
    (ctc2d.ctc2d_nll_markov_reference(*leaves, ll, lb, lbl) * g).sum().backward()
    return name, arrays, g.numpy(), [p.numpy() for p in plain], [t.grad.numpy() for t in leaves]


@pytest.fixture(scope="module")
def jax_grads(case):
    """d(sum of weighted losses) / d (emit, trans, init) through the XLA scan
    and the Pallas kernels (interpret mode), jitted once each."""
    _, arrays, g, _, _ = case
    emit, trans, init, ll, lb, lbl = (jnp.asarray(a) for a in arrays[:6])
    gw = jnp.asarray(g)

    def grads(fn, **kw):
        f = jax.jit(jax.grad(lambda e, t, i: (fn(e, t, i, ll, lb, lbl, reduction="none", **kw)
                                               * gw).sum(), argnums=(0, 1, 2)))
        return [np.asarray(x) for x in f(emit, trans, init)]

    return {"xla": grads(jax_loss_markov), "pallas": grads(ctc2d_loss_markov_pallas,
                                                           interpret=True)}


LEAVES = ["emit", "trans", "init"]


def test_cases_hold_rows_without_an_alignment():
    for arrays in CASES.values():
        possible = arrays[-1]
        assert 0 < (~possible).sum() < len(possible) // 2


def test_alpha_reference_is_the_plain_forward():
    emit, trans, init, ll, lb, lbl = (torch.from_numpy(a) for a in CASES["small"][:6])
    nll, alpha = ctc2d.ctc2d_alpha_reference(emit, trans, init, ll, lb, lbl)
    assert alpha.shape == (11, 10, 4, 9)
    np.testing.assert_array_equal(
        nll.numpy(), ctc2d.ctc2d_nll_markov_reference(emit, trans, init, ll, lb, lbl).numpy())
    for b in range(11):  # frozen from the row's length on
        n = max(int(ll[b]), 1)
        np.testing.assert_array_equal(alpha[b, n:].numpy(),
                                      np.broadcast_to(alpha[b, n - 1].numpy(), alpha[b, n:].shape))


@pytest.mark.parametrize("leaf", LEAVES)
def test_plain_beta_matches_autograd(case, leaf):
    _, _, _, plain, auto = case
    k = LEAVES.index(leaf)
    np.testing.assert_allclose(plain[k], auto[k], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("leaf", LEAVES)
def test_plain_beta_matches_jax_xla_and_pallas(case, jax_grads, leaf):
    _, arrays, _, plain, _ = case
    k = LEAVES.index(leaf)
    np.testing.assert_allclose(plain[k], jax_grads["xla"][k], rtol=2e-3, atol=2e-4)
    aligned = np.flatnonzero(arrays[-1])
    np.testing.assert_allclose(plain[k][aligned], jax_grads["pallas"][k][aligned],
                               rtol=2e-3, atol=2e-4)


def test_plain_beta_no_alignment_pattern(case):
    """-1/(2H) of the row's weight on the emission of the two terminal
    states' classes at the row's last step, at every height; -1/H^2 on every
    transition of that step; 0 elsewhere and on the initial heights."""
    _, arrays, g, (ge, gt, gi), _ = case
    _, _, _, ll, lb, lbl, possible = arrays
    _, T, H, C = ge.shape
    for b in np.flatnonzero(~possible):
        t_last = min(int(ll[b]), T) - 1
        expect_e = np.zeros((T, H, C), np.float32)
        expect_t = np.zeros((T, H, H), np.float32)
        if t_last > 0:
            expect_e[t_last, :, 0] -= 0.5 / H * g[b]
            expect_e[t_last, :, lb[b, lbl[b] - 1]] -= 0.5 / H * g[b]
            expect_t[t_last] = -1.0 / H**2 * g[b]
        np.testing.assert_allclose(ge[b], expect_e, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gt[b], expect_t, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gi[b], 0.0)


def test_plain_beta_zero_frozen_steps_and_first_transitions(case):
    _, arrays, _, (ge, gt, _), _ = case
    ll = arrays[3]
    np.testing.assert_array_equal(gt[:, 0], 0.0)
    for b in range(len(ll)):
        np.testing.assert_array_equal(gt[b, ll[b]:], 0.0)
        np.testing.assert_array_equal(ge[b, ll[b]:], 0.0)


def test_plain_beta_gives_nan_for_a_bad_label():
    emit, trans, init, ll, lb, lbl = (torch.from_numpy(a.copy()) for a in CASES["small"][:6])
    lb[7, 0] = 99
    g = torch.ones(len(ll))
    nll, alpha = ctc2d.ctc2d_alpha_reference(emit, trans, init, ll, lb.clamp(max=5), lbl)
    nll[7] = float("nan")
    ge, gt, gi = ctc2d.ctc2d_beta_reference(emit, trans, ll, lb, lbl, alpha, nll, g)
    assert torch.isnan(ge[7, :ll[7]]).all() and torch.isnan(gi[7]).all()
    assert torch.isfinite(ge[8]).all()


def test_autograd_function_takes_the_initial_heights_from_the_beta_kernel(monkeypatch):
    """The Function's backward returns the beta wrapper's three gradients
    (the kernel writes grad_init; no further reduction), here with the
    wrappers standing in by the plain versions on CPU tensors."""
    calls = []

    def alpha(*a):
        with torch.no_grad():
            return ctc2d.ctc2d_alpha_reference(*a)

    def beta(*a):
        calls.append(1)
        return ctc2d.ctc2d_beta_reference(*a)

    monkeypatch.setattr(ctc2d, "ctc2d_alpha_cuda", alpha)
    monkeypatch.setattr(ctc2d, "ctc2d_beta_cuda", beta)
    emit, trans, init, ll, lb, lbl = (torch.from_numpy(a) for a in CASES["small"][:6])
    leaves = [t.clone().requires_grad_() for t in (emit, trans, init)]
    ctc2d.ctc2d_nll_markov_cuda(*leaves, ll, lb, lbl).sum().backward()
    ref = [t.clone().requires_grad_() for t in (emit, trans, init)]
    ctc2d.ctc2d_nll_markov_reference(*ref, ll, lb, lbl).sum().backward()
    assert calls == [1]
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=1e-3, atol=1e-4)


# --- the wrappers' host side, with a stand-in for the kernels' library ----


class _FakeFn:
    """A C function: counts calls and how often its prototype is set."""

    def __init__(self, result):
        object.__setattr__(self, "result", result)
        object.__setattr__(self, "calls", [])
        object.__setattr__(self, "prototype_sets", 0)

    def __setattr__(self, name, value):
        assert name in ("argtypes", "restype"), name
        object.__setattr__(self, "prototype_sets", self.prototype_sets + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.result(*args) if callable(self.result) else self.result


class _FakeLib:
    def __init__(self):
        self.mr_ctc2d_smem = _FakeFn(lambda beta, T, H, L, C: 4 * T * H * (C + H + 2 * (2 * L + 1)))
        self.mr_ctc2d_max_heights = _FakeFn(8)
        self.mr_ctc2d_max_states = _FakeFn(128)
        self.mr_ctc2d_alpha_launch = _FakeFn(0)
        self.mr_ctc2d_beta_launch = _FakeFn(0)


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    loaded = []
    monkeypatch.setattr(kernels, "library", lambda name: loaded.append(name) or lib)
    monkeypatch.setattr(kernels, "_bound", {})
    monkeypatch.setattr(ctc2d, "_require_cuda", lambda t: None)
    monkeypatch.setattr(ctc2d, "_launch", lambda fn, dev, *args: fn(*args, 0))
    monkeypatch.setattr(ctc2d.ctc2d_alpha_cuda, "launches", 0)
    monkeypatch.setattr(ctc2d.ctc2d_beta_cuda, "launches", 0)
    ctc2d._shared_bytes.cache_clear()
    yield lib, loaded
    ctc2d._shared_bytes.cache_clear()


def _inputs(B=3, T=5, H=4, C=7, L=3):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    i = lambda *s: torch.from_numpy(rng.integers(1, C, size=s).astype(np.int32))  # noqa: E731
    return {"emit": f(B, T, H, C), "trans": f(B, T, H, H), "init": f(B, H),
            "ll": torch.full((B,), T, dtype=torch.int32), "lb": i(B, L),
            "lbl": torch.full((B,), L, dtype=torch.int32), "alpha": f(B, T, H, 2 * L + 1),
            "nll": f(B), "g": f(B)}


def _alpha(x):
    return ctc2d.ctc2d_alpha_cuda(x["emit"], x["trans"], x["init"], x["ll"], x["lb"], x["lbl"])


def _beta(x):
    return ctc2d.ctc2d_beta_cuda(x["emit"], x["trans"], x["ll"], x["lb"], x["lbl"], x["alpha"],
                                 x["nll"], x["g"])


def test_prototypes_bound_once_and_limits_once_per_shape(fake_lib):
    lib, loaded = fake_lib
    x = _inputs()
    for _ in range(3):
        nll, alpha = _alpha(x)
        ge, gt, gi = _beta(x)
    assert loaded == ["ctc2d"]
    for name in ("mr_ctc2d_smem", "mr_ctc2d_max_heights", "mr_ctc2d_max_states",
                 "mr_ctc2d_alpha_launch", "mr_ctc2d_beta_launch"):
        assert getattr(lib, name).prototype_sets == 2, name  # argtypes and restype, once
    assert len(lib.mr_ctc2d_smem.calls) == 2  # alpha's and beta's, for (T, H, L, C) once
    assert len(lib.mr_ctc2d_max_heights.calls) == 1
    assert len(lib.mr_ctc2d_alpha_launch.calls) == 3 and len(lib.mr_ctc2d_beta_launch.calls) == 3
    assert (ctc2d.ctc2d_alpha_cuda.launches, ctc2d.ctc2d_beta_cuda.launches) == (3, 3)
    assert alpha.shape == (3, 5, 4, 7) and gi.shape == (3, 4) and gt.shape == (3, 5, 4, 4)
    _alpha(_inputs(T=6))
    assert len(lib.mr_ctc2d_smem.calls) == 4  # a new shape, computed once more
    assert lib.mr_ctc2d_alpha_launch.prototype_sets == 2


def test_wrappers_pass_every_argument(fake_lib):
    lib, _ = fake_lib
    x = _inputs()
    nll, alpha = _alpha(x)
    ge, gt, gi = _beta(x)
    a = lib.mr_ctc2d_alpha_launch.calls[0]
    assert a[:6] == tuple(x[k].data_ptr() for k in ("emit", "trans", "init", "ll", "lb", "lbl"))
    assert a[6:12] == (3, 5, 4, 7, 3, 0)
    assert a[12:] == (alpha.data_ptr(), nll.data_ptr(), 0)
    b = lib.mr_ctc2d_beta_launch.calls[0]
    assert b[:5] == tuple(x[k].data_ptr() for k in ("emit", "trans", "ll", "lb", "lbl"))
    assert b[5:11] == (3, 5, 4, 7, 3, 0)
    assert b[11:] == tuple(t.data_ptr() for t in (x["alpha"], x["nll"], x["g"], ge, gt, gi)) + (0,)


MALFORMED = {
    "emit float64": lambda x: x.update(emit=x["emit"].double()),
    "emit 3-d": lambda x: x.update(emit=x["emit"][:, :, 0]),
    "trans shape": lambda x: x.update(trans=x["trans"][:, :, :3].contiguous()),
    "trans device": lambda x: x.update(trans=x["trans"].to("meta")),
    "init dtype": lambda x: x.update(init=x["init"].half()),
    "labels int64": lambda x: x.update(lb=x["lb"].long()),
    "labels not contiguous": lambda x: x.update(lb=x["lb"].t().contiguous().t()),
    "logit_lengths shape": lambda x: x.update(ll=x["ll"][:2]),
    "emit not contiguous": lambda x: x.update(emit=x["emit"].transpose(2, 3).contiguous()
                                              .transpose(2, 3)),
    "blank out of range": None,
    "alpha shape": lambda x: x.update(alpha=x["alpha"][..., :5].contiguous()),
    "grad_nll dtype": lambda x: x.update(g=x["g"].double()),
}


@pytest.mark.parametrize("what", sorted(MALFORMED))
def test_malformed_input_raises_on_every_call(fake_lib, what):
    lib, _ = fake_lib
    x = _inputs()
    beta_only = what.startswith(("alpha", "grad_nll"))
    for _ in range(3):
        y = dict(x)
        if MALFORMED[what] is None:
            with pytest.raises(ValueError, match="blank"):
                ctc2d.ctc2d_alpha_cuda(y["emit"], y["trans"], y["init"], y["ll"], y["lb"],
                                       y["lbl"], blank=7)
            continue
        MALFORMED[what](y)
        if not beta_only:
            with pytest.raises((TypeError, ValueError)):
                _alpha(y)
        if what != "init dtype":
            with pytest.raises((TypeError, ValueError)):
                _beta(y)
    assert lib.mr_ctc2d_alpha_launch.calls == [] and lib.mr_ctc2d_beta_launch.calls == []


@pytest.mark.parametrize("shape,match", [
    ({"H": 9}, "heights"),
    ({"L": 64}, "states"),
    ({"T": 2000}, "shared memory"),
])
def test_shape_beyond_the_limits_raises_before_any_launch(fake_lib, shape, match):
    lib, _ = fake_lib
    x = _inputs(**shape)
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            _alpha(x)
        with pytest.raises(ValueError, match=match):
            _beta(x)
    assert lib.mr_ctc2d_alpha_launch.calls == [] and lib.mr_ctc2d_beta_launch.calls == []
    assert (ctc2d.ctc2d_alpha_cuda.launches, ctc2d.ctc2d_beta_cuda.launches) == (0, 0)


def test_a_cpu_tensor_is_refused_by_the_wrappers():
    x = _inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        _alpha(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _beta(x)


def test_host_side_has_no_try():
    for fn in (ctc2d._launch, ctc2d._shared_bytes.__wrapped__, ctc2d._check, kernels.functions):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__


def test_prototypes_match_the_launchers():
    """Pointers as c_void_p (a 64-bit address), ints as c_int, in the order
    of csrc/ctc2d.cu's extern "C" signatures."""
    src = (kernels.CSRC / "ctc2d.cu").read_text()
    for name, (argtypes, restype) in ctc2d._PROTOTYPES.items():
        sig = src[src.index(f" {name}("):].split(")")[0].split("(", 1)[1]
        params = [p.strip() for p in sig.split(",") if p.strip()]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert list(argtypes) == want, name
