"""Port CTC backward: the plain version of the beta kernel's own arithmetic
(``ctc_beta_reference``: the beta planes by the mirrored recursion, then the
class gradient from alpha, beta and logZ) against autograd through the plain
forward, the JAX package's XLA scan and its Pallas kernels (interpret mode,
rows with an alignment only, as in ``tests/test_torch_port_ctc.py``); and the
CUDA wrappers' host side on the CPU, with a stand-in for the kernels'
library: prototypes bound once, the instance and limits computed once per
shape, every malformed input refused on every call and a shape beyond the
kernels' limits refused before any launch.

Label sets: those of ``tests/test_torch_port_ctc.py`` (logit lengths below
T, label lengths 0, 1 and L, repeats, a row without an alignment),
``chip_smoke.ctc_inputs`` at a small batch (B 12, T 25, C 37, labels padded
to 32: word-like lengths, an empty label, 32 labels in 25 steps, 14 repeats)
and ``chip_smoke.ctc_long_inputs`` at B 4, T 150, C 9, L 70 (S = 141: more
than one column of 32 states, and more than 128). Each upstream gradient is
a seeded weight per row. Tolerances are those of
``tests/test_torch_port_ctc.py``: gradients rtol 1e-3 / atol 1e-4."""

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
import test_torch_port_ctc as port_ctc
from megreader_tpu.ops.ctc import ctc_alpha_scan
from megreader_tpu.ops.pallas_ctc import _ctc_nll_pallas
from megreader_tpu_torch import kernels
from megreader_tpu_torch.ops import ctc, ctc2d


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _possible(ll, lb, lbl):
    """Rows whose labels, with a blank between equal neighbours, fit in
    their steps."""
    words = [lb[b, :lbl[b]] for b in range(len(lbl))]
    repeats = np.array([int((w[1:] == w[:-1]).sum()) for w in words])
    return lbl + repeats <= ll


def _case(logits, ll, lb, lbl):
    return _log_softmax(logits), ll, lb, lbl, _possible(ll, lb, lbl)


CASES = {name: _case(*make()) for name, make in port_ctc.CASES.items()}
CASES["chip_smoke"] = _case(*chip_smoke.ctc_inputs(np.random.default_rng(3), B=12, T=25, C=37,
                                                   L=32)[:4])
CASES["long"] = _case(*chip_smoke.ctc_long_inputs(np.random.default_rng(5), B=4, T=150, C=9,
                                                  L=70)[:4])


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, numpy inputs, upstream weights, the plain beta's gradient,
    autograd's gradient) for one label set."""
    name = request.param
    arrays = CASES[name]
    lp, ll, lb, lbl = _torch(arrays[:4])
    g = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 2.0, len(ll)).astype(np.float32))
    with torch.no_grad():
        nll, alpha = ctc.ctc_alpha_reference(lp, ll, lb, lbl)
        plain = ctc.ctc_beta_reference(lp, ll, lb, lbl, alpha, nll, g)
    leaf = lp.clone().requires_grad_()
    (ctc.ctc_nll_reference(leaf, ll, lb, lbl) * g).sum().backward()
    return name, arrays, g.numpy(), plain.numpy(), leaf.grad.numpy()


@pytest.fixture(scope="module")
def jax_grads(case):
    """d(sum of weighted losses) / d log_probs through the XLA scan and the
    Pallas kernels (interpret mode), jitted once each."""
    _, arrays, g, _, _ = case
    lp, ll, lb, lbl = (jnp.asarray(a) for a in arrays[:4])
    gw = jnp.asarray(g)
    xla = jax.jit(jax.grad(lambda x: (ctc_alpha_scan(x, ll, lb, lbl)[0] * gw).sum()))
    pallas = jax.jit(jax.grad(lambda x: (_ctc_nll_pallas(x, ll, lb, lbl, 0, True) * gw).sum()))
    return {"xla": np.asarray(xla(lp)), "pallas": np.asarray(pallas(lp))}


def test_cases_cover_the_kernel_paths():
    """Rows without an alignment, frozen steps, an empty label, and rows
    with more than one column of 32 states (and more than 128 states)."""
    for name in ("impossible_alignment", "chip_smoke", "long"):
        assert 0 < (~CASES[name][-1]).sum() <= len(CASES[name][-1]) // 2, name
    assert (CASES["chip_smoke"][3] == 0).any() and (CASES["long"][3] == 0).any()
    lp, ll, _, lbl, possible = CASES["long"]
    live_states = 2 * lbl[possible] + 1
    assert (live_states > 32).sum() >= 2 and (live_states > 128).any()
    assert (ll < lp.shape[1]).any()


def test_alpha_reference_is_the_plain_forward():
    lp, ll, lb, lbl = _torch(CASES["variable_logit_lengths"][:4])
    nll, alpha = ctc.ctc_alpha_reference(lp, ll, lb, lbl)
    B, T, _ = lp.shape
    assert alpha.shape == (B, T, 2 * lb.shape[1] + 1)
    np.testing.assert_array_equal(nll.numpy(), ctc.ctc_nll_reference(lp, ll, lb, lbl).numpy())
    for b in range(B):  # frozen from the row's length on
        n = max(int(ll[b]), 1)
        np.testing.assert_array_equal(alpha[b, n:].numpy(),
                                      np.broadcast_to(alpha[b, n - 1].numpy(), alpha[b, n:].shape))


def test_plain_beta_matches_autograd(case):
    _, _, _, plain, auto = case
    np.testing.assert_allclose(plain, auto, rtol=1e-3, atol=1e-4)


def test_plain_beta_matches_jax_xla_and_pallas(case, jax_grads):
    _, arrays, _, plain, _ = case
    np.testing.assert_allclose(plain, jax_grads["xla"], rtol=1e-3, atol=1e-4)
    aligned = np.flatnonzero(arrays[-1])
    np.testing.assert_allclose(plain[aligned], jax_grads["pallas"][aligned], rtol=1e-3, atol=1e-4)


def test_plain_beta_no_alignment_pattern(case):
    """-1/2 of the row's weight at the blank and at the last label's class
    at the row's last step (nothing when that step is t = 0), 0 elsewhere."""
    _, arrays, g, plain, _ = case
    lp, ll, lb, lbl, possible = arrays
    _, T, C = lp.shape
    for b in np.flatnonzero(~possible):
        t_last = min(max(int(ll[b]), 1), T) - 1
        expect = np.zeros((T, C), np.float32)
        if t_last > 0:
            expect[t_last, 0] -= 0.5 * g[b]
            expect[t_last, lb[b, lbl[b] - 1]] -= 0.5 * g[b]
        np.testing.assert_allclose(plain[b], expect, rtol=0, atol=1e-6)


def test_plain_beta_zero_frozen_steps(case):
    _, arrays, _, plain, _ = case
    ll = arrays[1]
    for b in range(len(ll)):
        np.testing.assert_array_equal(plain[b, max(int(ll[b]), 1):], 0.0)


def test_plain_beta_gives_nan_for_a_bad_label():
    lp, ll, lb, lbl = _torch(CASES["chip_smoke"][:4])
    b = 5  # a row with frozen steps
    assert int(ll[b]) < lp.shape[1]
    with torch.no_grad():
        nll, alpha = ctc.ctc_alpha_reference(lp, ll, lb, lbl)
    lb = lb.clone()
    lb[b, 0] = 99
    nll[b] = float("nan")
    grad = ctc.ctc_beta_reference(lp, ll, lb, lbl, alpha, nll, torch.ones(len(ll)))
    assert torch.isnan(grad[b, :int(ll[b])]).all()
    assert (grad[b, int(ll[b]):] == 0).all()
    assert torch.isfinite(grad[np.arange(len(ll)) != b]).all()


def test_plain_beta_holds_float64_at_a_long_row():
    """At T 1,000 the loss reaches about 2,000, where float32 carries about
    1e-4 in each step of a recursion on beta itself (the gradient would then
    miss by 2e-3); the recursion runs on beta less a float64 offset and the
    occupancy's exponent is summed in float64, so the gradient from the
    float64 forward's alpha and loss (rounded to float32) holds the float64
    gradient at the tolerance above."""
    arrays = _case(*chip_smoke.ctc_long_inputs(np.random.default_rng(9), B=3, T=1000, C=9,
                                               L=300)[:4])
    lp, ll, lb, lbl = _torch(arrays[:4])
    x = lp.double().requires_grad_()
    nll64, alpha64 = ctc.ctc_alpha_reference(x, ll, lb, lbl)
    nll64.sum().backward()
    grad = ctc.ctc_beta_reference(lp, ll, lb, lbl, alpha64.detach().float(),
                                  nll64.detach().float(), torch.ones(3))
    assert float(nll64.detach()[arrays[-1]].min()) > 1500
    np.testing.assert_allclose(grad.numpy(), x.grad.float().numpy(), rtol=1e-3, atol=1e-4)


def test_autograd_function_takes_the_beta_kernel(monkeypatch):
    """The Function's backward returns the beta wrapper's gradient, here with
    the wrappers standing in by the plain versions on CPU tensors."""
    calls = []

    def alpha(*a):
        with torch.no_grad():
            return ctc.ctc_alpha_reference(*a)

    def beta(*a):
        calls.append(1)
        return ctc.ctc_beta_reference(*a)

    monkeypatch.setattr(ctc, "ctc_alpha_cuda", alpha)
    monkeypatch.setattr(ctc, "ctc_beta_cuda", beta)
    lp, ll, lb, lbl = _torch(CASES["repeated_labels"][:4])
    leaf = lp.clone().requires_grad_()
    (ctc.ctc_nll_cuda(leaf, ll, lb, lbl) * torch.tensor([1.0, 2.0, 0.5])).sum().backward()
    ref = lp.clone().requires_grad_()
    (ctc.ctc_nll_reference(ref, ll, lb, lbl) * torch.tensor([1.0, 2.0, 0.5])).sum().backward()
    assert calls == [1]
    np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(), rtol=1e-3, atol=1e-4)


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


def _fake_smem(beta, shared, T, L, C):
    """Bytes of shared memory: the planes and slab in the shared instance,
    the class lists of the beta kernel."""
    S = 2 * L + 1
    planes = T * (C + (2 if beta else 1) * S) if shared else 0
    return 4 * (planes + (C + 2 * L if beta else 0) + 16)


class _FakeLib:
    def __init__(self):
        self.mr_ctc_smem = _FakeFn(_fake_smem)
        self.mr_ctc_max_states = _FakeFn(1024)
        self.mr_ctc_alpha_launch = _FakeFn(0)
        self.mr_ctc_beta_launch = _FakeFn(0)


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    loaded = []
    monkeypatch.setattr(kernels, "library", lambda name: loaded.append(name) or lib)
    monkeypatch.setattr(kernels, "_bound", {})
    monkeypatch.setattr(ctc, "_require_cuda", lambda t: None)
    monkeypatch.setattr(ctc, "_launch", lambda fn, dev, *args: fn(*args, 0))
    monkeypatch.setattr(ctc.ctc_alpha_cuda, "launches", 0)
    monkeypatch.setattr(ctc.ctc_beta_cuda, "launches", 0)
    ctc._plan.cache_clear()
    yield lib, loaded
    ctc._plan.cache_clear()


def _inputs(B=3, T=5, C=7, L=3):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return {"lp": f(B, T, C), "ll": torch.full((B,), T, dtype=torch.int32),
            "lb": torch.from_numpy(rng.integers(1, C, size=(B, L)).astype(np.int32)),
            "lbl": torch.full((B,), L, dtype=torch.int32), "alpha": f(B, T, 2 * L + 1),
            "nll": f(B), "g": f(B)}


def _alpha(x, **kw):
    return ctc.ctc_alpha_cuda(x["lp"], x["ll"], x["lb"], x["lbl"], **kw)


def _beta(x, **kw):
    return ctc.ctc_beta_cuda(x["lp"], x["ll"], x["lb"], x["lbl"], x["alpha"], x["nll"], x["g"],
                             **kw)


def test_prototypes_bound_once_and_limits_once_per_shape(fake_lib):
    lib, loaded = fake_lib
    x = _inputs()
    for _ in range(3):
        nll, alpha = _alpha(x)
        grad = _beta(x)
    assert loaded == ["ctc"]
    for name in ("mr_ctc_smem", "mr_ctc_max_states", "mr_ctc_alpha_launch",
                 "mr_ctc_beta_launch"):
        assert getattr(lib, name).prototype_sets == 2, name  # argtypes and restype, once
    assert len(lib.mr_ctc_smem.calls) == 4  # each kernel's two instances, for (T, L, C) once
    assert len(lib.mr_ctc_max_states.calls) == 1
    assert len(lib.mr_ctc_alpha_launch.calls) == 3 and len(lib.mr_ctc_beta_launch.calls) == 3
    assert (ctc.ctc_alpha_cuda.launches, ctc.ctc_beta_cuda.launches) == (3, 3)
    assert nll.shape == (3,) and alpha.shape == (3, 5, 7) and grad.shape == (3, 5, 7)
    _alpha(_inputs(T=6))
    assert len(lib.mr_ctc_smem.calls) == 8  # a new shape, computed once more
    assert lib.mr_ctc_alpha_launch.prototype_sets == 2


def test_wrappers_pass_every_argument(fake_lib):
    lib, _ = fake_lib
    x = _inputs()
    nll, alpha = _alpha(x, blank=2)
    grad = _beta(x, blank=2)
    a = lib.mr_ctc_alpha_launch.calls[0]
    assert a[:4] == tuple(x[k].data_ptr() for k in ("lp", "ll", "lb", "lbl"))
    assert a[4:10] == (3, 5, 7, 3, 2, 1)  # B, T, C, L, blank, planes in shared memory
    assert a[10:] == (alpha.data_ptr(), nll.data_ptr(), 0)
    b = lib.mr_ctc_beta_launch.calls[0]
    assert b[:4] == tuple(x[k].data_ptr() for k in ("lp", "ll", "lb", "lbl"))
    assert b[4:10] == (3, 5, 7, 3, 2, 1)
    assert b[10:] == tuple(t.data_ptr() for t in (x["alpha"], x["nll"], x["g"], grad)) + (None, 0)


def test_instance_chosen_by_shape(fake_lib):
    """Planes that do not fit in a block's shared memory go to device memory:
    the beta launcher then gets a (B, T, S) scratch buffer."""
    lib, _ = fake_lib
    T, L, C = 200, 100, 37
    assert _fake_smem(0, 1, T, L, C) <= kernels.SMEM_LIMIT < _fake_smem(1, 1, T, L, C)
    x = _inputs(T=T, C=C, L=L)
    _alpha(x)
    _beta(x)
    assert ctc._plan(T, L, C) == (True, False)
    assert lib.mr_ctc_alpha_launch.calls[0][9] == 1
    b = lib.mr_ctc_beta_launch.calls[0]
    assert b[9] == 0 and b[14] is not None and b[14] not in {t.data_ptr() for t in x.values()}


MALFORMED = {
    "log_probs float64": lambda x: x.update(lp=x["lp"].double()),
    "log_probs 2-d": lambda x: x.update(lp=x["lp"][:, 0]),
    "log_probs no class": lambda x: x.update(lp=x["lp"][:, :, :0]),
    "log_probs not contiguous": lambda x: x.update(lp=x["lp"].transpose(1, 2).contiguous()
                                                   .transpose(1, 2)),
    "labels int64": lambda x: x.update(lb=x["lb"].long()),
    "labels not contiguous": lambda x: x.update(lb=x["lb"].t().contiguous().t()),
    "labels device": lambda x: x.update(lb=x["lb"].to("meta")),
    "logit_lengths shape": lambda x: x.update(ll=x["ll"][:2]),
    "label_lengths dtype": lambda x: x.update(lbl=x["lbl"].float()),
    "blank out of range": None,
    "alpha shape": lambda x: x.update(alpha=x["alpha"][..., :5].contiguous()),
    "nll dtype": lambda x: x.update(nll=x["nll"].double()),
    "grad_nll not contiguous": lambda x: x.update(g=torch.zeros(6)[::2]),
}


@pytest.mark.parametrize("what", sorted(MALFORMED))
def test_malformed_input_raises_on_every_call(fake_lib, what):
    lib, _ = fake_lib
    x = _inputs()
    beta_only = what.startswith(("alpha", "nll", "grad_nll"))
    for _ in range(3):
        y = dict(x)
        if MALFORMED[what] is None:
            with pytest.raises(ValueError, match="blank"):
                _alpha(y, blank=7)
            with pytest.raises(ValueError, match="blank"):
                _beta(y, blank=-1)
            continue
        MALFORMED[what](y)
        if not beta_only:
            with pytest.raises((TypeError, ValueError)):
                _alpha(y)
        with pytest.raises((TypeError, ValueError)):
            _beta(y)
    assert lib.mr_ctc_alpha_launch.calls == [] and lib.mr_ctc_beta_launch.calls == []


@pytest.mark.parametrize("shape,match", [
    ({"L": 512}, "states"),
    ({"C": 60000, "T": 1}, "shared memory"),
])
def test_shape_beyond_the_limits_raises_before_any_launch(fake_lib, shape, match):
    lib, _ = fake_lib
    x = _inputs(**shape)
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            _alpha(x)
        with pytest.raises(ValueError, match=match):
            _beta(x)
    assert lib.mr_ctc_alpha_launch.calls == [] and lib.mr_ctc_beta_launch.calls == []
    assert (ctc.ctc_alpha_cuda.launches, ctc.ctc_beta_cuda.launches) == (0, 0)


def test_the_widest_accepted_shape_launches(fake_lib):
    """S = 1023 and 5,000 classes at T 2,000: both kernels in their
    device-memory instance."""
    lib, _ = fake_lib
    x = _inputs(B=1, T=2000, C=5000, L=511)
    _alpha(x)
    _beta(x)
    assert ctc._plan(2000, 511, 5000) == (False, False)
    assert len(lib.mr_ctc_alpha_launch.calls) == 1 and len(lib.mr_ctc_beta_launch.calls) == 1


def test_a_cpu_tensor_is_refused_by_the_wrappers():
    x = _inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        _alpha(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _beta(x)


def test_host_side_has_no_try():
    for fn in (kernels.launch, ctc._plan.__wrapped__, ctc._check, ctc._require_cuda,
               ctc.ctc_alpha_cuda, ctc.ctc_beta_cuda, kernels.functions):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), fn.__name__


def test_both_ctc_wrappers_launch_through_one_helper():
    assert ctc._launch is kernels.launch and ctc2d._launch is kernels.launch


def test_prototypes_match_the_launchers():
    """Pointers as c_void_p (a 64-bit address), ints as c_int, in the order
    of csrc/ctc.cu's extern "C" signatures."""
    src = (kernels.CSRC / "ctc.cu").read_text()
    for name, (argtypes, restype) in ctc._PROTOTYPES.items():
        sig = src[src.index(f" {name}("):].split(")")[0].split("(", 1)[1]
        params = [p.strip() for p in sig.split(",") if p.strip()]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert list(argtypes) == want, name
        assert restype == (ctypes.c_size_t if name == "mr_ctc_smem" else ctypes.c_int), name
