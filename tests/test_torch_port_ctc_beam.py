"""Port CTC prefix beam search against the JAX package, on the CPU.

``ops/ctc.py::ctc_beam_decode`` and ``blank_collapse_frames`` take the same
float32 logits as JAX's (made with numpy from a seed) and must give the same
ids and lengths, and the same compacted frames, kept lengths and pre-blank
values, exactly:

* logits shaped as ``scripts/bench_beam.py`` makes them (runs of confident
  blank frames, single peaked symbols; B 16, T 50, C 37, W 8) with varied
  logit lengths, at ``blank_collapse`` 1.0 and 0.999;
* rows of exactly tied logits (every class equal; two classes equal; a tie
  between blank and a symbol), where dead beams tie at the finite sentinel
  and only the tie order (lower index first, ``jax.lax.top_k``'s) decides
  which candidates survive;
* beam widths 1 and 16, and T 200 with prefixes of up to 60 symbols, whose
  rolling hashes wrap in int32.

Then the recognizers' ``decode(mode='beam')``: config #1's CTC recognizer and
the independent-heights 2D-CTC recognizer, on shared weights, with the nets in
float64 on both sides (both decodes take float32 logits), so that the logits
the beams see are the same."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.recognizer2d import Ctc2dRecognizer as JaxCtc2dRecognizer
from megreader_tpu.ops.ctc import blank_collapse_frames as jax_blank_collapse_frames
from megreader_tpu.ops.ctc import ctc_beam_decode as jax_ctc_beam_decode
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.models.recognizer2d import Ctc2dRecognizer
from megreader_tpu_torch.ops.ctc import (
    blank_collapse_frames,
    ctc_beam_decode,
    stable_top_k,
)


def bench_logits(rng, B, T, C, symbol_frames=0.38):
    """``scripts/bench_beam.py``'s logits: N(0, 1), then per row runs of 3-8
    frames with blank at 12, or single frames with a symbol at 9."""
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    for b in range(B):
        t = 0
        while t < T:
            if rng.random() >= symbol_frames:
                run = int(rng.integers(3, 9))
                logits[b, t:t + run, 0] = 12.0
                t += run
            else:
                logits[b, t, int(rng.integers(1, C))] = 9.0
                t += 1
    return logits


def _both(logits, lengths, **kw):
    """(JAX ids, lengths), (port ids, lengths) as numpy."""
    ref = jax.device_get(jax_ctc_beam_decode(jnp.asarray(logits), jnp.asarray(lengths), **kw))
    got = ctc_beam_decode(torch.from_numpy(logits), torch.from_numpy(lengths), **kw)
    return ref, tuple(g.numpy() for g in got)


def _assert_equal(ref, got):
    np.testing.assert_array_equal(got[1], ref[1], err_msg="lengths")
    np.testing.assert_array_equal(got[0], ref[0], err_msg="ids")


@pytest.mark.parametrize("collapse", [1.0, 0.999])
def test_beam_matches_jax_on_bench_logits(collapse):
    rng = np.random.default_rng(0)
    logits = bench_logits(rng, 16, 50, 37)
    lengths = rng.integers(10, 51, 16).astype(np.int32)
    lengths[:2] = 50
    ref, got = _both(logits, lengths, beam_width=8, blank_collapse=collapse)
    _assert_equal(ref, got)
    assert got[1].max() >= 5 and len(set(got[1].tolist())) > 3


@pytest.mark.parametrize("threshold", [0.999, 0.9])
def test_blank_collapse_frames_match_jax(threshold):
    rng = np.random.default_rng(1)
    logits = bench_logits(rng, 8, 50, 37)
    logits[3, :, 0] = 2.0  # a row with no dominated frame
    lengths = np.array([50, 50, 50, 50, 31, 17, 1, 0], np.int32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    ref = jax.device_get(jax_blank_collapse_frames(jnp.asarray(log_probs), jnp.asarray(lengths),
                                                   0, threshold))
    got = blank_collapse_frames(torch.from_numpy(log_probs.copy()), torch.from_numpy(lengths),
                                0, threshold)
    for what, r, g in zip(("frames", "kept", "pre_blank"), ref, got):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=what)
    assert 0 < int(got[1][:3].max()) < 50 and int(got[1][3]) == 50
    assert (got[2].numpy() > -1e29).any()


def tied_logits():
    """Rows whose every candidate score ties with another: all classes equal;
    two symbols equal and peaked; blank tied with a symbol; alternating equal
    pairs; a row of zeros after a peaked start."""
    B, T, C = 6, 20, 37
    logits = np.zeros((B, T, C), np.float32)
    logits[1, :, 3] = logits[1, :, 5] = 2.0
    logits[2, :, 0] = logits[2, :, 7] = 1.5
    logits[3, ::2, 4] = logits[3, ::2, 9] = 3.0
    logits[3, 1::2, 0] = 3.0
    logits[4, :5, 11] = 8.0
    logits[5, :, 1:3] = 0.5
    return logits


@pytest.mark.parametrize("collapse", [1.0, 0.999])
@pytest.mark.parametrize("width", [4, 8])
def test_beam_matches_jax_on_exact_ties(width, collapse):
    logits = tied_logits()
    lengths = np.full(len(logits), logits.shape[1], np.int32)
    ref, got = _both(logits, lengths, beam_width=width, blank_collapse=collapse)
    _assert_equal(ref, got)


def test_stable_top_k_puts_the_lower_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30, 0.5]])
    values, idx = stable_top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 6]]
    assert values.tolist() == [[3.0, 3.0, 3.0, 1.0, 0.5]]
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert np.asarray(ref_i).tolist() == idx.tolist()


@pytest.mark.parametrize("width", [1, 16])
def test_beam_matches_jax_at_widths_1_and_16(width):
    rng = np.random.default_rng(2)
    logits = np.concatenate([bench_logits(rng, 6, 40, 37),
                             2.0 * rng.standard_normal((4, 40, 37)).astype(np.float32)])
    lengths = np.array([40, 33, 40, 12, 40, 25, 40, 40, 19, 7], np.int32)
    ref, got = _both(logits, lengths, beam_width=width)
    _assert_equal(ref, got)


def test_beam_matches_jax_on_long_prefixes():
    """T 200, up to 60 symbols a row: every prefix of length 2 or more has
    wrapped its int32 hashes."""
    rng = np.random.default_rng(3)
    logits = bench_logits(rng, 6, 200, 37, symbol_frames=0.6)
    lengths = np.array([200, 200, 150, 200, 99, 200], np.int32)
    for collapse in (1.0, 0.999):
        ref, got = _both(logits, lengths, beam_width=8, blank_collapse=collapse)
        _assert_equal(ref, got)
        assert got[1].max() >= 40


def _crops(n=4, seed=4):
    return np.random.default_rng(seed).standard_normal((n, 32, 100, 3))


_FLAX_BATCH_NORM = flax.linen.BatchNorm


def _batch_norm_f64(*args, dtype=None, **kwargs):
    return _FLAX_BATCH_NORM(*args, **kwargs)


def _jax_decode_f64(model, variables, crops, **kw):
    """The JAX model's decode in float64 (its BatchNorm too), jitted."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", _batch_norm_f64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        run = jax.jit(lambda v, x: model.decode(v, x, **kw))
        return jax.device_get(run(v64, jnp.asarray(crops)))


def _sharpen(variables, head):
    """Class logits as sharp as a trained net's."""
    variables["params"][head]["kernel"] *= 8.0
    return variables


def test_ctc_recognizer_beam_matches_jax():
    rec = CTCRecognizer(37, hidden=32, num_encoder_layers=1, device="cpu")
    variables = _sharpen(seeded_flax_variables(export_flax_variables(rec.net), 5), "classifier")
    load_flax_variables(rec.net, variables)
    jm = JaxCTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)
    crops = _crops()
    ref = _jax_decode_f64(jm, variables, crops, mode="beam", beam_width=8)
    rec.net.to(torch.float64)
    got = rec.decode(torch.from_numpy(crops), mode="beam", beam_width=8)
    _assert_equal(ref, tuple(g.numpy() for g in got))
    assert got[1].max() > 0


def test_ctc2d_independent_beam_matches_jax():
    rec = Ctc2dRecognizer(37, transition="independent", width=8, device="cpu")
    variables = _sharpen(seeded_flax_variables(export_flax_variables(rec.net), 6), "class_head")
    load_flax_variables(rec.net, variables)
    jm = JaxCtc2dRecognizer(num_classes=37, transition="independent", width=8)
    crops = _crops(seed=7)
    for collapse in (1.0, 0.999):
        ref = _jax_decode_f64(jm, variables, crops, mode="beam", beam_width=8,
                              blank_collapse=collapse)
        rec.net.to(torch.float64)
        got = rec.decode(torch.from_numpy(crops), mode="beam", beam_width=8,
                         blank_collapse=collapse)
        _assert_equal(ref, tuple(g.numpy() for g in got))
        assert got[1].max() > 0
