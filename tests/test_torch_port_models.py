"""Port models against the flax modules on the same seeded weights.

The flax variables are redrawn from a numpy seed (``seeded_flax_variables``)
and carried into the port by ``load_flax_variables``; both sides then see the
same inputs, made with numpy. Float32 throughout, atol 1e-4: the two
frameworks sum convolutions and matmuls in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models.detector import SegDetectorNet as JaxSegDetectorNet
from megreader_tpu.models.recognizer import CTCRecognizerNet as JaxCTCRecognizerNet
from megreader_tpu.models.resnet import resnet_variant as jax_resnet_variant
from megreader_tpu.models.sequence import StackedBiLSTM as JaxStackedBiLSTM
from megreader_tpu.ops.ctc import ctc_greedy_decode as jax_ctc_greedy_decode
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.models.detector import SegDetectorNet
from megreader_tpu_torch.models.recognizer import CTCRecognizerNet
from megreader_tpu_torch.models.resnet import resnet_variant
from megreader_tpu_torch.models.sequence import StackedBiLSTM
from megreader_tpu_torch.ops.ctc import ctc_greedy_decode

ATOL = 1e-4


def _inputs(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _carry(jax_module, port_module, x, seed, **init_kw):
    # the seeded weights need init's shapes only
    init = jax.eval_shape(functools.partial(jax_module.init, **init_kw),
                          jax.random.PRNGKey(0), jnp.asarray(x))
    variables = seeded_flax_variables(init, seed)
    return variables, load_flax_variables(port_module.eval(), variables)


def _close(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant,shape", [("det", (2, 64, 96, 3)), ("rec", (3, 32, 100, 3))])
def test_resnet_matches_flax(variant, shape):
    x = _inputs(0, shape)
    jm = jax_resnet_variant("resnet18", variant, width=16)
    variables, tm = _carry(jm, resnet_variant("resnet18", variant, width=16), x, 1,
                           train=False)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    if variant == "rec":
        ref, got = (ref,), (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1).numpy(), r)


def test_detector_prob_head_matches_flax():
    """FPN + the plain MapHead against the JAX default (packed serving head)."""
    x = _inputs(2, (2, 64, 96, 3))
    jm = JaxSegDetectorNet("resnet18", fpn_dim=32, head_dim=16, width=16)
    variables, tm = _carry(jm, SegDetectorNet("resnet18", 32, 16, width=16), x, 3)
    ref = jm.apply(variables, jnp.asarray(x), heads=("prob",))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), heads=("prob",))
    assert set(got) == {"prob"}
    assert got["prob"].shape == (2, 64, 96)
    _close(got["prob"].numpy(), ref["prob"])


def test_bilstm_matches_flax():
    x = _inputs(4, (3, 11, 24))
    jm = JaxStackedBiLSTM(hidden=16, num_layers=2)
    variables, tm = _carry(jm, StackedBiLSTM(24, 16, 2), x, 5)
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), ref)


def test_recognizer_logits_match_flax():
    x = _inputs(6, (3, 32, 100, 3))
    jm = JaxCTCRecognizerNet(37, hidden=32, num_encoder_layers=1)
    variables, tm = _carry(jm, CTCRecognizerNet(37, hidden=32, num_encoder_layers=1), x, 7,
                           train=False)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, 25, 37)
    _close(got.numpy(), ref)


def _flat_keys(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_keys(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("fault", ["none", "missing", "leftover", "shape"])
def test_weight_carry_checks_every_key(fault):
    jm = JaxCTCRecognizerNet(37, hidden=8, num_encoder_layers=1)
    x = np.zeros((1, 32, 100, 3), np.float32)
    variables = seeded_flax_variables(
        jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0),
                       jnp.asarray(x)), 0
    )
    keys = list(_flat_keys(variables))
    assert any(k[0] == "batch_stats" for k in keys)
    victim = keys[len(keys) // 2]
    node = variables
    for k in victim[:-1]:
        node = node[k]
    if fault == "missing":
        del node[victim[-1]]
    elif fault == "leftover":
        node["extra"] = np.zeros((2,), np.float32)
    elif fault == "shape":
        node[victim[-1]] = np.zeros((3,) + node[victim[-1]].shape, np.float32)
    port = CTCRecognizerNet(37, hidden=8, num_encoder_layers=1)
    if fault == "none":
        load_flax_variables(port, variables)
        n_port = sum(1 for _ in port.parameters()) + sum(
            1 for n, _ in port.named_buffers() if not n.endswith("num_batches_tracked")
        )
        assert n_port == len(keys)
        return
    with pytest.raises((KeyError, ValueError), match="missing|leftover|does not fit"):
        load_flax_variables(port, variables)


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((6, 25, 37)).astype(np.float32)
    logits[:, ::3, 0] += 3.0  # blanks between repeats
    logits[2, 5:9, 4] += 10.0  # a repeated run collapses to one id
    lengths = np.array([25, 25, 10, 1, 0, 17], np.int32)
    ref_ids, ref_len = jax_ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    ids, lens = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lengths))
    assert ids.dtype == torch.int32 and lens.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
