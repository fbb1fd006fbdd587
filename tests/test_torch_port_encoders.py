"""The CTC recognizer's encoder variants against the JAX package, on the CPU.

``models/sequence.py::TransformerEncoder`` alone, then ``CTCRecognizerNet``
with ``encoder='transformer'``, ``encoder='none'`` and
``height_collapse='reshape'`` (hidden 16: a transformer of width 32, 8 heads
of 4), on weights redrawn from a numpy seed (``seeded_flax_variables``) and
carried by ``compat/weights.py``.

Tolerances:

* float64 on both sides (JAX under ``enable_x64``, its BatchNorm built with
  float64 statistics while it runs, as ``test_torch_port_train.py`` does):
  the encoder's output atol 1e-10; the nets' logits (float32, as both nets
  hand them on) atol 1e-5; the train-mode CTC loss atol 1e-5 and every
  gradient leaf rtol 1e-4 / atol 1e-6 (the loss and its gradient run on
  float32 logits in both packages).
* bf16 (mixed precision and the serving cast), on the logits' own scale:
  within 2e-2 (mixed) and 3e-2 (serving cast) of their largest magnitude,
  the bounds ``test_torch_port_bf16.py`` holds this full-width trunk to (XLA
  keeps fused bf16 chains in float32 on the CPU where torch rounds after
  each op), and the encoder's output dtype equal to flax's.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.sequence import TransformerEncoder as JaxTransformerEncoder
from megreader_tpu.ops.precision import cast_floats as jax_cast_floats
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.models.recognizer import CTCRecognizer, rec_feature_hw
from megreader_tpu_torch.models.sequence import TransformerEncoder
from megreader_tpu_torch.ops.precision import cast_floats

_FLAX_BATCH_NORM = flax.linen.BatchNorm
#: (encoder, height_collapse) of each variant
VARIANTS = {"transformer": ("transformer", "mean"), "none": ("none", "mean"),
            "reshape": ("bilstm", "reshape"), "transformer_reshape": ("transformer", "reshape")}
KW = dict(num_classes=37, hidden=16, num_encoder_layers=2)
REL_ATOL_BF16 = {"mixed": 2e-2, "serving": 3e-2}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _batch_norm_f64(*args, dtype=None, **kwargs):
    return _FLAX_BATCH_NORM(*args, **kwargs)


def _x64(fn, *args):
    """``fn(*args)`` jitted in float64, JAX's BatchNorm too."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", _batch_norm_f64)
        args = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a, args)
        return jax.device_get(jax.jit(fn)(*args))


def _batch(B=4, crop_hw=(32, 64)):
    rng = np.random.default_rng(11)
    lengths = np.array([3, 6, 1, 9][:B], np.int32)
    label = rng.integers(1, 37, (B, 10)).astype(np.int32)
    label[np.arange(10)[None] >= lengths[:, None]] = 0
    return {"image": rng.standard_normal((B, *crop_hw, 3)).astype(np.float32),
            "label": label, "label_length": lengths}


def _pair(variant, crop_hw=(32, 64), compute_dtype="float32", seed=3):
    enc, hc = VARIANTS[variant]
    kw = dict(KW, encoder=enc, height_collapse=hc, compute_dtype=compute_dtype)
    jm = JaxCTCRecognizer(**kw)
    shape = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *crop_hw, 3)))
    v = seeded_flax_variables(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                     shape), seed)
    rec = CTCRecognizer(**kw, crop_hw=crop_hw, device="cpu")
    load_flax_variables(rec.net, v)
    return jm, rec, v


@pytest.mark.parametrize("dim_in", [32, 20], ids=["dim", "in_proj"])
def test_transformer_encoder_matches_jax_in_float64(dim_in):
    """Pre-LN blocks (flax's LayerNorm, attention layout and tanh gelu), with
    and without ``in_proj``, on inputs of unit scale."""
    B, T = 3, 7
    x = np.random.default_rng(5).standard_normal((B, T, dim_in))
    jm = JaxTransformerEncoder(dim=32, num_layers=2, num_heads=8)
    shape = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((B, T, dim_in)))
    v = seeded_flax_variables(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                     shape), 9)
    ref = _x64(lambda v, x: jm.apply(v, x), v, x)
    enc = TransformerEncoder(dim_in, T, dim=32, num_layers=2, num_heads=8)
    load_flax_variables(enc, v)
    assert (enc.in_proj is None) == (dim_in == 32)
    got = enc.double()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-10)
    assert np.abs(ref).max() > 0.5
    with pytest.raises(ValueError, match="built for 7"):
        enc(torch.zeros(B, T + 1, dim_in, dtype=torch.float64))


@pytest.mark.parametrize("variant", VARIANTS)
def test_weights_round_trip_and_match_flax_shapes(variant):
    """The port's tree is flax's (``jax.eval_shape`` of ``init``), the load
    and export are each other's inverse, and the 3-D attention kernels keep
    flax's layout."""
    jm, rec, v = _pair(variant)
    exported = export_flax_variables(rec.net)
    got, want = dict(_flat(exported)), dict(_flat(v))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))
    again = CTCRecognizer(**KW, encoder=VARIANTS[variant][0],
                          height_collapse=VARIANTS[variant][1], crop_hw=(32, 64), device="cpu")
    load_flax_variables(again.net, exported)
    for (n, a), b in zip(rec.net.state_dict().items(), again.net.state_dict().values()):
        assert torch.equal(a, b), n
    if VARIANTS[variant][0] == "transformer":
        assert got[("params", "encoder", "attn_0", "query", "kernel")].shape == (32, 8, 4)
        assert got[("params", "encoder", "attn_1", "out", "kernel")].shape == (8, 4, 32)
        assert got[("params", "encoder", "pos_embed")].shape == (1, 16, 32)
        assert ("params", "encoder", "ln_out", "scale") in got


@pytest.mark.parametrize("variant", ["transformer", "none", "reshape"])
def test_variant_logits_loss_and_gradients_match_jax_in_float64(variant):
    """Eval-mode logits, then one train-mode CTC loss and its gradients."""
    jm, rec, v = _pair(variant)
    batch = _batch()
    ref_logits = _x64(lambda v, x: jm.apply(v, x), v, batch["image"])

    def loss_fn(params, batch_stats, batch):
        loss, _ = jm.loss({"params": params, "batch_stats": batch_stats}, batch, train=True)
        return loss

    ref_loss, ref_grads = _x64(jax.value_and_grad(loss_fn), v["params"], v["batch_stats"],
                               batch)
    rec.net.double()
    x = torch.from_numpy(batch["image"].astype(np.float64))
    got_logits = rec.net.eval()(x)
    assert got_logits.shape == ref_logits.shape == (4, 16, 37)
    np.testing.assert_allclose(got_logits.detach().numpy(), ref_logits, rtol=0, atol=1e-5)
    tb = {"image": x, "label": torch.from_numpy(batch["label"]),
          "label_length": torch.from_numpy(batch["label_length"])}
    loss, _ = rec.loss(tb, train=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), abs=1e-5)
    grads = export_flax_variables(rec.net, {n: p.grad for n, p in rec.net.named_parameters()})
    got, want = dict(_flat(grads["params"])), dict(_flat(ref_grads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(key))


def _stage_dtypes_port(net, x):
    seen = {}
    hooks = [getattr(net, n).register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, o.dtype)) for n in ("backbone", "encoder",
                                                                    "classifier")]
    try:
        out = net.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


@pytest.mark.parametrize("mode", ["mixed", "serving"])
@pytest.mark.parametrize("variant", ["transformer", "transformer_reshape"])
def test_transformer_bf16_matches_jax(variant, mode):
    """Mixed precision: the trunk in bf16, the transformer in float32 (its
    float32 ``pos_embed`` promotes the bf16 features), the classifier in
    bf16. The serving cast: everything bf16. Logits within 2e-2 / 3e-2 of
    their largest magnitude, and the encoder's output dtype as flax's."""
    jm, rec, v = _pair(variant, compute_dtype="bfloat16" if mode == "mixed" else "float32")
    x = _batch()["image"]
    if mode == "serving":
        v = jax_cast_floats(v, jnp.bfloat16)
        net, xin, jx = cast_floats(rec.net), torch.from_numpy(x).to(torch.bfloat16), \
            jnp.asarray(x, jnp.bfloat16)
    else:
        net, xin, jx = rec.net, torch.from_numpy(x), jnp.asarray(x)
    ref, state = jm.net.apply(v, jx, train=False, capture_intermediates=True,
                              mutable=["intermediates"])
    got, seen = _stage_dtypes_port(net, xin)
    want_enc = state["intermediates"]["encoder"]["__call__"][0].dtype
    assert str(seen["encoder"]).replace("torch.", "") == str(want_enc)
    assert str(want_enc) == ("float32" if mode == "mixed" else "bfloat16")
    scale = float(np.abs(np.asarray(ref, np.float32)).max())
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=REL_ATOL_BF16[mode] * scale)


def test_net_needs_the_crop_hw_it_is_fed():
    """The transformer's length and the reshape's width come from
    ``crop_hw``: another crop size raises."""
    assert rec_feature_hw((32, 100)) == (2, 25) and rec_feature_hw((48, 64)) == (3, 16)
    for variant in ("transformer", "reshape"):
        rec = CTCRecognizer(**KW, encoder=VARIANTS[variant][0],
                            height_collapse=VARIANTS[variant][1], crop_hw=(32, 64),
                            device="cpu")
        with pytest.raises(ValueError, match="build it with the crop_hw"):
            rec.net.eval()(torch.zeros(1, 32, 100, 3))
    with pytest.raises(ValueError, match="unknown encoder"):
        CTCRecognizer(**KW, encoder="gru", device="cpu")
    with pytest.raises(ValueError, match="unknown height_collapse"):
        CTCRecognizer(**KW, height_collapse="max", device="cpu")


def test_experiment_hands_the_transformer_its_crop_hw(tmp_path):
    """``from_yaml`` of config #1 with ``encoder: transformer``: the net is
    built for the experiment's crops and takes a train step."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", "ctc_resnet18_synth.yaml")
    exp = Experiment.from_yaml(path, {
        "experiment.model.device": "cpu", "experiment.model.encoder": "transformer",
        "experiment.model.hidden": 16, "experiment.model.num_encoder_layers": 1,
        "experiment.batch_size": 4, "experiment.train_dataset.n": 4,
        "experiment.workspace": str(tmp_path)})
    enc = exp.model.net.encoder
    assert isinstance(enc, TransformerEncoder) and enc.seq_len == 25
    batch = exp.prepare(next(iter(exp.train_loader)))
    loss, _ = exp.model.loss(batch, train=True)
    loss.backward()
    assert torch.isfinite(loss)
    assert enc.pos_embed.grad is not None and torch.isfinite(enc.pos_embed.grad).all()
