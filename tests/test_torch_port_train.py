"""Port recognizer training against the JAX package, on the CPU.

One module-scoped JAX fixture at the size ``tests/test_train.py`` uses
(``CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)``, batch 8 of
``SyntheticRecognitionDataset(n=16)``), with weights redrawn from a numpy seed
and carried into the port. Both packages take the same canvases through their
own loader and prepare function, then one train-mode step (loss, every
gradient leaf, the updated BatchNorm statistics) and three SGD steps are
compared. Tolerances: loss atol 1e-4; gradients rtol 1e-3 / atol 1e-5;
batch_stats atol 1e-5; parameters after three SGD steps atol 1e-4.

The step runs in float64 on both sides, from the same prepared batch (both
CTC losses still run on float32 logits), and the JAX BatchNorm computes its
statistics in float64 too: ``models/resnet.py::_bn`` builds ``nn.BatchNorm``
with ``dtype=jnp.float32``, and the fixture builds it with ``dtype=None``
while it runs. In float32 the comparison cannot hold these tolerances: JAX's
float32 batch statistics (E[x^2] - E[x]^2 over 10^4-10^5 values) differ from
the exact ones by up to 1e-4 relative, and a few of the ~10^5 pre-activations
of each layer lie that close to ReLU's kink, so one flipped ReLU moves the
gradient of every earlier leaf by up to 10% (measured at this size: the port
in float32 and in float64 agree to 1e-6 down to the first flip; JAX's float32
gradient differs from both by up to 11%)."""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megreader_tpu.core import Charset as JaxCharset
from megreader_tpu.data import Loader as JaxLoader
from megreader_tpu.data import SyntheticRecognitionDataset as JaxSyntheticRecognitionDataset
from megreader_tpu.data import recognition_collate as jax_recognition_collate
from megreader_tpu.experiment import _recognition_prepare as jax_recognition_prepare
from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.ops.image import normalize as jax_normalize
from megreader_tpu.ops.image import resize_with_aspect_pad as jax_resize_with_aspect_pad
from megreader_tpu.train import OptimizerConfig as JaxOptimizerConfig
from megreader_tpu_torch.compat.weights import (
    export_flax_variables,
    load_flax_variables,
    seeded_flax_variables,
)
from megreader_tpu_torch.core.charset import Charset
from megreader_tpu_torch.data.datasets import SyntheticRecognitionDataset
from megreader_tpu_torch.data.loader import Loader, recognition_collate
from megreader_tpu_torch.experiment import _recognition_prepare
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.models.resnet import BatchNorm2d
from megreader_tpu_torch.ops.image import normalize, resize_with_aspect_pad
from megreader_tpu_torch.train.train_step import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)

SGD = dict(name="sgd", lr=0.01, momentum=0.9, weight_decay=1e-4, schedule="poly",
           total_steps=10)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, ref, rtol, atol):
    got, ref = dict(_flat(got)), dict(_flat(jax.device_get(ref)))
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=rtol, atol=atol,
                                   err_msg="/".join(key))


def _port_model(variables, dtype=torch.float32):
    rec = CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1, device="cpu")
    load_flax_variables(rec.net, variables)
    rec.net.to(dtype)
    return rec


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def jax_side():
    cs = JaxCharset()
    loader = JaxLoader(JaxSyntheticRecognitionDataset(n=16), batch_size=8,
                       collate=functools.partial(jax_recognition_collate, charset=cs),
                       shuffle=True, prefetch=0)
    raw = next(iter(loader))
    batch = jax.device_get(jax_recognition_prepare(raw))
    model = JaxCTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)
    variables = seeded_flax_variables(
        jax.eval_shape(model.init, jax.random.PRNGKey(0), batch["image"]), 1
    )
    batch64 = {**batch, "image": batch["image"].astype(np.float64)}

    def loss_fn(params, batch_stats, batch):
        loss, (_, new_state) = model.loss(
            {"params": params, "batch_stats": batch_stats}, batch, train=True)
        return loss, new_state["batch_stats"]

    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)
        v64 = _f64(variables)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (loss, new_stats), grads = grad_fn(v64["params"], v64["batch_stats"], batch64)
        # three steps of the JAX package's SGD, as its make_train_step takes
        # them, on the same compiled gradient
        tx = JaxOptimizerConfig(**SGD).make()
        update = jax.jit(lambda g, s, p: tx.update(g, s, p))
        params, stats, opt_state = v64["params"], v64["batch_stats"], tx.init(v64["params"])
        sgd_losses = []
        for _ in range(3):
            (step_loss, stats), g = grad_fn(params, stats, batch64)
            updates, opt_state = update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            sgd_losses.append(float(step_loss))
        out = jax.device_get({"loss": loss, "grads": grads, "batch_stats": new_stats,
                              "sgd_params": params})
    return {"raw": raw, "batch": batch, "batch64": batch64, "variables": variables,
            "loss": float(out["loss"]), "grads": out["grads"],
            "batch_stats": out["batch_stats"], "sgd_params": out["sgd_params"],
            "sgd_losses": sgd_losses}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(batch[k])) for k in ("image", "label", "label_length")}


def test_prepare_matches_jax(jax_side):
    raw = jax_side["raw"]
    got = _recognition_prepare(raw, device="cpu")
    ref = jax_side["batch"]
    np.testing.assert_allclose(got["image"].numpy(), ref["image"], rtol=0, atol=1e-4)
    for key in ("label", "label_length"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), ref[key])


def test_resize_with_aspect_pad_matches_jax():
    """Widths equal and pixels within 1e-4 after ``normalize``, on the
    dataset's canvases plus a crop wider than the output and a 1-pixel one."""
    ds = SyntheticRecognitionDataset(n=6, seed=3)
    images = np.stack([ds[i]["image"] for i in range(6)]).astype(np.float32)
    sizes = np.stack([ds[i]["size"] for i in range(6)])
    sizes[4] = (20, 256)  # aspect 12.8: truncated at Wo
    sizes[5] = (1, 1)
    ref, ref_w = jax_resize_with_aspect_pad(jnp.asarray(images), jnp.asarray(sizes), (32, 100))
    got, got_w = resize_with_aspect_pad(torch.from_numpy(images), torch.from_numpy(sizes),
                                        (32, 100))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_allclose(normalize(got).numpy(), np.asarray(jax_normalize(ref)),
                               rtol=0, atol=1e-4)


def test_loader_gives_the_jax_batches():
    """Same seed: the same batch order over two epochs, byte-equal image,
    label and label_length (the port with its thread pool and prefetch)."""
    jl = JaxLoader(JaxSyntheticRecognitionDataset(n=16), batch_size=4,
                   collate=functools.partial(jax_recognition_collate, charset=JaxCharset()),
                   shuffle=True, seed=5, prefetch=0, workers=1)
    pl = Loader(SyntheticRecognitionDataset(n=16), batch_size=4,
                collate=functools.partial(recognition_collate, charset=Charset()),
                shuffle=True, seed=5, prefetch=2, workers=3)
    assert len(pl) == len(jl) == 4
    for _ in range(2):
        ref = list(jl)
        got = list(pl)
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            assert g["text"] == r["text"]
            for key in ("image", "size", "label", "label_length"):
                assert g[key].dtype == r[key].dtype
                np.testing.assert_array_equal(g[key], r[key])


@pytest.fixture(scope="module")
def port_step(jax_side):
    rec = _port_model(jax_side["variables"], torch.float64)
    loss, metrics = rec.loss(_torch_batch(jax_side["batch64"]), train=True)
    loss.backward()
    grads = export_flax_variables(rec.net, {n: p.grad for n, p in rec.net.named_parameters()})
    return {"loss": float(loss.detach()), "metrics": metrics, "grads": grads,
            "variables": export_flax_variables(rec.net)}


def test_train_step_loss_matches_jax(jax_side, port_step):
    np.testing.assert_allclose(port_step["loss"], jax_side["loss"], rtol=0, atol=1e-4)
    assert float(port_step["metrics"]["loss"]) == port_step["loss"]


def test_train_step_gradients_match_jax(jax_side, port_step):
    assert list(port_step["grads"]) == ["params"]
    _assert_trees_close(port_step["grads"]["params"], jax_side["grads"], rtol=1e-3, atol=1e-5)


def test_train_step_batch_stats_match_jax(jax_side, port_step):
    """flax moves the running statistics by 0.01 toward the batch mean and
    the biased batch variance; torch's defaults (momentum 0.1, unbiased
    variance) would fail here."""
    _assert_trees_close(port_step["variables"]["batch_stats"], jax_side["batch_stats"],
                        rtol=0, atol=1e-5)


def test_three_sgd_steps_match_jax(jax_side):
    rec = _port_model(jax_side["variables"], torch.float64)
    state = create_train_state(rec, OptimizerConfig(**SGD))
    step = make_train_step(rec)
    batch = _torch_batch(jax_side["batch64"])
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == 3
    np.testing.assert_allclose(losses, jax_side["sgd_losses"], rtol=0, atol=1e-4)
    _assert_trees_close(export_flax_variables(rec.net)["params"], jax_side["sgd_params"],
                        rtol=0, atol=1e-4)


def test_batchnorm_train_mode_is_flax():
    """Two train-mode calls then one eval call against flax's BatchNorm."""
    fnn = flax.linen
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((4, 6, 5, 3)) * 2 + 1).astype(np.float32) for _ in range(3)]
    bn = fnn.BatchNorm()
    variables = jax.device_get(
        bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=True))
    tbn = BatchNorm2d(3)
    tbn.train()
    for x in xs[:2]:
        ref, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                            mutable=["batch_stats"])
        variables = {**variables, **jax.device_get(upd)}
        got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=0, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(), stats["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), stats["var"], rtol=0, atol=1e-6)
    ref = bn.apply(variables, jnp.asarray(xs[2]), use_running_average=True)
    got = tbn.eval()(torch.from_numpy(xs[2]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)


def test_export_inverts_load(jax_side):
    variables = jax_side["variables"]
    out = export_flax_variables(_port_model(variables).net)
    _assert_trees_close(out["params"], variables["params"], rtol=0, atol=0)
    _assert_trees_close(out["batch_stats"], variables["batch_stats"], rtol=0, atol=0)
    with pytest.raises(KeyError, match="no flax mapping"):
        export_flax_variables(_port_model(variables).net, {"not.a.weight": torch.zeros(1)})
