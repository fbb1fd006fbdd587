"""Resuming a JAX train state in the port, on the CPU.

The JAX package takes k steps of config #1 (``CTCRecognizer(hidden=32,
num_encoder_layers=1)``, the size ``tests/test_torch_port_train.py`` uses)
or config #4 (a narrow ``SegDetector``), as its ``make_train_step`` takes
them, saves its ``TrainState`` with ``CheckpointManager(use_orbax=False)``,
and steps once more. The port builds the same optimizer, restores the file
through ``CheckpointManager.restore_jax_state`` and steps once. Both run in
float64 (the JAX BatchNorm patched to float64 statistics, as in
``test_torch_port_train.py``; ROADMAP Queue 3). Tolerances are that file's:
loss atol 1e-4, gradient-like leaves (moments, traces, accumulators) rtol
1e-3 / atol 1e-5, parameters atol 1e-4; counts exact. Cases: AdamW with clip
and a warm-up cosine, SGD with momentum, and MultiSteps saved
mid-accumulation (one mini-step pending).

Also: the restored optimizer's ``export_optax_state`` gives back the tree
JAX saved, ``export_jax_state`` the whole file, and ``msgpack_serialize``
the bytes flax gives for it; ``Trainer.train(resume=True)`` picks up a JAX
state left in its workspace."""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from megreader_tpu.core import Charset as JaxCharset
from megreader_tpu.data import Loader as JaxLoader
from megreader_tpu.data import SyntheticDetectionDataset as JaxSyntheticDetectionDataset
from megreader_tpu.data import SyntheticRecognitionDataset as JaxSyntheticRecognitionDataset
from megreader_tpu.data import recognition_collate as jax_recognition_collate
from megreader_tpu.data.loader import detection_collate_polys as jax_detection_collate_polys
from megreader_tpu.experiment import _detection_prepare_device as jax_prepare_device
from megreader_tpu.experiment import _recognition_prepare as jax_recognition_prepare
from megreader_tpu.models import CTCRecognizer as JaxCTCRecognizer
from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.train import OptimizerConfig as JaxOptimizerConfig
from megreader_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from megreader_tpu.train.train_step import TrainState as JaxTrainState
from megreader_tpu_torch.compat.msgpack import msgpack_restore, msgpack_serialize
from megreader_tpu_torch.compat.weights import load_flax_variables, seeded_flax_variables
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.train.checkpoint import CheckpointManager, export_jax_state
from megreader_tpu_torch.train.train_step import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)
from megreader_tpu_torch.train.trainer import Trainer

ADAMW_CLIP = dict(name="adamw", lr=1e-3, weight_decay=1e-4, schedule="warmup_cosine",
                  warmup_steps=2, total_steps=20, grad_clip=1.0)
SGD = dict(name="sgd", lr=0.01, momentum=0.9, weight_decay=1e-4, schedule="poly",
           total_steps=20)
MULTI = dict(ADAMW_CLIP, accumulate_steps=2)
MULTI_SGD = dict(SGD, accumulate_steps=2, grad_clip=5.0)
DET = dict(fpn_dim=16, head_dim=8, width=8)
#: (model, optimizer, JAX steps before the save)
CASES = {
    "rec-adamw-clip": ("rec", ADAMW_CLIP, 1),
    "rec-multisteps": ("rec", MULTI, 3),
    "det-sgd": ("det", SGD, 2),
    "det-multisteps-sgd": ("det", MULTI_SGD, 1),
}


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


def _f64(tree):
    """Floating leaves to float64; labels and lengths stay integers."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), tree)


def _rec_batches():
    loader = JaxLoader(JaxSyntheticRecognitionDataset(n=4), batch_size=2,
                       collate=functools.partial(jax_recognition_collate, charset=JaxCharset()),
                       shuffle=False, prefetch=0)
    return [jax.device_get(jax_recognition_prepare(raw)) for raw in loader]


def _det_batches():
    ds = JaxSyntheticDetectionDataset(n=4, hw=(96, 96), seed=2, max_rotate=20.0)
    out = []
    for i in (0, 2):
        raw = jax_detection_collate_polys([ds[i], ds[i + 1]], max_polys=8)
        out.append(jax.device_get(jax.jit(jax_prepare_device)(
            {k: raw[k] for k in ("image", "polys", "poly_valid", "poly_ignore")})))
    return out


@pytest.fixture(scope="module")
def models():
    """Per model: the flax model, its float64 gradient (jitted once), the
    seeded weights, two prepared float64 batches and a port factory."""
    out = {}
    for kind in ("rec", "det"):
        if kind == "rec":
            model = JaxCTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1)
            batches = _rec_batches()

            def port(variables):
                rec = CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1,
                                    device="cpu")
                load_flax_variables(rec.net, variables)
                rec.net.to(torch.float64)
                return rec
        else:
            model = JaxSegDetector(**DET)
            batches = _det_batches()

            def port(variables):
                det = SegDetector(**DET, device="cpu")
                load_flax_variables(det.net, variables)
                det.net.to(torch.float64)
                return det
        abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                  jnp.zeros((1,) + batches[0]["image"].shape[1:]))
        variables = seeded_flax_variables(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), abstract), 3)

        def loss_fn(params, batch_stats, batch, model=model):
            loss, (_, new_state) = model.loss(
                {"params": params, "batch_stats": batch_stats}, batch, train=True)
            return loss, new_state["batch_stats"]

        out[kind] = {"model": model, "variables": variables, "port": port,
                     "batches": [_f64(b) for b in batches],
                     "grad": jax.jit(jax.value_and_grad(loss_fn, has_aux=True))}
    return out


@pytest.fixture(scope="module")
def float64_jax():
    flax_batch_norm = flax.linen.BatchNorm

    def batch_norm_f64(*args, dtype=None, **kwargs):
        return flax_batch_norm(*args, **kwargs)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", batch_norm_f64)
        yield


def _jax_run(m, cfg, k, workspace):
    """k JAX steps, the save, one more step -> the saved file and the
    state after the extra step."""
    tx = JaxOptimizerConfig(**cfg).make()
    update = jax.jit(tx.update)
    v64 = _f64(m["variables"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                          batch_stats=v64["batch_stats"], opt_state=tx.init(v64["params"]))
    losses = []
    for i in range(k + 1):
        if i == k:
            JaxCheckpointManager(workspace, use_orbax=False, save_every_steps=1).save(
                state, force=True)
        batch = m["batches"][i % 2]
        (loss, stats), grads = m["grad"](state.params, state.batch_stats, batch)
        updates, opt_state = update(grads, state.opt_state, state.params)
        state = state.replace(step=state.step + 1,
                              params=optax.apply_updates(state.params, updates),
                              batch_stats=stats, opt_state=opt_state)
        losses.append(float(loss))
    return jax.device_get(state), losses


@pytest.fixture(scope="module")
def jax_runs(models, float64_jax, tmp_path_factory):
    """case -> (its workspace, the JAX state after the extra step, the
    losses), each run once."""

    @functools.lru_cache(maxsize=None)
    def run(case):
        kind, cfg, k = CASES[case]
        ws = str(tmp_path_factory.mktemp(case))
        return (ws,) + _jax_run(models[kind], cfg, k, ws)

    return run


@pytest.fixture(scope="module", params=sorted(CASES))
def resumed(request, models, jax_runs):
    kind, cfg, k = CASES[request.param]
    m = models[kind]
    ws, ref, losses = jax_runs(request.param)
    with open(f"{ws}/checkpoints/state_{k:08d}.msgpack", "rb") as f:
        saved = f.read()
    port = m["port"](m["variables"])
    state = create_train_state(port, OptimizerConfig(**cfg))
    CheckpointManager(ws).restore_jax_state(state)
    restored = {"step": state.step, "opt_state": state.optimizer.export_optax_state(),
                "jax_state": export_jax_state(state)}
    batch = {k_: torch.from_numpy(np.asarray(v)) for k_, v in m["batches"][k % 2].items()}
    state, metrics = make_train_step(port)(state, batch)
    return {"cfg": cfg, "k": k, "saved": saved, "ref": ref, "ref_loss": losses[-1],
            "restored": restored, "state": state, "loss": float(metrics["loss"])}


def test_restored_optax_state_is_the_saved_one(resumed):
    """Before stepping: the step and ``export_optax_state`` equal what JAX
    saved, leaf for leaf and dtype for dtype."""
    saved = msgpack_restore(resumed["saved"])
    assert resumed["restored"]["step"] == int(saved["step"]) == resumed["k"]
    got = dict(_flat(resumed["restored"]["opt_state"]))
    ref = dict(_flat(saved["opt_state"]))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg="/".join(key))
    if resumed["cfg"].get("accumulate_steps", 1) > 1:
        assert int(saved["opt_state"]["mini_step"]) == 1  # saved mid-accumulation


def test_export_jax_state_gives_the_file_back(resumed):
    """``export_jax_state`` of the restored state, through
    ``msgpack_serialize``, gives the bytes flax gives for the saved tree
    (keys sorted on both sides)."""
    ref = serialization.msgpack_serialize(serialization.msgpack_restore(resumed["saved"]))
    assert msgpack_serialize(resumed["restored"]["jax_state"]) == ref


def test_resumed_step_matches_jax(resumed):
    ref, state = resumed["ref"], resumed["state"]
    np.testing.assert_allclose(resumed["loss"], resumed["ref_loss"], rtol=0, atol=1e-4)
    assert state.step == int(ref.step) == resumed["k"] + 1
    got = export_jax_state(state)
    _assert_trees_close(got["params"], ref.params, rtol=0, atol=1e-4)
    _assert_trees_close(got["batch_stats"], ref.batch_stats, rtol=0, atol=1e-5)
    got_opt = dict(_flat(got["opt_state"]))
    ref_opt = dict(_flat(serialization.to_state_dict(ref.opt_state)))
    assert sorted(got_opt) == sorted(ref_opt)
    for key in ref_opt:
        if ref_opt[key].ndim == 0:  # counts and mini_step
            assert int(got_opt[key]) == int(ref_opt[key]), key
        else:
            np.testing.assert_allclose(got_opt[key], ref_opt[key], rtol=1e-3, atol=1e-5,
                                       err_msg="/".join(key))


def test_load_optax_state_refuses_a_mismatched_tree(models):
    port = models["rec"]["port"](models["rec"]["variables"])
    opt = OptimizerConfig(**ADAMW_CLIP).make(port.net)
    tree = opt.export_optax_state()
    with pytest.raises(KeyError, match="ScaleByAdamState|chain"):
        OptimizerConfig(**SGD).make(port.net).load_optax_state(tree)
    del tree["1"]["0"]["mu"]["classifier"]
    with pytest.raises(KeyError, match="missing"):
        opt.load_optax_state(tree)
    tree = OptimizerConfig(**ADAMW_CLIP).make(port.net).export_optax_state()
    tree["1"]["2"]["count"] = np.asarray(4, np.int32)
    with pytest.raises(ValueError, match="count"):
        opt.load_optax_state(tree)


def test_trainer_resumes_a_jax_state_in_its_workspace(models, jax_runs, tmp_path):
    """``Trainer.train(resume=True)`` in a workspace holding only a JAX
    msgpack state takes it whole (weights, optax state, step) and trains on
    to its step budget: one step here, equal to JAX's next one."""
    m = models["rec"]
    ws, ref, _ = jax_runs("rec-adamw-clip")
    (tmp_path / "checkpoints").mkdir()
    with open(f"{ws}/checkpoints/state_00000001.msgpack", "rb") as f:
        (tmp_path / "checkpoints" / "state_00000001.msgpack").write_bytes(f.read())
    port = m["port"](m["variables"])
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in m["batches"][1].items()}
    trainer = Trainer(port, [batch], OptimizerConfig(**ADAMW_CLIP), workspace=str(tmp_path),
                      epochs=2, log_every=100)
    state = trainer.train(resume=True)
    assert state.step == 2 and state.optimizer.count == 2
    got = export_jax_state(state)
    _assert_trees_close(got["params"], ref.params, rtol=0, atol=1e-4)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_trainer_refuses_an_orbax_state_in_its_workspace(models, tmp_path):
    """A workspace whose only checkpoint is an orbax step directory (what the
    JAX package's ``CheckpointManager`` writes by default) makes
    ``train(resume=True)`` raise instead of starting again from step 0."""
    m = models["rec"]
    (tmp_path / "checkpoints" / "3").mkdir(parents=True)
    port = m["port"](m["variables"])
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in m["batches"][1].items()}
    trainer = Trainer(port, [batch], OptimizerConfig(**ADAMW_CLIP), workspace=str(tmp_path),
                      epochs=2, log_every=100)
    assert trainer.checkpoint.has_jax_state()
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.train(resume=True)
    assert CheckpointManager(str(tmp_path)).latest_step() is None
