"""Data parallelism of the port (``parallel/mesh.py``) on the CPU: two real
processes in a gloo group, spawned as ``tests/test_multiprocess.py`` spawns
the JAX package's workers, against one process on the global batch.

Each worker (this file run as a script; its top level imports numpy, pytest
and torch only, as the loader's forkserver runs it again) joins the group,
checks ``is_primary`` and ``barrier``, loads its share of 16 synthetic crops
through a ``host_shard`` loader, and takes one config-#1 step (ResNet-18 +
BiLSTM, hidden 32, one layer, the net in float64) with ``use_mesh``'s step:
BatchNorm on the global batch's statistics, the global batch's gradient.
The parent takes the same step in one process on the global batch: each
rank's crops collated and prepared as that rank does (a batch's canvas width
is its widest crop's, and the resize's float32 rounding follows it), then
stacked in rank order, as JAX's ``make_array_from_process_local_data``
stacks the hosts' local batches.
The parameters and the BatchNorm statistics agree within 1e-10. The loss
agrees within 1e-10 too: the CTC loss runs on float32 logits in both
packages, so this holds only as long as the two float32 batch means round
alike, which they do here.

The losses that are not means over samples take the same step: an
attention recognizer (its loss a mean over the tokens, with labels of 2
and 3 tokens on rank 0 and 7 and 8 on rank 1, so the global batch's mean is
not the mean of the ranks' means) and a DB detector (dice and the masked
L1 are ratios of sums over the batch), each narrow and in float64, on a
seeded global batch of 4 that each rank takes 2 of (``shard_batch``).

Then each worker serves one of two pages through ``E2EPipeline.build(mesh)``
(the trained detector of ``assets/bench_det_fp16.msgpack``, a seeded
recognizer) and all-gathers the outputs: they equal one process's ``run``
on both pages (see ``test_sharded_serving_equals_one_process``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "assets", "bench_det_fp16.msgpack")
N, BATCH, WORLD = 16, 8, 2
SGD = dict(name="sgd", lr=0.05, momentum=0.0, weight_decay=0.0, schedule="constant")
FAMILIES = ("attention", "detector")


def _recognizer():
    from megreader_tpu_torch.models.recognizer import CTCRecognizer

    torch.manual_seed(0)
    rec = CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1, device="cpu")
    rec.net.double()
    return rec


def _model(family):
    """A narrow float64 attention recognizer or DB detector, seeded."""
    from megreader_tpu_torch.models.attention import AttentionRecognizer
    from megreader_tpu_torch.models.detector import SegDetector

    torch.manual_seed(2)
    if family == "attention":
        model = AttentionRecognizer(num_classes=39, dim=32, max_len=8, width=16, device="cpu")
    else:
        model = SegDetector(fpn_dim=32, head_dim=16, width=16, device="cpu")
    model.net.double()
    return model


def _global_batch(family):
    """A seeded global batch of 4 numpy arrays; rank r takes rows 2r, 2r+1."""
    rng = np.random.default_rng(11)
    if family == "attention":
        lengths = np.array([2, 3, 7, 8], np.int32)  # EOS included
        label = np.zeros((4, 8), np.int32)  # PAD
        for i, n in enumerate(lengths):
            label[i, :n - 1] = rng.integers(3, 39, n - 1)
            label[i, n - 1] = 2  # EOS
        return {"image": rng.standard_normal((4, 32, 100, 3)), "label": label,
                "label_length": lengths}
    hw = (4, 64, 64)
    return {"image": rng.standard_normal(hw + (3,)),
            "gt": (rng.uniform(size=hw) < 0.2).astype(np.float64),
            "mask": (rng.uniform(size=hw) < 0.9).astype(np.float64),
            "thresh_map": rng.uniform(0.3, 0.7, hw),
            "thresh_mask": (rng.uniform(size=hw) < 0.3).astype(np.float64)}


def _step(model, batch, mesh=None):
    """One SGD step on ``batch``: (loss, grad_norm, the net's float state)."""
    from megreader_tpu_torch.train.train_step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    state = create_train_state(model, OptimizerConfig(**SGD))
    _, metrics = make_train_step(model, mesh=mesh)(state, batch)
    return float(metrics["loss"]), float(metrics["grad_norm"]), _state_arrays(model.net)


def _loader(rank_world=None):
    import functools

    from megreader_tpu_torch.core.charset import Charset
    from megreader_tpu_torch.data.datasets import SyntheticRecognitionDataset
    from megreader_tpu_torch.data.loader import Loader, recognition_collate

    collate = functools.partial(recognition_collate, charset=Charset(), max_label_len=32)
    return Loader(SyntheticRecognitionDataset(n=N), BATCH if rank_world is None
                  else BATCH // WORLD, collate, shuffle=True, host_shard=True)


def _prepare(batch):
    from megreader_tpu_torch.experiment import _recognition_prepare

    return _recognition_prepare(batch, device="cpu")


def _pipeline():
    from megreader_tpu_torch.compat.msgpack import load_flax_msgpack
    from megreader_tpu_torch.compat.weights import load_flax_variables
    from megreader_tpu_torch.models.detector import SegDetector
    from megreader_tpu_torch.models.recognizer import CTCRecognizer
    from megreader_tpu_torch.pipelines.e2e import E2EPipeline

    det = SegDetector(device="cpu")
    load_flax_variables(det.net, load_flax_msgpack(ASSET)[0])
    torch.manual_seed(1)
    rec = CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1, device="cpu")
    return E2EPipeline(det, rec, device="cpu", max_regions=8)


def _pages():
    rng = np.random.default_rng(3)
    pages = rng.uniform(0, 50, (2, 128, 128, 3)).astype(np.float32)
    for b, (y, x) in enumerate([(30, 20), (70, 40)]):
        pages[b, y:y + 16, x:x + 70:3] = 235.0
        pages[b, y + 40:y + 52, 10:60:3] = 235.0
    return pages


def _state_arrays(module):
    return {k: v.detach().double().numpy() for k, v in module.state_dict().items()
            if v.is_floating_point()}


def worker(init_method: str, rank: int, outdir: str) -> None:
    from megreader_tpu_torch.parallel import (
        barrier,
        init_mesh,
        is_primary,
        shard_batch,
        sync_batch_norm,
    )
    from megreader_tpu_torch.train.train_step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    torch.set_num_threads(2)
    mesh = init_mesh(init_method, WORLD, rank, device="cpu")
    assert (mesh.rank, mesh.world_size) == (rank, WORLD) and is_primary() == (rank == 0)
    loader = _loader(rank_world=True)
    batch = next(iter(loader))
    indices = [int(i) for i in loader._indices()]  # this epoch's share
    barrier()

    rec = _recognizer()
    sync_batch_norm(rec.net, mesh)
    state = create_train_state(rec, OptimizerConfig(**SGD))
    _, metrics = make_train_step(rec, prepare=_prepare, mesh=mesh)(state, batch)
    barrier()

    extra = {}
    for family in FAMILIES:
        model = _model(family)
        sync_batch_norm(model.net, mesh)
        block = {k: v[2 * rank:2 * rank + 2] for k, v in _global_batch(family).items()}
        loss, norm, arrays = _step(model, shard_batch(block, mesh), mesh)
        extra[family] = {"loss": loss, "grad_norm": norm}
        if is_primary():
            np.savez(os.path.join(outdir, f"{family}.npz"), **arrays)
    barrier()

    pages = _pages()
    out = _pipeline().build(mesh)(None, None, pages)
    result = {"indices": indices, "loss": float(metrics["loss"]),
              "grad_norm": float(metrics["grad_norm"]), **extra}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if is_primary():
        np.savez(os.path.join(outdir, "state.npz"), **_state_arrays(rec.net))
        np.savez(os.path.join(outdir, "served.npz"), **{k: v.numpy() for k, v in out.items()})
    barrier()
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    init = f"file://{tmp / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, __file__, init, str(rank), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for rank in range(WORLD)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    ranks = [json.load(open(tmp / f"rank{r}.json")) for r in range(WORLD)]
    return {"ranks": ranks, "state": dict(np.load(tmp / "state.npz")),
            "served": dict(np.load(tmp / "served.npz")),
            **{f: dict(np.load(tmp / f"{f}.npz")) for f in FAMILIES}}


@pytest.fixture
def two_threads():
    """The workers' thread count: the CPU's float32 kernels (the CTC loss)
    round with the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _order():
    """One process's shuffled order of the first epoch."""
    loader = _loader()
    loader.epoch = 1
    return [int(i) for i in loader._indices()]


def test_host_shard_splits_the_shuffled_order_by_rank(two_ranks):
    order = _order()
    got = [r["indices"] for r in two_ranks["ranks"]]
    assert got == [order[0::2], order[1::2]]
    assert sorted(got[0] + got[1]) == list(range(N))


def test_two_rank_step_equals_one_process_on_the_global_batch(two_ranks, two_threads):
    from megreader_tpu_torch.train.train_step import (
        OptimizerConfig,
        create_train_state,
        make_train_step,
    )

    order = _order()
    per = BATCH // WORLD
    loader = _loader()
    # each rank's batch collated and prepared on its own, then stacked
    local = [_prepare(loader.collate([loader.dataset[i] for i in order[r::WORLD][:per]]))
             for r in range(WORLD)]
    batch = {k: torch.cat([b[k] for b in local]) for k in local[0]}
    rec = _recognizer()
    state = create_train_state(rec, OptimizerConfig(**SGD))
    _, metrics = make_train_step(rec)(state, batch)
    for r in two_ranks["ranks"]:
        assert abs(r["loss"] - float(metrics["loss"])) <= 1e-10
        assert abs(r["grad_norm"] - float(metrics["grad_norm"])) <= 1e-10
    want = _state_arrays(rec.net)
    assert sorted(want) == sorted(two_ranks["state"])
    for k, v in want.items():
        np.testing.assert_allclose(two_ranks["state"][k], v, rtol=0, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_of_a_ratio_loss_equals_one_process(two_ranks, two_threads, family):
    """The attention and detector losses are not per-sample means: each
    rank's loss, gradient norm and updated state are the global batch's (at
    the workers' thread count: at torch's default the attention net's loss
    moves by 6e-10)."""
    batch = {k: torch.from_numpy(v) for k, v in _global_batch(family).items()}
    loss, norm, want = _step(_model(family), batch)
    for r in two_ranks["ranks"]:
        assert abs(r[family]["loss"] - loss) <= 1e-10, (r[family], loss)
        assert abs(r[family]["grad_norm"] - norm) <= 1e-10, (r[family], norm)
    got = two_ranks[family]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-10, err_msg=k)


def test_shard_batch_matches_jax():
    """Array leaves move to the rank's device with their values; texts and
    scalars pass through on the host, as JAX's ``shard_batch`` leaves them
    (on a mesh of one device: a rank's batch is its own)."""
    import jax

    from megreader_tpu.parallel import make_mesh as jax_make_mesh
    from megreader_tpu.parallel import shard_batch as jax_shard_batch
    from megreader_tpu_torch.parallel import make_mesh, shard_batch

    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
             "label": rng.integers(0, 37, (4, 5)).astype(np.int32),
             "text": ["ab", "c", "def", "g"], "step": np.int32(3), "scale": np.float32(2.0)}
    ref = jax_shard_batch(batch, jax_make_mesh(devices=jax.devices()[:1]))
    got = shard_batch(dict(batch, weights=torch.arange(4.0)), make_mesh("cpu"))
    assert sorted(got) == sorted(batch) + ["weights"]
    for k, v in ref.items():
        if v is batch[k]:  # left on the host by JAX
            assert got[k] is batch[k], k
        else:
            assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu", k
            assert got[k].numpy().dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert torch.equal(got["weights"], torch.arange(4.0))


def test_sharded_serving_equals_one_process(two_ranks, two_threads):
    """Bit-equal to one process's ``run`` on each rank's page, and to its
    ``run`` on both pages at once but for the float outputs, which lie
    within 1e-6 there (the CPU's convs round a batch of one page and a batch
    of two apart: 1 ulp on 3 of the 16 scores)."""
    pipe, pages = _pipeline(), _pages()
    with torch.no_grad():
        blocks = [pipe.run(None, None, pages[b:b + 1]) for b in range(WORLD)]
        both = pipe.run(None, None, pages)
    got = two_ranks["served"]
    assert sorted(got) == sorted(both)
    assert both["valid"].any()
    for k, v in both.items():
        v = v.numpy()
        np.testing.assert_array_equal(got[k], np.concatenate([b[k].numpy() for b in blocks]),
                                      err_msg=k)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])


def test_make_mesh_defaults_to_the_card_and_never_quietly_to_the_cpu(monkeypatch):
    """With no device named, ``make_mesh`` takes the card, as ``init_mesh``
    does; where there is none it raises instead of falling back to the CPU,
    which it takes only when asked."""
    from megreader_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh("cuda")
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
