"""Port trainer, checkpoints and experiment wiring, on the CPU at the tiny size
of ``tests/test_train.py`` (hidden 32, one BiLSTM layer, batch 8 of 16 synthetic
crops), mirroring its checkpoint and trainer tests."""

import json
import os

import numpy as np
import pytest
import torch

from megreader_tpu_torch.data.datasets import SyntheticRecognitionDataset
from megreader_tpu_torch.evaluation import evaluate_recognition
from megreader_tpu_torch.experiment import Experiment
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.train.checkpoint import CheckpointManager
from megreader_tpu_torch.train.logger import AverageMeter
from megreader_tpu_torch.train.train_step import OptimizerConfig, create_train_state
from megreader_tpu_torch.train.trainer import Trainer
from megreader_tpu_torch.utils.signal_monitor import SignalMonitor

ADAM = OptimizerConfig(name="adam", lr=1e-3, schedule="warmup_cosine", warmup_steps=2,
                       total_steps=20)


def _model(seed=0):
    torch.manual_seed(seed)
    return CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1, device="cpu")


def _experiment(workspace, epochs=2, **kw):
    return Experiment(_model(), SyntheticRecognitionDataset(n=16), batch_size=8, epochs=epochs,
                      log_every=1, workspace=str(workspace), optimizer=ADAM, **kw)


def _metrics(workspace):
    with open(os.path.join(workspace, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_epochs_train_and_resume_does_nothing(tmp_path):
    """``epochs`` is a total budget: 2 epochs of 2 batches are 4 steps, and a
    second ``train(resume=True)`` restores step 4 and trains no further."""
    exp = _experiment(tmp_path)
    state = exp.make_trainer().train()
    assert state.step == 4
    lines = _metrics(tmp_path)
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lines)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    weights = {k: v.clone() for k, v in exp.model.net.state_dict().items()}

    again = exp.make_trainer().train(resume=True)
    assert again.step == 4
    assert len(_metrics(tmp_path)) == 4
    for k, v in exp.model.net.state_dict().items():
        torch.testing.assert_close(v, weights[k], rtol=0, atol=0)


def test_resume_trains_on_to_the_budget(tmp_path):
    _experiment(tmp_path, epochs=1).make_trainer().train()
    state = _experiment(tmp_path, epochs=2).make_trainer().train(resume=True)
    assert state.step == 4
    assert [r["step"] for r in _metrics(tmp_path)] == [1, 2, 3, 4]


def test_checkpoint_round_trip(tmp_path):
    """Save and restore round-trip the step, the module and the optimizer."""
    exp = _experiment(tmp_path, epochs=1)
    state = exp.make_trainer().train(resume=False)
    mgr = CheckpointManager(str(tmp_path / "copy"), save_every_steps=1)
    assert mgr.save(state, force=True)
    fresh = create_train_state(_model(seed=1), ADAM)
    restored = mgr.restore(fresh)
    assert restored.step == state.step == 2
    for k, v in state.module.state_dict().items():
        torch.testing.assert_close(restored.module.state_dict()[k], v, rtol=0, atol=0)
    a, b = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert a["count"] == b["count"] == 2
    for i, s in a["inner"]["state"].items():
        for key, t in s.items():
            torch.testing.assert_close(b["inner"]["state"][i][key], t, rtol=0, atol=0)


def test_checkpoints_are_pruned_to_keep(tmp_path):
    state = create_train_state(_model(), ADAM)
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every_steps=2)
    saved = [mgr.save(state, step) for step in range(1, 8)]
    assert saved == [False, True, False, True, False, True, False]
    assert sorted(os.listdir(mgr.dir)) == ["state_00000004.pt", "state_00000006.pt"]
    assert mgr.latest_step() == 6
    assert mgr.save(state, 7, force=True)
    assert sorted(os.listdir(mgr.dir)) == ["state_00000006.pt", "state_00000007.pt"]


def test_restore_without_checkpoint_keeps_the_state(tmp_path):
    state = create_train_state(_model(), ADAM)
    assert CheckpointManager(str(tmp_path)).restore(state) is state
    assert state.step == 0


def test_signal_file_stops_after_saving(tmp_path):
    signal = tmp_path / "stop"
    signal.write_text("")
    exp = _experiment(tmp_path / "ws", epochs=3)
    trainer = Trainer(exp.model, exp.train_loader, ADAM, workspace=str(tmp_path / "ws"),
                      epochs=3, log_every=1, prepare_batch=exp.prepare,
                      signal_monitor=SignalMonitor(str(signal)))
    state = trainer.train()
    assert state.step == 1
    assert not signal.exists()
    assert CheckpointManager(str(tmp_path / "ws")).latest_step() == 1


def test_debug_nans_turns_on_anomaly_detection_for_the_run(tmp_path):
    exp = _experiment(tmp_path, epochs=1)
    seen = []

    def prepare(batch):
        seen.append(torch.is_anomaly_enabled())
        return exp.prepare(batch)

    Trainer(exp.model, exp.train_loader, ADAM, workspace=str(tmp_path), epochs=1,
            prepare_batch=prepare, debug_nans=True).train(resume=False)
    assert seen == [True, True]
    assert not torch.is_anomaly_enabled()


def test_validate_hook_runs_every_n_steps(tmp_path):
    exp = _experiment(tmp_path)
    calls = []

    def validate(model, state):
        calls.append(state.step)
        return {"acc": 0.5}

    Trainer(exp.model, exp.train_loader, ADAM, workspace=str(tmp_path), epochs=2,
            prepare_batch=exp.prepare, validate_every_steps=2,
            validate_fn=validate).train(resume=False)
    assert calls == [2, 4]
    assert any("eval/acc" in r for r in _metrics(tmp_path))


@pytest.mark.parametrize("what", ["augment", "mesh", "yaml", "task", "process_workers",
                                  "validation"])
def test_left_out_options_raise(tmp_path, what):
    """The options and tasks left out raise. ``validation`` is ported: a
    validation with the beam decode runs and measures every eval crop.
    ``yaml`` is ported: ``from_yaml`` builds config #1, the hard tier's
    ``ctc_hard.yaml`` and the RoI text spotter's YAML. ``augment`` and
    ``process_workers`` are ported: a two-step run with each trains to
    finite losses. ``mesh`` is ported: with no process group, a two-step run
    with ``use_mesh=True`` equals one without. ``task``: the spotters are
    ported (a narrow RoI spotter trains two steps), and a model of no known
    task is refused."""
    if what == "yaml":
        exp = Experiment.from_yaml("experiments/ctc_resnet18_synth.yaml",
                                   {"experiment.model.device": "cpu"})
        assert exp.task == "CTCRecognizer" and exp.train_loader.batch_size == 64
        hard = Experiment.from_yaml("experiments/ctc_hard.yaml",
                                    {"experiment.model.device": "cpu"})
        assert type(hard.train_loader.dataset).__name__ == "HardSyntheticRecognitionDataset"
        spot = Experiment.from_yaml("experiments/roi_spotter_synth.yaml",
                                    {"experiment.model.device": "cpu"})
        assert spot.task == "RoITextSpotter" and spot.train_loader.batch_size == 8
        return
    if what == "validation":
        exp = _experiment(tmp_path, eval_dataset=SyntheticRecognitionDataset(n=8),
                          validate_every_steps=2)
        metrics = evaluate_recognition(exp, mode="beam")
        assert metrics["n"] == 8 and 0.0 <= metrics["ned"] <= 1.0
        return
    if what in ("augment", "process_workers"):
        kw = {"augment": True} if what == "augment" else {"loader_worker_mode": "process"}
        exp = _experiment(tmp_path, epochs=1, **kw)
        state = exp.make_trainer().train(resume=False)
        exp.train_loader.close()
        assert state.step == 2
        assert all(np.isfinite(r["loss"]) for r in _metrics(tmp_path))
        return
    if what == "mesh":  # ported: with no process group a world of one, the plain step
        runs = []
        for use_mesh in (False, True):
            exp = _experiment(tmp_path / str(use_mesh), epochs=1, use_mesh=use_mesh)
            state = exp.make_trainer().train(resume=False)
            runs.append(([r["loss"] for r in _metrics(tmp_path / str(use_mesh))],
                         state.module.state_dict()))
        assert len(runs[0][0]) == 2 and runs[0][0] == runs[1][0]
        assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
        return
    # the text spotter is ported: a narrow RoI spotter takes the spotting
    # collate and prepare and trains; a model of no known task is refused
    from megreader_tpu_torch.data.datasets import SyntheticDetectionDataset
    from megreader_tpu_torch.models.spotter import RoITextSpotter

    spotter = RoITextSpotter(num_classes=37, fpn_dim=32, pool_hw=(2, 16), hidden=16,
                             device="cpu")
    exp = Experiment(spotter, SyntheticDetectionDataset(n=4, hw=(128, 128), seed=3),
                     batch_size=2, epochs=1, log_every=1, max_label_len=16,
                     workspace=str(tmp_path), loader_workers=1)
    state = exp.make_trainer().train(resume=False)
    assert state.step == 2 and all(np.isfinite(r["loss"]) for r in _metrics(tmp_path))
    with pytest.raises(ValueError, match="unknown task"):
        Experiment(type("Spotter", (), {"net": spotter.net})(), SyntheticRecognitionDataset(n=8))


def test_average_meter():
    m = AverageMeter()
    assert m.avg == 0.0
    m.update(2.0)
    m.update(4.0, n=3)
    assert m.avg == pytest.approx(3.5)
    m.reset()
    assert m.count == 0
