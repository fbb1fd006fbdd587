"""The port's chassis against the JAX package's, on the CPU: its YAML reader
and config loader (``core/config.py``, no PyYAML) on every file of
``experiments/``, ``import:``, cycles, ``$ref:``, dotted overrides and the
command line's values; its registry (``core/registry.py``, filled by
``all.py``); and ``Experiment.from_yaml`` on all 20 experiments, which
build with the JAX experiment's hyperparameters, datasets and parameter
shapes (the two disk experiments on data written to a temporary directory).
The models are built on the CPU by a plain dotted override
(``experiment.model.device: cpu``)."""

import glob
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

import megreader_tpu.all  # noqa: F401  (the JAX registry)
from megreader_tpu.core import config as jax_config
from megreader_tpu.experiment import Experiment as JaxExperiment
from megreader_tpu_torch.compat.weights import export_flax_variables
from megreader_tpu_torch.core import config
from megreader_tpu_torch.core.registry import COMPONENTS, Registry
from megreader_tpu_torch.experiment import Experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = sorted(glob.glob(os.path.join(REPO, "experiments", "*.yaml")))
CPU = {"experiment.model.device": "cpu"}
#: the experiments the port builds; every other one names its ROADMAP item
BUILT = {"ctc_resnet18_synth": "CTCRecognizer", "ctc2d_resnet18_synth": "Ctc2dRecognizer",
         "attention_resnet18_synth": "AttentionRecognizer",
         "seg_detector_synth": "SegDetector", "attention_hard": "AttentionRecognizer",
         "ctc2d_curved_ab": "Ctc2dRecognizer", "ctc2d_hard": "Ctc2dRecognizer",
         "ctc_curved_ab": "CTCRecognizer", "ctc_hard": "CTCRecognizer",
         "ctc_hard48": "CTCRecognizer", "ctc_hard_mix": "CTCRecognizer",
         "ctc_hard_mix_long": "CTCRecognizer", "ctc_hard_small": "CTCRecognizer",
         "ctc_listfile_disk": "CTCRecognizer", "seg_detector_hard": "SegDetector",
         "seg_detector_icdar_disk": "SegDetector", "roi_spotter_synth": "RoITextSpotter",
         "seg_detector_dcn_synth": "SegDetector", "shared_spotter_hard": "SharedTrunkSpotter",
         "shared_spotter_synth": "SharedTrunkSpotter"}
#: the tasks whose nets take pages
PAGE_TASKS = ("SegDetector", "RoITextSpotter", "SharedTrunkSpotter")


def _name(path):
    return os.path.basename(path)[:-len(".yaml")]


def test_every_experiment_is_classified():
    assert len(EXPERIMENTS) == 20
    assert sorted(map(_name, EXPERIMENTS)) == sorted(BUILT)


@pytest.mark.parametrize("path", EXPERIMENTS, ids=_name)
def test_load_yaml_matches_jax(path):
    got = config.load_yaml(path)
    assert got == jax_config.load_yaml(path)
    assert got == config.Config.load(path)


#: one YAML document of the subset each; the reader must give what PyYAML's
#: safe_load gives, types included
DOCUMENTS = [
    "1e-3", "1.0e-3", "1.0e3", "3.0e+2", ".5", "-.inf", ".nan", "1_000", "0x1f", "017",
    "0b101", "08", "-0", "+3", "190:20:30.15", "1:30", "true", "yes", "off", "On", "NO",
    "y", "n", "null", "~", "", "'it''s'", '"a\\tb \\u00e9"', "foo bar", "a#b", "a #b",
    "[640, 640]", "[]", "{}", "[a, b,]", "{a: 1, b: [x, 'y'], c}",
    "key: val", "- a\n- b", "-", "- - a\n  - b\n- c",
    "a:\n  - 1\n  - 2\nb: c", "a:\n- 1\n- 2\nb: 3",
    "x: [1, 2]  # c\ny: 'it''s'  # d\n# whole line\nz: don't # e",
    "parts:\n  - class: A\n    n: 1\n  - class: B\n    seed: 5\nnext: 2",
    "a: b\nc:\n  d:\n    e: 1\n  f: 2\ng:", "'a': 1\n\"b c\": 2\n3: x\ntrue: y",
]


@pytest.mark.parametrize("text", DOCUMENTS, ids=repr)
def test_reader_resolves_as_safe_load(text):
    got, ref = config.parse_yaml(text), yaml.safe_load(text)
    if isinstance(ref, float) and math.isnan(ref):
        assert isinstance(got, float) and math.isnan(got)
        return
    assert got == ref
    assert type(got) is type(ref)


@pytest.mark.parametrize("text,line,what", [
    ("a: 1\nb: &x 1", 2, "anchors"), ("a: *x", 1, "aliases"), ("a: !!str 1", 1, "tags"),
    ("a: |\n  x", 1, "block scalars"), ("a: >\n  x", 1, "block scalars"),
    ("a: 1\n---\nb: 2", 2, "several documents"), ("%YAML 1.1\na: 1", 1, "directives"),
    ("a: 2001-12-14", 1, "timestamps"), ("<<: {a: 1}", 1, "merge keys"),
    ("a: b: c", 1, "mapping values"), ("a: b\n  c", 2, "multi-line"),
    ("a:\n\t b: 1", 2, "tabs"), ("a: 'open", 1, "unterminated"),
    ("a: [1, 2", 1, "flow collection"), ('a: "\\q"', 1, "escape"),
    ("a:\n  b: 1\n c: 2", 3, "indentation"),
])
def test_outside_the_subset_raises_naming_file_and_line(text, line, what):
    with pytest.raises(config.YAMLError, match=f"^cfg.yaml:{line}: .*{what}"):
        config.parse_yaml(text, "cfg.yaml")


def test_import_and_overrides(tmp_path):
    (tmp_path / "base.yaml").write_text("model:\n  lr: 0.01\n  depth: 18\n")
    exp = tmp_path / "exp.yaml"
    exp.write_text("import: [base.yaml]\nmodel:\n  lr: 0.1\nname: exp1\n")
    cfg = config.Config.load(str(exp))
    assert cfg["model"] == {"lr": 0.1, "depth": 18}  # the importing file wins
    assert cfg == jax_config.Config.load(str(exp))
    over = {"model.depth": 50, "model.new.deep": [1, 2]}
    assert config.Config.load(str(exp), over) == jax_config.Config.load(str(exp), over)
    assert config.Config.load(str(exp), over)["model"]["depth"] == 50


def test_import_cycle_is_refused(tmp_path):
    (tmp_path / "a.yaml").write_text("import: [b.yaml]\nx: 1\n")
    (tmp_path / "b.yaml").write_text("import: [a.yaml]\ny: 2\n")
    with pytest.raises(ValueError, match="import cycle"):
        config.load_yaml(str(tmp_path / "a.yaml"))


def test_ref_resolution(tmp_path):
    f = tmp_path / "r.yaml"
    f.write_text("shared:\n  cs: {alphabet: abc}\nuser:\n  charset: '$ref:shared.cs'\n"
                 "chain: $ref:user.charset\n")
    cfg = config.Config.load(str(f))
    assert cfg["user"]["charset"] == {"alphabet": "abc"} == cfg["chain"]
    assert cfg == jax_config.Config.load(str(f))


@COMPONENTS.register
class _PortLeaf:
    def __init__(self, value=0):
        self.value = value


@COMPONENTS.register
class _PortNode:
    def __init__(self, child=None, items=()):
        self.child, self.items = child, items


def test_instantiate_builds_nested_class_nodes():
    obj = config.instantiate({"class": "_PortNode", "child": {"class": "_PortLeaf", "value": 3},
                              "items": [{"class": "_PortLeaf", "value": 1}, 7]})
    assert isinstance(obj, _PortNode) and obj.child.value == 3
    assert obj.items[0].value == 1 and obj.items[1] == 7


ARGV = [
    ["--train.lr", "1e-3", "--validate", "--name", "foo"],
    ["--a", "1.0e-3", "--b", "7", "--c", "0x10", "--d", "-2", "--e", "1_000"],
    ["--a", "true", "--b", "yes", "--c", "off", "--d", "null", "--e", "~", "--f", ""],
    ["--a", "'quoted'", "--b", '"1e-3"', "--c", "[640, 640]", "--d", "{k: v}"],
    ["--a", "inf", "--b", "nan", "--c", "1e5", "--d", "cpu", "--e", "a b"],
    ["--flag", "--x.y.z", "3"],
]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a))
def test_parse_cli_overrides_matches_jax(argv):
    got, ref = config.parse_cli_overrides(argv), jax_config.parse_cli_overrides(argv)
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], float) and math.isnan(ref[k]):
            assert math.isnan(got[k])
        else:
            assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k
    with pytest.raises(ValueError, match="expected --key"):
        config.parse_cli_overrides(["value"])


def test_registry_refuses_duplicates_and_names_unknown_keys():
    reg = Registry("test")

    class A:
        pass

    class B:
        pass

    reg.register(A)
    reg.register(A)  # the same class again is fine
    with pytest.raises(KeyError, match="duplicate registration for 'A'"):
        reg.register(B, name="A")
    with pytest.raises(KeyError, match="unknown component 'C'. Known: A"):
        reg.get("C")
    assert "A" in reg and list(reg) == ["A"]


def test_port_registry_is_its_own():
    import megreader_tpu_torch.all  # noqa: F401
    from megreader_tpu.core.registry import COMPONENTS as JAX_COMPONENTS

    assert COMPONENTS is not JAX_COMPONENTS
    assert COMPONENTS.get("Experiment") is Experiment
    assert JAX_COMPONENTS.get("Experiment") is JaxExperiment
    # every JAX component name resolves in the port, ported or as a stub
    # (names with a leading underscore are other tests' own classes)
    assert {n for n in JAX_COMPONENTS if not n.startswith("_")} <= set(COMPONENTS)


def _flax_shapes(tree):
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _disk_data(root):
    """The disk experiments' data, written to ``root`` by
    ``scripts/make_disk_dataset.py``'s exporters, and the dotted overrides
    that point both packages at it."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_disk_dataset import export_detection, export_recognition

    from megreader_tpu.data import SyntheticDetectionDataset, SyntheticRecognitionDataset

    over = {}
    for split, n in (("train", 3), ("eval", 2)):
        rec, det = os.path.join(root, "rec", split), os.path.join(root, "det", split)
        export_recognition(SyntheticRecognitionDataset(n=n, seed=n), rec)
        export_detection(SyntheticDetectionDataset(n=n, hw=(96, 96), seed=n, gt_maps=False),
                         det)
        over[f"experiment.{split}_dataset.list_path"] = os.path.join(rec, "list.txt")
        over[f"experiment.{split}_dataset.image_dir"] = os.path.join(det, "images")
        over[f"experiment.{split}_dataset.gt_dir"] = os.path.join(det, "gts")
    return over


def _dataset_key(ds):
    """What a dataset is: its class, length, seed (if it has one) and parts."""
    return (type(ds).__name__, len(ds), getattr(ds, "seed", None),
            [_dataset_key(p) for p in getattr(ds, "parts", ())])


@pytest.mark.parametrize("path", EXPERIMENTS, ids=_name)
def test_from_yaml_builds_or_names_its_item(path, tmp_path):
    name = _name(path)
    over = {}
    if name.endswith("_disk"):
        disk = _disk_data(str(tmp_path))
        kind = "list_path" if name.startswith("ctc") else "_dir"
        over = {k: v for k, v in disk.items() if k.endswith(kind)}
    exp = Experiment.from_yaml(path, {**CPU, **over})
    ref = JaxExperiment.from_yaml(path, over)
    assert exp.task == ref.task == BUILT[name]
    assert (exp.name, exp.seed, exp.epochs, exp.crop_hw) == (ref.name, ref.seed, ref.epochs,
                                                             ref.crop_hw)
    assert exp.workspace == ref.workspace
    for loader in ("train_loader", "eval_loader"):
        got, want = getattr(exp, loader), getattr(ref, loader)
        assert got.batch_size == want.batch_size
        assert got.worker_mode == want.worker_mode
        assert _dataset_key(got.dataset) == _dataset_key(want.dataset)
    assert vars(exp.optimizer) == vars(ref.optimizer)
    assert type(exp.charset).__name__ == type(ref.charset).__name__
    hw = (1, 64, 64, 3) if ref.task in PAGE_TASKS else (1, *ref.crop_hw, 3)
    abstract = jax.eval_shape(ref.model.init, jax.random.PRNGKey(0), jnp.zeros(hw))
    exported = export_flax_variables(exp.model.net)
    for col in abstract:
        assert _flax_shapes(exported[col]) == _flax_shapes(abstract[col]), col


def test_from_yaml_seeds_the_weights():
    path = os.path.join(REPO, "experiments", "ctc2d_resnet18_synth.yaml")
    a, b = (Experiment.from_yaml(path, CPU).model.net.state_dict() for _ in range(2))
    c = Experiment.from_yaml(path, {**CPU, "experiment.seed": 1}).model.net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_from_yaml_refuses_options_left_out(tmp_path):
    """``use_mesh`` (item 14), ``augment`` and process workers (item 7)
    build; ``use_mesh`` with no process group is a world of one."""
    path = os.path.join(REPO, "experiments", "ctc2d_resnet18_synth.yaml")
    mesh = Experiment.from_yaml(path, {**CPU, "experiment.use_mesh": True}).make_trainer().mesh
    assert (mesh.rank, mesh.world_size, mesh.device.type, mesh.group) == (0, 1, "cpu", None)
    exp = Experiment.from_yaml(path, {**CPU, "experiment.augment": True,
                                      "experiment.loader_worker_mode": "process"})
    assert exp.augment and exp.train_loader.worker_mode == "process"
    assert exp.make_trainer().prepare_batch is exp.prepare
    f = tmp_path / "no_experiment.yaml"
    f.write_text("model:\n  class: Charset\n")
    with pytest.raises(ValueError, match="must define an 'experiment:' node"):
        Experiment.from_yaml(str(f))


def test_from_yaml_self_registers_in_fresh_process():
    """``from_yaml`` fills the registry itself: a fresh interpreter that
    imports nothing else builds config #1."""
    code = ("from megreader_tpu_torch.experiment import Experiment;"
            "e = Experiment.from_yaml('experiments/ctc_resnet18_synth.yaml',"
            "{'experiment.model.device': 'cpu'});"
            "import sys; print('OK', e.task, 'jax' in sys.modules, 'yaml' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK CTCRecognizer False False" in out.stdout


@pytest.mark.parametrize("name,over", [
    ("seg_detector_synth", {"experiment.model.backbone": "resnet50"}),
    ("seg_detector_icdar_disk", {"experiment.model.backbone": "resnet101"}),
    ("ctc_resnet18_synth", {"experiment.model.backbone": "resnet50"}),
    ("ctc_resnet18_synth", {"experiment.model.backbone": "resnet101",
                            "experiment.model.dcn_stages": [4]}),
], ids=["det-resnet50", "det-resnet101", "ctc-resnet50", "ctc-resnet101-dcn4"])
def test_bottleneck_backbone_overrides_build(name, over, tmp_path):
    """The Bottleneck trunks by YAML override build with the JAX
    experiment's parameter shapes (DB's deformable ResNet-50 against JAX:
    ``test_torch_port_bottleneck.py``)."""
    path = os.path.join(REPO, "experiments", f"{name}.yaml")
    if name.endswith("_disk"):
        over = {**over, **{k: v for k, v in _disk_data(str(tmp_path)).items()
                           if k.endswith("_dir")}}
    exp = Experiment.from_yaml(path, {**CPU, **over})
    ref = JaxExperiment.from_yaml(path, over)
    hw = (1, 64, 64, 3) if ref.task in PAGE_TASKS else (1, *ref.crop_hw, 3)
    abstract = jax.eval_shape(ref.model.init, jax.random.PRNGKey(0), jnp.zeros(hw))
    exported = export_flax_variables(exp.model.net)
    for col in abstract:
        assert _flax_shapes(exported[col]) == _flax_shapes(abstract[col]), col


def test_lmdb_dataset_builds_from_a_yaml_override(tmp_path):
    """``LMDBRecognitionDataset`` is registered as the JAX package registers
    it (``@register`` in its module; the port's ``all.py`` imports it), so a
    YAML's dataset node builds it; its items equal the JAX dataset's."""
    import cv2
    import numpy as np

    import megreader_tpu.data.lmdb_dataset  # noqa: F401  (registers the JAX class)
    from megreader_tpu_torch.data.lmdb_lite import write_fixture_lmdb

    records = {b"num-samples": b"3"}
    for i in range(3):
        img = np.full((20, 40 + 10 * i, 3), 60 * i, np.uint8)
        records[f"image-{i + 1:09d}".encode()] = cv2.imencode(".jpg", img)[1].tobytes()
        records[f"label-{i + 1:09d}".encode()] = f"abc{i}".encode()
    write_fixture_lmdb(str(tmp_path), records)
    node = {"class": "LMDBRecognitionDataset", "path": str(tmp_path), "canvas_hw": [32, 100]}
    path = os.path.join(REPO, "experiments", "ctc_resnet18_synth.yaml")
    over = {"experiment.train_dataset": node}
    exp = Experiment.from_yaml(path, {**CPU, **over})
    ref = JaxExperiment.from_yaml(path, over)
    got, want = exp.train_loader.dataset, ref.train_loader.dataset
    assert type(got).__name__ == type(want).__name__ == "LMDBRecognitionDataset"
    assert len(got) == len(want) == 3
    for i in range(3):
        assert got[i]["text"] == want[i]["text"]
        np.testing.assert_array_equal(got[i]["image"], want[i]["image"])


def test_refusals_name_roadmap_item_15b():
    """Items 15b and 15c (the last of Queue 1) are ported: no file of the
    port names a ROADMAP Queue 1 item, and the ``DetectionVisualizer`` of a
    YAML is the port's."""
    import re

    found = []
    for root, _, files in os.walk(os.path.join(REPO, "megreader_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    found += re.findall(r"ROADMAP Queue 1 item ([0-9a-z{}]+)", fh.read())
    assert found == [], found
    import megreader_tpu_torch.all  # noqa: F401
    from megreader_tpu_torch.postproc.visualizer import DetectionVisualizer

    assert COMPONENTS.get("DetectionVisualizer") is DetectionVisualizer
