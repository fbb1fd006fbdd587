"""The hard synthetic tier as its eleven experiment files use it, on the CPU
with cv2 and PIL unimportable, as on the card's machine:

* the first items of the five dataset entries of
  ``scripts/make_port_hard_assets.py`` equal the digests it wrote from the
  JAX package's items (``assets/synth/hard_manifest.json``, which phase
  synth of ``chip_smoke.py`` checks on the card);
* each of the eleven files builds through ``Experiment.from_yaml`` and its
  train loader gives its first batch (process workers included) in one
  process whose ``PYTHONPATH`` starts with a ``cv2.py`` and a ``PIL/`` that
  raise ImportError.
"""

import json
import os
import subprocess
import sys

import pytest

from megreader_tpu_torch.data import hard_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "assets", "synth", "hard_manifest.json")
ELEVEN = ["ctc_hard", "ctc_hard48", "ctc_hard_mix", "ctc_hard_mix_long", "ctc_hard_small",
          "ctc_curved_ab", "ctc2d_curved_ab", "ctc2d_hard", "attention_hard",
          "seg_detector_hard", "shared_spotter_hard"]


def _manifest():
    with open(MANIFEST) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()["items"]))
def test_first_hard_items_match_the_manifest(name, monkeypatch):
    import chip_smoke

    entry = _manifest()["items"][name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(hard_synth, "_CHAR_CACHE", {})
    ds = getattr(hard_synth, entry["class"])(**entry["kwargs"])
    n = 3 if "detection" in name else 8
    for i, want in enumerate(entry["digests"][:n]):
        assert chip_smoke.item_digests(ds[i]) == want, (name, i)


def test_the_eleven_files_name_the_hard_tier():
    for name in ELEVEN:
        with open(os.path.join(REPO, "experiments", f"{name}.yaml")) as f:
            assert "HardSynthetic" in f.read(), name
    others = [p for p in os.listdir(os.path.join(REPO, "experiments"))
              if p.endswith(".yaml") and p[:-5] not in ELEVEN]
    for p in others:
        with open(os.path.join(REPO, "experiments", p)) as f:
            assert "HardSynthetic" not in f.read(), p


_FIRST_BATCHES = r"""
import json, os, sys
import numpy as np
from megreader_tpu_torch.experiment import Experiment

def main(names, repo, ws):
    out = {}
    for name in names:
        exp = Experiment.from_yaml(os.path.join(repo, "experiments", name + ".yaml"),
                                   {"experiment.model.device": "cpu",
                                    "experiment.workspace": os.path.join(ws, name)})
        loader = exp.train_loader
        it = iter(loader)
        batch = next(it)
        it.close()
        loader.close()
        out[name] = {"mode": loader.worker_mode, "batch_size": loader.batch_size,
                     "shapes": {k: list(np.shape(v)) for k, v in batch.items()
                                if isinstance(v, np.ndarray)},
                     "finite": all(bool(np.isfinite(v).all()) for v in batch.values()
                                   if isinstance(v, np.ndarray) and v.dtype.kind == "f")}
    out["cv2"] = sys.modules.get("cv2") is not None
    out["PIL"] = sys.modules.get("PIL") is not None
    print(json.dumps(out))

if __name__ == "__main__":
    main(sys.argv[3:], sys.argv[1], sys.argv[2])
"""


@pytest.fixture(scope="module")
def first_batches(tmp_path_factory):
    """One process draws the first training batch of every file."""
    tmp = tmp_path_factory.mktemp("hard_batches")
    blocker = tmp / "blocked"
    (blocker / "PIL").mkdir(parents=True)
    for path in (blocker / "cv2.py", blocker / "PIL" / "__init__.py"):
        path.write_text("raise ImportError('not installed on the card machine')\n")
    script = tmp / "first_batches.py"
    script.write_text(_FIRST_BATCHES)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(blocker), REPO])}
    out = subprocess.run([sys.executable, str(script), REPO, str(tmp / "ws"), *ELEVEN],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ELEVEN)
def test_first_training_batch_of_each_hard_file_without_cv2(name, first_batches):
    got = first_batches[name]
    assert not first_batches["cv2"] and not first_batches["PIL"]
    B = got["batch_size"]
    shapes = got["shapes"]
    assert got["finite"], got
    if name in ("seg_detector_hard", "shared_spotter_hard"):
        assert got["mode"] == "process"
        assert shapes["image"] == [B, 640, 640, 3], shapes
        for k in ("gt", "mask", "thresh_map", "thresh_mask"):
            assert shapes[k] == [B, 640, 640], (k, shapes)
    else:
        assert shapes["image"][0] == B and shapes["image"][-1] == 3, shapes
        assert shapes["label"][0] == B, shapes
