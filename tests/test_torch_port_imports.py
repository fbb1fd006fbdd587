"""The port stands alone: no module of ``megreader_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, msgpack or PyYAML (the card's machine has
none; the port reads flax's msgpack files and the YAML configs with its own
readers) or the JAX package
(checked on the AST of every file), and ``chip_smoke.py`` refuses to run
without a CUDA device or outside the repository."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "megreader_tpu")
FILES = sorted((ROOT / "megreader_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    for name in _imported(ast.parse(path.read_text(), str(path))):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_every_port_module_is_checked():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for sub in ("core", "ops", "models", "compat", "pipelines", "data", "train", "utils",
                "postproc", "parallel"):
        assert any(n.startswith(f"megreader_tpu_torch/{sub}/") for n in names), sub
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("module", [
    "ops/extract.py", "ops/losses.py", "ops/gt_maps.py", "data/processes.py",
    "postproc/detection.py", "postproc/measurers.py", "evaluation.py", "experiment.py",
])
def test_detection_slice_modules_are_checked(module):
    assert ROOT / "megreader_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", ["ops/precision.py", "compat/msgpack.py",
                                    "pipelines/predictors.py", "pipelines/e2e.py"])
def test_bf16_slice_modules_are_checked(module):
    assert ROOT / "megreader_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", ["cli/__init__.py", "cli/train.py", "cli/eval.py",
                                    "cli/pipeline.py", "core/config.py", "core/registry.py",
                                    "all.py", "data/imageio.py"])
def test_chassis_slice_modules_are_checked(module):
    assert ROOT / "megreader_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", ["ops/quantize.py", "parallel/__init__.py",
                                    "parallel/mesh.py"])
def test_int8_and_parallel_slice_modules_are_checked(module):
    assert ROOT / "megreader_tpu_torch" / module in FILES


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_cv2_or_pil(path):
    """The card's machine has neither, nor any font file: no port file
    imports them, anywhere in a file, or names the system's font directory."""
    for name in _imported(ast.parse(path.read_text(), str(path))):
        assert name.split(".")[0] not in ("cv2", "PIL"), f"{path.relative_to(ROOT)} imports {name}"
    assert "/usr/share/fonts" not in path.read_text(), f"{path.relative_to(ROOT)} names fonts"


@pytest.mark.parametrize("module", ["data/datasets.py", "data/processes.py",
                                    "data/text_render.py", "data/raster.py",
                                    "data/hard_synth.py", "data/imageio.py", "data/jpeg.py"])
def test_synthetic_tier_modules_are_checked(module):
    assert ROOT / "megreader_tpu_torch" / module in FILES


@pytest.mark.parametrize("module", ["data/png.py", "data/bitmap.py", "data/jpeg.py",
                                    "data/imageio.py", "data/gif.py", "data/tiff.py"])
def test_image_reader_modules_are_checked(module):
    """The readers of every page format (no cv2, PIL or JAX in them: the
    checks above run on each)."""
    assert ROOT / "megreader_tpu_torch" / module in FILES
