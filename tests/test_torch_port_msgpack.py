"""The port's msgpack decoder (``compat/msgpack.py``) against flax's.

* The committed detector asset, leaf by leaf against
  ``flax.serialization.msgpack_restore``: the same paths, dtypes, shapes and
  bytes; ``load_flax_msgpack`` widens its float16 to float32 as
  ``bench.py`` does and carries it into the port's detector.
* Seeded trees written by ``msgpack_serialize`` with every type of the
  subset: nil, bools, integers of each width, floats, str and bin of each
  length class, arrays and maps of each size class, 0-d and n-d arrays of
  each float, int and bool dtype, numpy scalars, complex numbers, and
  flax's chunked form of a large array.
* Truncated input, trailing bytes, an unknown type byte and an unknown ext
  code raise.
"""

import os

import msgpack
import numpy as np
import pytest
from flax import serialization

from megreader_tpu_torch.compat import msgpack as port_msgpack
from megreader_tpu_torch.compat.weights import load_flax_variables
from megreader_tpu_torch.models.detector import SegDetector

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "bench_det_fp16.msgpack")
DTYPES = ("float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
          "uint16", "uint32", "uint64", "bool")


def _assert_same(got, ref, path=()):
    """Equal trees: the same keys and types, arrays bit for bit."""
    assert type(got) is type(ref), (path, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], path + (k,))
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, path + (i,))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    elif isinstance(ref, float):
        assert np.float64(got).tobytes() == np.float64(ref).tobytes(), path
    else:
        assert got == ref, path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def asset_bytes():
    with open(ASSET, "rb") as f:
        return f.read()


def test_asset_decodes_as_flax_does(asset_bytes):
    got = port_msgpack.msgpack_restore(asset_bytes)
    ref = serialization.msgpack_restore(asset_bytes)
    _assert_same(got, ref)
    arrays = [a for _, a in _leaves(got["variables"])]
    assert len(arrays) == 140 and {a.dtype for a in arrays} == {np.dtype(np.float16)}
    assert got["step"] == 640


def test_load_flax_msgpack_widens_and_loads(asset_bytes):
    variables, step = port_msgpack.load_flax_msgpack(ASSET)
    ref = serialization.msgpack_restore(asset_bytes)["variables"]
    assert step == 640
    got, want = dict(_leaves(variables)), dict(_leaves(ref))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], a.astype(np.float32), err_msg="/".join(k))
    det = SegDetector(device="cpu")
    load_flax_variables(det.net, variables)  # every key used, every shape fits
    np.testing.assert_array_equal(det.net.prob_head.up2.bias.detach().numpy(),
                                  want[("params", "prob_head", "up2", "bias")].astype(np.float32))


def _seeded_tree(seed: int):
    """A tree with every type of the subset, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name in DTYPES:
        shape = tuple(int(n) for n in rng.integers(1, 5, int(rng.integers(1, 4))))
        if name == "bool":
            a = rng.random(shape) < 0.5
        elif name.startswith("float"):
            a = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4)).astype(name)
        else:
            info = np.iinfo(name)
            a = rng.integers(info.min, info.max, shape, dtype=name, endpoint=True)
        arrays[name] = {"nd": a, "zero_d": np.asarray(a.reshape(-1)[0]),
                        "empty": np.zeros((0, 3), name), "scalar": a.reshape(-1)[-1]}
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32,
            -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
            int(rng.integers(-2**62, 2**62))]
    text = "".join(chr(int(c)) for c in rng.integers(0x20, 0x7E, 70_000))
    return {
        "none": None, "true": True, "false": False, "ints": ints,
        "floats": [0.0, -0.0, float(rng.standard_normal()), 1e300, float("inf"), -1.5],
        "nan": float("nan"),
        "str": {"empty": "", "fix": text[:31], "s8": text[:255], "s16": text[:65535],
                "s32": text[:65536], "unicode": "é中\U0001f600"},
        "bin": {"b8": rng.bytes(255), "b16": rng.bytes(65535), "b32": rng.bytes(65536)},
        "lists": {"fix": list(range(15)), "a16": list(range(16)),
                  "nested": [[1, [2, [3, {"x": 4.5}]]], []]},
        "maps": {"fix": {str(i): i for i in range(15)}, "m16": {str(i): i for i in range(16)},
                 "empty": {}},
        "complex": complex(float(rng.standard_normal()), -2.0),
        "arrays": arrays,
        "step": int(rng.integers(0, 10_000)),
    }


def _same_nan_aware(got, ref):
    assert np.isnan(got.pop("nan")) and np.isnan(ref.pop("nan"))
    _assert_same(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_trees_decode_as_flax_does(seed):
    data = serialization.msgpack_serialize(_seeded_tree(seed))
    _same_nan_aware(port_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))


def test_chunked_arrays_join_as_flax_does(monkeypatch):
    """flax writes an array over ``MAX_CHUNK_SIZE`` bytes as a map of chunks;
    both decoders join them back."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "small": np.arange(3, dtype=np.int16)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = port_msgpack.msgpack_restore(data)
    _assert_same(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


@pytest.mark.parametrize("cut", [1, 2, 10, 0.25, 0.5, 0.9, -1])
def test_truncated_input_raises(cut):
    data = serialization.msgpack_serialize(_seeded_tree(3))
    n = cut if isinstance(cut, int) and cut > 0 else (
        len(data) + cut if isinstance(cut, int) else int(len(data) * cut))
    with pytest.raises(ValueError, match="truncated"):
        port_msgpack.msgpack_restore(data[:n])


def test_load_flax_msgpack_wants_step_and_variables(tmp_path):
    path = tmp_path / "vars.msgpack"
    path.write_bytes(serialization.msgpack_serialize({"params": {"w": np.zeros(2)}}))
    with pytest.raises(ValueError, match="not a"):
        port_msgpack.load_flax_msgpack(str(path))


@pytest.mark.parametrize("case", ["ext_code", "type_byte", "trailing", "ndarray_size"])
def test_bad_input_raises(case):
    if case == "ext_code":
        data = msgpack.packb({"a": msgpack.ExtType(9, b"xyz")})
        match = "ext code 9"
    elif case == "type_byte":
        data = b"\x81\xa1a\xc1"  # {"a": <0xc1, never used>}
        match = "type byte 0xc1"
    elif case == "trailing":
        data = serialization.msgpack_serialize({"a": np.zeros(3)}) + b"\x00"
        match = "after the msgpack object"
    else:  # an ndarray whose bytes do not fill its shape
        payload = msgpack.packb(((2, 3), "float32", b"\x00" * 20), use_bin_type=True)
        data = msgpack.packb({"a": msgpack.ExtType(1, payload)})
        match = "bytes of data"
    with pytest.raises(ValueError, match=match):
        port_msgpack.msgpack_restore(data)
