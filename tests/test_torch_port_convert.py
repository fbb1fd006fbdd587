"""``compat/torch_convert.py`` against the JAX package's: torchvision-layout
ResNet-18 and ResNet-50 state dicts (``torch_twins.
torchvision_style_state_dict`` of seeded trunks; no pretrained file is in
the repository) become the same flax tree in both packages, bit for bit,
and the port's trunk loaded from it gives flax's features within 1e-5;
``compat/torch_ref.py``'s CRNN twin through ``convert_state_dict`` gives
JAX's logits within 1e-5 (``tests/test_torch_parity.py`` is JAX's own test
of that route); ``load_torch_state_dict`` loads a port module directly; and
the tree checks and refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.compat import torch_convert as jax_convert
from megreader_tpu.compat.torch_ref import TorchCTCRecognizer, flax_state_dict
from megreader_tpu.compat.torch_twins import torchvision_style_state_dict
from megreader_tpu.models import CTCRecognizerNet as JaxCTCRecognizerNet
from megreader_tpu.models.resnet import resnet_variant as jax_resnet_variant
from megreader_tpu_torch.compat import torch_convert
from megreader_tpu_torch.models.recognizer import CTCRecognizerNet
from megreader_tpu_torch.models.resnet import resnet_variant


def _randomize(module, seed):
    """``tests/test_torch_parity.py``'s draws: every parameter N(0, 0.08),
    running means N(0, 0.05), running variances U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.08)
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.05)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return module.eval()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("name,width", [("resnet18", 16), ("resnet50", 8)])
def test_torchvision_trunk_converts_as_in_jax(name, width):
    """A torchvision-layout state dict (with a classifier to drop and
    ``num_batches_tracked`` counters) of a seeded trunk."""
    source = _randomize(resnet_variant(name, "det", width), 6)
    sd = torchvision_style_state_dict(source)
    assert any(k.startswith("conv1.") for k in sd) and any(k.startswith("layer4.1.") for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    sd["fc.weight"] = torch.zeros(1000, 8 * width * (4 if name == "resnet50" else 1))
    sd["fc.bias"] = torch.zeros(1000)
    tree = torch_convert.convert_torchvision_resnet(sd)
    ref = jax_convert.convert_torchvision_resnet(sd)
    flat, ref_flat = _flat(tree), _flat(ref)
    assert flat.keys() == ref_flat.keys()
    for k in flat:
        assert flat[k].dtype == ref_flat[k].dtype, k
        np.testing.assert_array_equal(flat[k], ref_flat[k], err_msg="/".join(k))

    trunk = torch_convert.load_torch_state_dict(resnet_variant(name, "det", width),
                                                torch_convert.torchvision_resnet_keys(sd))
    x = np.random.default_rng(7).standard_normal((1, 64, 64, 3)).astype(np.float32)
    fnet = jax_resnet_variant(name, variant="det", width=width)
    ref_feats = fnet.apply(jax.tree_util.tree_map(jnp.asarray, ref), jnp.asarray(x))
    with torch.no_grad():
        feats = trunk.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (f, r) in enumerate(zip(feats, ref_feats)):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=f"C{i + 2}")


def test_crnn_twin_logits_match_jax():
    twin = TorchCTCRecognizer(num_classes=37, hidden=48, num_encoder_layers=1)
    _randomize(twin, 8)
    sd = flax_state_dict(twin)
    tree = torch_convert.convert_state_dict(sd)
    ref = jax_convert.convert_state_dict(sd)
    flat, ref_flat = _flat(tree), _flat(ref)
    assert flat.keys() == ref_flat.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], ref_flat[k])
    net = torch_convert.load_torch_state_dict(CTCRecognizerNet(37, hidden=48,
                                                               num_encoder_layers=1), sd)
    img = np.random.default_rng(1).standard_normal((3, 32, 100, 3)).astype(np.float32)
    jlogits = JaxCTCRecognizerNet(num_classes=37, hidden=48, num_encoder_layers=1).apply(
        jax.tree_util.tree_map(jnp.asarray, ref), jnp.asarray(img))
    with torch.no_grad():
        logits = net.eval()(torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(logits.numpy(),
                                   twin(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy(),
                                   rtol=0, atol=2e-3)  # torch's own CRNN, as the JAX test


def test_name_map_and_tree_checks():
    sd = {"net.backbone.w.weight": torch.ones(2, 3), "other.bias": torch.zeros(2),
          "net.emb.embedding": torch.ones(4, 2)}
    tree = torch_convert.convert_state_dict(sd, name_map={"net.backbone.": "ResNet_0."})
    ref = jax_convert.convert_state_dict(sd, name_map={"net.backbone.": "ResNet_0."})
    assert _flat(tree).keys() == _flat(ref).keys()
    assert tree["params"]["ResNet_0"]["w"]["kernel"].shape == (3, 2)
    assert torch_convert.tree_shapes(tree) == {
        "params": {"ResNet_0": {"w": {"kernel": (3, 2)}}, "other": {"bias": (2,)},
                   "net": {"emb": {"embedding": (4, 2)}}}}
    torch_convert.assert_tree_compatible(tree, ref)
    with pytest.raises(KeyError, match="unhandled torch checkpoint key"):
        torch_convert.convert_state_dict({"a.running_stuff": torch.zeros(1)})
    broken = jax.tree_util.tree_map(lambda a: a, ref)
    broken["params"]["other"]["bias"] = np.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch at params/other/bias"):
        torch_convert.assert_tree_compatible(tree, broken)
    del broken["params"]["other"]
    with pytest.raises(ValueError, match="extra: \\['params/other/bias'\\]"):
        torch_convert.assert_tree_compatible(tree, broken)
    with pytest.raises(KeyError, match="do not match the module"):
        torch_convert.load_torch_state_dict(resnet_variant("resnet18", "det", 8),
                                            {"conv1.weight": torch.zeros(8, 3, 7, 7)})
