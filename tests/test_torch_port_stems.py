"""The space-to-depth stem flags (``ResNet(stem_s2d=True)``,
``stem_s2d4=True``) against the JAX package's space-to-depth stems and the
port's plain stem, as ``tests/test_detector.py:247-313`` holds JAX's. The
port's flags compute the plain stem; JAX's flags compute its TPU rewrites of
the same ``stem_conv`` weight. Held: the same parameter tree, every trunk
output within rtol/atol 1e-5 of JAX's rewrites, borders included (inputs of
64x96, 2x2 and 4x4 phases to the edge); train mode's BatchNorm statistics
within 1e-5; and through ``SegDetector``'s prob map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megreader_tpu.models.detector import SegDetector as JaxSegDetector
from megreader_tpu.models.resnet import resnet18 as jax_resnet18
from megreader_tpu_torch.compat.weights import (export_flax_variables, load_flax_variables,
                                                seeded_flax_variables)
from megreader_tpu_torch.models.detector import SegDetector
from megreader_tpu_torch.models.resnet import resnet_variant

STEMS = [{"stem_s2d": True}, {"stem_s2d4": True}]
IDS = ["s2d", "s2d4"]


def _keys(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _keys(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.fixture(scope="module")
def trunk_case():
    x = (np.random.default_rng(3).standard_normal((2, 64, 96, 3)) * 2.0).astype(np.float32)
    shapes = jax.eval_shape(jax_resnet18(variant="det", width=16).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = seeded_flax_variables(shapes, 4)
    return x, variables


@pytest.mark.parametrize("opt", STEMS, ids=IDS)
def test_stem_matches_plain_and_jax(trunk_case, opt):
    x, variables = trunk_case
    plain = load_flax_variables(resnet_variant("resnet18", "det", 16), variables).eval()
    s2d = load_flax_variables(resnet_variant("resnet18", "det", 16, **opt), variables).eval()
    # one parameter tree: checkpoints interchange
    assert sorted(_keys(export_flax_variables(s2d))) == sorted(_keys(export_flax_variables(plain)))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_plain = jax_resnet18(variant="det", width=16).apply(jvars, jnp.asarray(x), train=False)
    jax_s2d = jax_resnet18(variant="det", width=16, **opt).apply(jvars, jnp.asarray(x),
                                                                train=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        a, b = plain(xt), s2d(xt)
    for i, (fa, fb, ja, jb) in enumerate(zip(a, b, jax_plain, jax_s2d)):
        fa, fb = fa.permute(0, 2, 3, 1).numpy(), fb.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(fb, fa, rtol=1e-5, atol=1e-5, err_msg=f"C{i + 2} vs plain")
        np.testing.assert_allclose(fb, np.asarray(jb), rtol=1e-5, atol=1e-5,
                                   err_msg=f"C{i + 2} vs JAX")
        np.testing.assert_allclose(fa, np.asarray(ja), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", STEMS, ids=IDS)
def test_stem_train_mode_statistics(trunk_case, opt):
    """Train mode reduces the stem's BatchNorm over the same multiset of
    activations (for s2d4: over the four output phases at H/4)."""
    x, variables = trunk_case
    plain = load_flax_variables(resnet_variant("resnet18", "det", 16), variables).train()
    s2d = load_flax_variables(resnet_variant("resnet18", "det", 16, **opt), variables).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain(xt)
        s2d(xt)
    for t in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(s2d.stem_bn, t).numpy(),
                                   getattr(plain.stem_bn, t).numpy(), rtol=1e-5, atol=1e-5)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    _, mut = jax_resnet18(variant="det", width=16, **opt).apply(
        jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(s2d.stem_bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["stem_bn"]["mean"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", STEMS, ids=IDS)
def test_stem_through_segdetector(opt):
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    jmodel = JaxSegDetector(fpn_dim=64, head_dim=16, **opt)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(2), jnp.asarray(x))
    variables = seeded_flax_variables(shapes, 5)
    ref = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
                       heads=("prob",))["prob"]
    det = SegDetector(fpn_dim=64, head_dim=16, device="cpu", **opt)
    plain = SegDetector(fpn_dim=64, head_dim=16, device="cpu")
    load_flax_variables(det.net, variables)
    load_flax_variables(plain.net, variables)
    got = det.predict_maps(torch.from_numpy(x), heads=("prob",))["prob"].numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, plain.predict_maps(torch.from_numpy(x), heads=("prob",))["prob"].numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", STEMS, ids=IDS)
def test_stem_flags_run_the_plain_stem(opt):
    """The flags select the plain stem: the same parameters and buffers, and
    the same outputs on shapes the JAX rewrites cannot phase (66x64, 65x64)
    and on the 'rec' variant, whose stem the JAX package leaves plain."""
    torch.manual_seed(0)
    for variant, hw in (("det", (66, 64)), ("det", (65, 64)), ("rec", (32, 100))):
        plain = resnet_variant("resnet18", variant, 16).eval()
        flagged = resnet_variant("resnet18", variant, 16, **opt).eval()
        assert list(flagged.state_dict()) == list(plain.state_dict())
        flagged.load_state_dict(plain.state_dict())
        x = torch.randn(1, 3, *hw)
        with torch.no_grad():
            for a, b in zip(plain(x), flagged(x)):
                assert torch.equal(a, b)
