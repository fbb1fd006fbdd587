"""The port's training options against the JAX package on the CPU: device
augmentation (``ops/image.py``: the jittered resize, the augmented resize,
``warp_bilinear``, the affine maps and ``augment_images``) fed JAX's own
draws, within 1e-3 on 0-255 values on smooth images; ``Experiment(augment=
True)``'s stream, a pure function of (seed, step); gradient accumulation
against ``optax.MultiSteps`` in float64, a resume in mid-cycle included; and
accumulation through the trainer (parameters still between updates, the
BatchNorm statistics moving every mini-step)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megreader_tpu.ops import image as jax_image
from megreader_tpu.train import OptimizerConfig as JaxOptimizerConfig
from megreader_tpu_torch.data.datasets import SyntheticRecognitionDataset
from megreader_tpu_torch.experiment import Experiment, augment_generator
from megreader_tpu_torch.models.recognizer import CTCRecognizer
from megreader_tpu_torch.ops import image
from megreader_tpu_torch.train.train_step import (
    OptimizerConfig,
    create_train_state,
    make_train_step,
)

ATOL_PX = 1e-3


def _smooth(rng, B, H, W, C=3):
    """Smooth 0-255 images (low-frequency waves): the two packages' sample
    coordinates may differ by an ulp, which moves a value on a smooth image
    by far less than 1e-3."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    out = np.zeros((B, H, W, C))
    for _ in range(4):
        f = rng.uniform(0.02, 0.1, (B, 1, 1, C, 2))
        ph = rng.uniform(0, 2 * np.pi, (B, 1, 1, C))
        out += np.sin(xx[None, ..., None] * f[..., 0] + yy[None, ..., None] * f[..., 1] + ph)
    return (127.5 + 127.5 * out / 4).astype(np.float32)


def _canvases(seed=0, B=6, canvas=(64, 256)):
    """Word-crop canvases: a smooth crop of random size in each top-left
    corner, zeros elsewhere (some crops wider than the 32x100 output)."""
    rng = np.random.default_rng(seed)
    H, W = canvas
    img = np.zeros((B, H, W, 3), np.float32)
    sizes = np.stack([rng.integers(12, H + 1, B), rng.integers(20, W + 1, B)], 1).astype(np.int32)
    smooth = _smooth(rng, B, H, W)
    for b, (h, w) in enumerate(sizes):
        img[b, :h, :w] = smooth[b, :h, :w]
    return img, sizes


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_jitter_resize_matches_jax(seed):
    img, sizes = _canvases(seed)
    rng = np.random.default_rng(seed + 10)
    jscale = (1.0 + rng.uniform(-0.12, 0.12, (len(sizes), 2))).astype(np.float32)
    jshift = rng.uniform(-1.5, 1.5, (len(sizes), 2)).astype(np.float32)
    ref, ref_w = jax_image.resize_with_aspect_pad(
        jnp.asarray(img), jnp.asarray(sizes), (32, 100),
        jitter=(jnp.asarray(jscale), jnp.asarray(jshift)))
    ti, ts, tsc, tsh = _t(img, sizes, jscale, jshift)
    got, got_w = image.resize_with_aspect_pad(ti, ts, (32, 100), jitter=(tsc, tsh))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)
    plain, _ = image.resize_with_aspect_pad(ti, ts, (32, 100))
    assert float((plain - got).abs().max()) > 1.0  # the jitter moves the samples


def _jax_resize_draws(key, B, m=0.12, s=1.5, b=0.15, c=0.15):
    """``augment_resize_with_aspect_pad``'s draws, drawn as it draws them."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = jax.random.uniform
    return {"jscale": 1.0 + u(k1, (B, 2), minval=-m, maxval=m),
            "jshift": u(k2, (B, 2), minval=-s, maxval=s),
            "brightness": u(k3, (B, 1, 1, 1), minval=-b, maxval=b) * 255.0,
            "contrast": 1.0 + u(k4, (B, 1, 1, 1), minval=-c, maxval=c)}


def _jax_affine_draws(key, B, max_rotate=10.0, max_scale=0.2, max_shift=0.05):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = jax.random.uniform
    return {"angle": u(k1, (B,), minval=-max_rotate, maxval=max_rotate),
            "scale": u(k2, (B,), minval=-max_scale, maxval=max_scale),
            "tx": u(k3, (B,), minval=-max_shift, maxval=max_shift),
            "ty": u(k4, (B,), minval=-max_shift, maxval=max_shift)}


def _torch_draws(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed", [0, 3])
def test_augment_resize_matches_jax_on_its_draws(seed):
    img, sizes = _canvases(seed)
    key = jax.random.PRNGKey(seed)
    ref, ref_w = jax_image.augment_resize_with_aspect_pad(key, jnp.asarray(img),
                                                         jnp.asarray(sizes), (32, 100))
    ti, ts = _t(img, sizes)
    got, got_w = image.augment_resize_apply(ti, ts, (32, 100),
                                            _torch_draws(_jax_resize_draws(key, len(sizes))))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)


def _matrices(rng, B, H, W, perspective):
    """Inverse maps about the image centre: rotation, scale, shift, and a
    small perspective row."""
    th = rng.uniform(-0.3, 0.3, B)
    sc = rng.uniform(0.8, 1.25, B)
    M = np.zeros((B, 3, 3))
    M[:, 0, 0], M[:, 0, 1] = np.cos(th) * sc, np.sin(th) * sc
    M[:, 1, 0], M[:, 1, 1] = -np.sin(th) * sc, np.cos(th) * sc
    M[:, 0, 2] = W / 2 - M[:, 0, 0] * W / 2 - M[:, 0, 1] * H / 2 + rng.uniform(-5, 5, B)
    M[:, 1, 2] = H / 2 - M[:, 1, 0] * W / 2 - M[:, 1, 1] * H / 2 + rng.uniform(-5, 5, B)
    M[:, 2, 2] = 1.0
    if perspective:
        M[:, 2, 0] = rng.uniform(-2e-3, 2e-3, B)
        M[:, 2, 1] = rng.uniform(-2e-3, 2e-3, B)
    return M.astype(np.float32)


@pytest.mark.parametrize("border", ["zero", "clamp"])
@pytest.mark.parametrize("perspective", [False, True])
def test_warp_bilinear_matches_jax(border, perspective):
    rng = np.random.default_rng(7 + perspective)
    img = _smooth(rng, 3, 40, 64)
    M = _matrices(rng, 3, 40, 64, perspective)
    ref = jax_image.warp_bilinear(jnp.asarray(img), jnp.asarray(M), (36, 70), border=border)
    got = image.warp_bilinear(*_t(img, M), (36, 70), border=border)
    assert got.shape == (3, 36, 70, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)
    if border == "zero":
        assert float(got.abs().min()) == 0.0  # the warp reaches past the edges


def test_bilinear_gather_refuses_unknown_borders():
    with pytest.raises(ValueError, match="unknown border"):
        image.warp_bilinear(torch.zeros(1, 4, 4, 1), torch.eye(3)[None], (4, 4), border="wrap")


def test_affine_matrix_matches_jax_on_its_draws():
    key = jax.random.PRNGKey(5)
    ref = jax_image.augment_affine_matrix(key, 8, center_hw=(20.0, 32.0))
    got = image.affine_matrix(_torch_draws(_jax_affine_draws(key, 8)), center_hw=(20.0, 32.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_hw", [None, (30, 50)])
def test_augment_images_matches_jax_on_its_draws(out_hw):
    rng = np.random.default_rng(11)
    img = _smooth(rng, 4, 40, 64)
    key = jax.random.PRNGKey(2)
    ref = jax_image.augment_images(key, jnp.asarray(img), out_hw=out_hw)
    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.uniform
    draws = {**_jax_affine_draws(k1, 4, max_rotate=8.0),
             "brightness": u(k2, (4, 1, 1, 1), minval=-0.2, maxval=0.2),
             "contrast": 1.0 + u(k3, (4, 1, 1, 1), minval=-0.2, maxval=0.2)}
    got = image.augment_images_apply(torch.from_numpy(img), _torch_draws(draws), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL_PX)


def test_random_augmentations_draw_from_their_generator():
    """The same generator state gives the same output; another seed another."""
    img, sizes = _canvases(4)
    ti, ts = _t(img, sizes)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        out, _ = image.augment_resize_with_aspect_pad(g, ti, ts, (32, 100))
        return out, image.augment_images(g, ti[:, :32, :100]), image.augment_affine_matrix(g, 3)

    a, b, c = run(0), run(0), run(1)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and not torch.equal(x, z)


def _tiny_model(seed=0):
    torch.manual_seed(seed)
    return CTCRecognizer(num_classes=37, hidden=32, num_encoder_layers=1, device="cpu")


def test_experiment_augment_stream_is_pure_in_seed_and_step():
    """``Experiment(augment=True)``'s prepare: for two seeds and two steps
    four different batches, each the same when asked again; the train step
    passes the state's step to it; without ``augment`` the plain resize."""
    data = SyntheticRecognitionDataset(n=8)
    exps = {s: Experiment(_tiny_model(), data, batch_size=8, augment=True, seed=s)
            for s in (0, 1)}
    raw = next(iter(exps[0].train_loader))
    out = {(s, k): exps[s].prepare(raw, step=k)["image"] for s in (0, 1) for k in (0, 5)}
    for (s, k), x in out.items():
        assert torch.equal(x, exps[s].prepare(raw, step=k)["image"])
    keys = list(out)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(out[a], out[b]), (a, b)
    g1, g2 = augment_generator(3, 7, "cpu"), augment_generator(3, 7, "cpu")
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    plain = Experiment(_tiny_model(), data, batch_size=8)
    assert not torch.equal(plain.prepare(raw)["image"], out[0, 0])

    seen = []
    model = _tiny_model()
    state = create_train_state(model, OptimizerConfig())

    def prepare(batch, step=0):
        seen.append(step)
        return exps[0].prepare(batch, step=step)

    step = make_train_step(model, prepare)
    for _ in range(2):
        state, _ = step(state, raw)
    assert seen == [0, 1]


def _float64_params_and_grads(seed, n_steps):
    rng = np.random.default_rng(seed)
    shapes = [(4, 3), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s) for s in shapes]
    # gradient norms from about 0.3 to 2: a clip at 1 triggers on some steps
    grads = [[rng.standard_normal(s) * rng.choice([0.05, 0.1, 0.3, 0.4]) for s in shapes]
             for _ in range(n_steps)]
    return params, grads


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_accumulation_matches_multisteps(name, k, clip):
    """``accumulate_steps`` k against ``optax.MultiSteps(tx, k)`` in float64
    (AdamW or SGD, warm-up, with and without clip), over 3k mini-steps; a
    copy resumed from the state dict after the first mini-step of the second
    cycle goes on equal. Parameters move at every k-th mini-step only, the
    count advances once per update, and ``grad_norm`` is the mini-batch's.
    atol 1e-8: optax's schedule rounds its rates to float32 (1e-10 here)."""
    cfg = dict(name=name, lr=0.05, momentum=0.9, weight_decay=1e-2, schedule="warmup_cosine",
               warmup_steps=2, total_steps=6, grad_clip=clip, accumulate_steps=k)
    params, grads = _float64_params_and_grads(k, 3 * k)
    with jax.enable_x64(True):
        tx = JaxOptimizerConfig(**cfg).make()
        ref = [jnp.asarray(p) for p in params]
        state = tx.init(ref)
        refs = []
        update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
            *tx.update(g, st, p)))
        for g in grads:
            ref, state = update([jnp.asarray(x) for x in g], state, ref)
            refs.append([np.asarray(r) for r in ref])

    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = OptimizerConfig(**cfg).make(torch.nn.ParameterList(tparams))
    resumed = None
    for i, g in enumerate(grads):
        before = [p.detach().clone() for p in tparams]
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        norm = opt.step()
        assert float(norm) == pytest.approx(float(np.sqrt(sum((x * x).sum() for x in g))),
                                            rel=1e-12)
        moved = any(not torch.equal(p, q) for p, q in zip(tparams, before))
        assert opt.count == (i + 1) // k
        if (i + 1) % k:
            assert not moved, i
        elif opt.count > 1:  # the first update's warm-up rate is 0
            assert moved, i
        for p, r in zip(tparams, refs[i]):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=0, atol=1e-8)
        if i == k:  # one mini-step into the second cycle: save and resume
            rparams = [torch.nn.Parameter(p.detach().clone()) for p in tparams]
            resumed = (rparams, OptimizerConfig(**cfg).make(torch.nn.ParameterList(rparams)))
            resumed[1].load_state_dict(copy.deepcopy(opt.state_dict()))
        elif resumed is not None:
            rparams, ropt = resumed
            for p, x in zip(rparams, g):
                p.grad = torch.from_numpy(x.copy())
            ropt.step()
            for p, q in zip(rparams, tparams):
                torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert opt.count == 3 and resumed[1].count == 3


def test_accumulation_through_the_trainer_step():
    """Two mini-steps an update through ``make_train_step``: the weights equal
    across mini-steps 1 and 3 (they change at 2 and 4), the BatchNorm
    statistics change at every mini-step, and the state's step counts
    mini-steps."""
    model = _tiny_model()
    exp = Experiment(model, SyntheticRecognitionDataset(n=8), batch_size=8,
                     optimizer=OptimizerConfig(name="adam", lr=1e-3, accumulate_steps=2))
    raw = next(iter(exp.train_loader))
    state = create_train_state(model, exp.optimizer)
    step = make_train_step(model, exp.prepare)
    params = lambda: [p.detach().clone() for p in model.net.parameters()]  # noqa: E731
    stats = lambda: [b.detach().clone() for n, b in model.net.named_buffers()  # noqa: E731
                     if n.endswith("running_mean")]
    seen_p, seen_s = [params()], [stats()]
    for _ in range(4):
        state, metrics = step(state, raw)
        assert np.isfinite(float(metrics["grad_norm"]))
        seen_p.append(params())
        seen_s.append(stats())
    assert state.step == 4 and state.optimizer.count == 2

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    assert [same(seen_p[i], seen_p[i + 1]) for i in range(4)] == [True, False, True, False]
    assert not any(same(seen_s[i], seen_s[i + 1]) for i in range(4))
