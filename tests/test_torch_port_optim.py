"""Port optimizer and schedules against optax, as the JAX package builds them
(``megreader_tpu/train/train_step.py::OptimizerConfig``).

Schedules: every name at every step 0..total+5, atol 1e-7. Updates: five
steps of ``sgd``, ``adam`` and ``adamw``, with and without ``grad_clip``, on
identical numpy parameters and gradients, atol 1e-6 (float32 updates in
another order; optax also takes Adam's bias corrections in float32, where
1 - 0.999 is off by 1.3e-5 relative, so each Adam update differs by about
6e-6 of its size: lr 0.01 keeps five of them inside the tolerance). Adam is
held here rather than through a model: its normalisation of near-zero
gradients amplifies the model's round-off."""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from megreader_tpu.train import OptimizerConfig as JaxOptimizerConfig
from megreader_tpu_torch.train.train_step import OptimizerConfig, global_norm

SCHEDULES = {
    "constant": dict(schedule="constant", lr=0.01),
    "poly": dict(schedule="poly", lr=0.007, total_steps=30, power=0.9),
    "cosine": dict(schedule="cosine", lr=0.001, total_steps=30),
    "warmup_cosine": dict(schedule="warmup_cosine", lr=0.001, warmup_steps=8, total_steps=30),
    "poly_with_warmup": dict(schedule="poly", lr=0.007, warmup_steps=5, total_steps=30),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name):
    ref = JaxOptimizerConfig(**SCHEDULES[name]).make_schedule()
    got = OptimizerConfig(**SCHEDULES[name]).make_schedule()
    steps = range(0, 36)
    np.testing.assert_allclose([got(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=0, atol=1e-7)


def test_warmup_cosine_restarts_the_cosine_at_the_boundary():
    sched = OptimizerConfig(**SCHEDULES["warmup_cosine"]).make_schedule()
    assert sched(0) == 0.0
    assert sched(7) == pytest.approx(0.001 * 7 / 8)
    assert sched(8) == pytest.approx(0.001)  # cosine(0): the second schedule starts at 0
    assert sched(9) < sched(8)


def _params_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(4, 3), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # gradient norms from about 0.3 to 2: a clip at 1 triggers on some steps only
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.05, 0.4, 0.1, 0.3, 0.08)]
    return params, grads


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_updates_match_optax(name, clip):
    cfg = dict(name=name, lr=0.01, momentum=0.9, weight_decay=1e-2, schedule="warmup_cosine",
               warmup_steps=2, total_steps=6, grad_clip=clip)
    params, grads = _params_and_grads()

    tx = JaxOptimizerConfig(**cfg).make()
    ref = [jnp.asarray(p) for p in params]
    state = tx.init(ref)

    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = OptimizerConfig(**cfg).make(torch.nn.ParameterList(tparams))
    clipped = 0
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, ref)
        ref = optax.apply_updates(ref, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        clipped += bool(clip and float(norm) >= clip)
        for p, r in zip(tparams, ref):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0, atol=1e-6)
    assert opt.count == 5
    if clip:
        assert 0 < clipped < 5


def test_global_norm():
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    assert float(global_norm(g)) == 5.0


def test_accumulate_steps_and_unknown_names_raise():
    """``accumulate_steps`` builds (``optax.MultiSteps``; held to optax in
    ``test_torch_port_augment.py``); unknown names raise."""
    p = torch.nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    assert OptimizerConfig(accumulate_steps=2).make(p).accumulate_steps == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        OptimizerConfig(name="lamb").make(p)
    with pytest.raises(ValueError, match="unknown schedule"):
        OptimizerConfig(schedule="step").make_schedule()


def test_optimizer_state_round_trips():
    params, grads = _params_and_grads(1)
    cfg = OptimizerConfig(name="adamw", lr=0.01, schedule="cosine", total_steps=10)
    a = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt_a = cfg.make(torch.nn.ParameterList(a))
    for g in grads[:2]:
        for p, x in zip(a, g):
            p.grad = torch.from_numpy(x.copy())
        opt_a.step()
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    opt_b = cfg.make(torch.nn.ParameterList(b))
    opt_b.load_state_dict(copy.deepcopy(opt_a.state_dict()))  # as a checkpoint holds it
    assert opt_b.count == 2
    for opt, ps in ((opt_a, a), (opt_b, b)):
        for p, x in zip(ps, grads[2]):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for p, q in zip(a, b):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
