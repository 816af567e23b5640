"""Port parity: repro_torch.models.resnet and the ResNet experiment twin
against the JAX package.

Both packages run the same narrow ResNet (widths 4/8/8, 8 x 8 images,
n = 1 and 2, P = 2 workers) from the same weights (``params_from_jax``),
on the same batches and ``Schedule`` delays. Forward values and losses
agree to fp32 roundoff (rtol 1e-5). Gradients are held leaf by leaf in
relative L2 norm, to 2e-5: each GroupNorm backward cancels large terms, and
XLA's and PyTorch's convolution and GroupNorm kernels round differently,
so elements near zero differ, relative to themselves, by orders of
magnitude more than whole leaves do: leaves agree to 1.5e-5 (n = 1) and
1.3e-5 (n = 2, 14 layers) in relative L2 on the CPU. Engine loss curves
agree to rtol 1e-5 (SGD) and 1e-4 (Adam, whose per-element normalisation
magnifies roundoff in small gradient elements, as test_torch_engine.py
holds the DNN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro.engine import EngineConfig as JConfig
from repro.engine import Hook as JHook
from repro.engine import Trainer as JTrainer
from repro.engine import build_engine as jbuild
from repro.models import resnet as jres
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch import experiments
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.engine import EngineConfig, Hook, Trainer, build_engine
from repro_torch.models import resnet as tres
from repro_torch.optim import optimizers as topt
from repro_torch.optim.optimizers import value_and_grad

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

P, WIDTHS, HW, BATCH = 2, (4, 8, 8), 8, 4
GRAD_REL = 2e-5


def assert_leaf_close(got, want, rel=GRAD_REL):
    """``||got - want|| <= rel * ||want||`` (float64 norms)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want), (
        np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def data():
    return synthetic.synthetic_images(seed=0, hw=HW, n_train=256, n_test=64)


@pytest.fixture(scope="module", params=[1, 2], ids=["n1", "n2"])
def net(request):
    """(n, JAX params, strides) at the narrow widths."""
    cfg = jres.ResNetConfig(n=request.param, widths=WIDTHS)
    jp, strides = jres.init(jax.random.PRNGKey(0), cfg)
    return request.param, jp, strides


def _tp(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(data, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(data.x_train), (P, BATCH))
    return data.x_train[idx], data.y_train[idx]


def test_apply_loss_and_grads_match_jax(data, net):
    n, jp, strides = net
    cfg = jres.ResNetConfig(n=n, widths=WIDTHS)
    tcfg = tres.ResNetConfig(n=n, widths=WIDTHS)
    assert tres.block_strides(tcfg) == strides
    assert 2 in strides                    # a stride-2 block at even H
    x, y = _batch(data)
    jl, jg = jax.value_and_grad(jres.make_loss_fn(cfg, strides))(
        jp, (jnp.asarray(x[0]), jnp.asarray(y[0])))
    tp = _tp(jp)
    tl, tg = value_and_grad(tres.make_loss_fn(tcfg, strides), tp,
                            (torch.from_numpy(x[0]), torch.from_numpy(y[0])))
    np.testing.assert_allclose(
        tres.apply(tp, strides, torch.from_numpy(x[0]), tcfg).numpy(),
        np.asarray(jres.apply(jp, strides, jnp.asarray(x[0]), cfg)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tm.tree_leaves(tg), jax.tree.leaves(jg)):
        assert_leaf_close(a.numpy(), b)
    acc = tres.make_accuracy_fn(tcfg, strides)(
        tp, torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    np.testing.assert_allclose(float(acc), float(jres.make_accuracy_fn(
        cfg, strides)(jp, jnp.asarray(x[0]), jnp.asarray(y[0]))))


@pytest.mark.parametrize("hw", [7, 8])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_same_padding_matches_xla(hw, k, stride):
    """XLA's SAME pads 0 before and 1 after a 3 x 3 stride-2 window on an
    even size; the port's convolution matches it at odd and even sizes."""
    rng = np.random.default_rng(hw + k + stride)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride))
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tres._conv(h, torch.from_numpy(w).unsqueeze(0), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    if (k, stride) == (3, 2) and hw % 2 == 0:
        assert tres._same_pad(hw, k, stride) == (0, 1)


def test_stacked_form_equals_per_worker_loop(data, net):
    n, jp, strides = net
    tcfg = tres.ResNetConfig(n=n, widths=WIDTHS)
    loss = tres.make_loss_fn(tcfg, strides)
    one = _tp(jp)
    # Workers hold different params: the grouped convolution must keep
    # each worker on its own weights and GroupNorm on its own channels.
    stacked = tm.tree_map(lambda a: torch.stack([a, 1.1 * a + 0.01]), one)
    x, y = (torch.from_numpy(a) for a in _batch(data, seed=1))
    got, g = value_and_grad(loss, stacked, (x, y))
    for i in range(P):
        want, gi = value_and_grad(loss, tm.tree_index(stacked, i),
                                  (x[i], y[i]))
        torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6)
        for a, b in zip(tm.tree_leaves(g), tm.tree_leaves(gi)):
            assert_leaf_close(a[i].numpy(), b.numpy())


def _table():
    """A [T, P] Schedule over UniformDelay(4)'s range r in [0, 3]."""
    return np.random.default_rng(4).integers(0, 4, (40, P))


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_step(self, ctx):
        self.losses.append(float(ctx.metrics["loss"]))


@pytest.fixture(scope="module")
def jax_curves(data):
    """The JAX engine's n = 1 loss curves (kernels off), 10 steps, by algo;
    computed once."""
    cfg = jres.ResNetConfig(n=1, widths=WIDTHS)
    jp, strides = jres.init(jax.random.PRNGKey(0), cfg)
    out = {}
    for algo in ("sgd", "adam"):
        eng = jbuild(jres.make_loss_fn(cfg, strides),
                     jopt.paper_default(algo),
                     JConfig(mode="simulate", num_workers=P,
                             delay=jdel.Schedule(_table())))
        losses = []

        class Log(JHook):
            def on_step(self, ctx):
                losses.append(float(ctx.metrics["loss"]))

        JTrainer(eng, hooks=[Log()]).run(
            iter(ShardedBatches([data.x_train, data.y_train], P, BATCH)),
            10, state=eng.init(jax.random.PRNGKey(0), params=jp))
        out[algo] = losses
    return jp, strides, out


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_engine_curves_match_jax(data, jax_curves, algo, kernels):
    jp, strides, curves = jax_curves
    tcfg = tres.ResNetConfig(n=1, widths=WIDTHS)
    eng = build_engine(tres.make_loss_fn(tcfg, strides),
                       topt.paper_default(algo),
                       EngineConfig(mode="simulate", num_workers=P,
                                    delay=tdel.Schedule(_table()),
                                    kernels=kernels), device="cpu")
    log = _Losses()
    Trainer(eng, hooks=[log]).run(
        iter(ShardedBatches([data.x_train, data.y_train], P, BATCH)), 10,
        params=_tp(jp))
    np.testing.assert_allclose(log.losses, curves[algo],
                               rtol=1e-5 if algo == "sgd" else 1e-4)
    assert eng.meta["kernels"]["delivery"] == (
        "tree" if kernels == "off" else "packed")


def test_cnn_experiment_batches_to_target_match_jax(data, jax_curves):
    """experiments.cnn_experiment reaches the target accuracy after the
    same number of worker batches as the JAX engine + Trainer."""
    jp, strides, _ = jax_curves
    cfg = jres.ResNetConfig(n=1, widths=WIDTHS)
    eng = jbuild(jres.make_loss_fn(cfg, strides), jopt.paper_default("sgd"),
                 JConfig(mode="simulate", num_workers=P,
                         delay=jdel.Schedule(_table())))
    acc = jres.make_accuracy_fn(cfg, strides)
    xt, yt = jnp.asarray(data.x_test), jnp.asarray(data.y_test)
    jr = JTrainer(eng).run(
        iter(ShardedBatches([data.x_train, data.y_train], P, BATCH)), 30,
        state=eng.init(jax.random.PRNGKey(0), params=jp),
        eval_fn=lambda p: acc(p, xt, yt), eval_every=3, target=TARGET)
    assert jr.converged
    res = experiments.cnn_experiment(
        n_blocks=1, algo="sgd", s=4, workers=P, target_acc=TARGET,
        batch=BATCH, max_steps=30, eval_every=3, widths=WIDTHS,
        delay=tdel.Schedule(_table()), params=_tp(jp), data=data,
        device="cpu")
    assert res.converged and res.batches_to_target == jr.batches_to_target
    assert [b for b, _ in res.curve] == [b for b, _ in jr.curve]


TARGET = 0.3
