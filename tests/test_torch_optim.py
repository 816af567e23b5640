"""Port parity: repro_torch.optim against repro.optim on identical
gradients.

Tolerance: fp32 elementwise math in both packages, so agreement to a few
ulps (rtol 1e-5). Adam's first steps are ~lr * sign(g), so an element within
fp32 noise of zero could differ by 2 * lr; the gradients here are
standard-normal draws, none that close to zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def _assert_trees_close(jt, tt, **tol):
    jl, tl = jax.tree.leaves(jt), tm.tree_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adagrad",
                                  "rmsprop"])
def test_three_steps_match_jax(name):
    params = _tree(0)
    jo, to = jopt.paper_default(name), topt.paper_default(name)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        g = _tree(10 + k)
        jd, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        td, ts = to.update(params_from_jax(g, "cpu"), ts, tp)
        _assert_trees_close(jd, td, **TOL)
        jp, tp = jax.tree.map(jnp.add, jp, jd), tm.tree_add(tp, td)
    assert ts["step"] == int(js["step"]) == 3
    for key in ("m", "v"):
        if key in js:
            _assert_trees_close(js[key], ts[key], **TOL)


def test_adam_kernel_path_matches_tree_adam():
    """adam(kernel=True) packs, runs dispatch.fused_adam (the plain version
    for CPU tensors) and unpacks: same deltas and moments as the per-leaf
    Adam, weight decay included."""
    params = params_from_jax(_tree(1), "cpu")
    fused = topt.adam(1e-2, weight_decay=0.1, kernel=True)
    plain = topt.adam(1e-2, weight_decay=0.1)
    sf, sp = fused.init(params), plain.init(params)
    dispatch.reset_report()
    for k in range(3):
        g = params_from_jax(_tree(20 + k), "cpu")
        df, sf = fused.update(g, sf, params)
        dp, sp = plain.update(g, sp, params)
        for a, b in zip(tm.tree_leaves(df), tm.tree_leaves(dp)):
            torch.testing.assert_close(a, b, **TOL)
    for key in ("m", "v"):
        for a, b in zip(tm.tree_leaves(sf[key]), tm.tree_leaves(sp[key])):
            torch.testing.assert_close(a, b, **TOL)
    assert dispatch.report()["fused_adam"] == "ref (cpu tensor)"


def test_spec_and_registry():
    spec = topt.paper_default("adam").spec
    assert spec == jopt.paper_default("adam").spec
    assert topt.paper_default("sgd").spec is None
    assert topt.paper_default("sgd", lr=0.5).init({})["step"] == 0
    with pytest.raises(KeyError):
        topt.get_optimizer("lamb")


def test_update_fns_report_loss_and_grads():
    def loss(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean(dim=-1)

    params = {"w": torch.ones(4)}
    x = torch.arange(8.0).reshape(2, 4)
    y = torch.zeros(2)
    fn = topt.make_sgd_update_fn(loss, topt.sgd(0.1))
    delta, st, metrics = fn(params, {"step": 0}, (x, y))
    want = -0.1 * (2 * (x @ params["w"] - y)[:, None] * x).mean(0)
    torch.testing.assert_close(delta["w"], want)
    assert st == {"step": 1}
    torch.testing.assert_close(metrics["loss"], loss(params, (x, y)))

    seen = []
    sfn = topt.make_stochastic_update_fn(
        lambda p, b, gen: seen.append(gen) or loss(p, b), topt.sgd(0.1))
    gen = torch.Generator().manual_seed(0)
    sfn(params, {"step": 0}, (x, y), gen)
    assert seen == [gen]


@pytest.mark.parametrize("step", [1, 4, 100])
def test_schedules_match_jax(step):
    pairs = [(tsched.constant(0.1), jsched.constant(0.1)),
             (tsched.inv_sqrt(0.5, warmup=10), jsched.inv_sqrt(0.5, warmup=10)),
             (tsched.theorem1(0.3, 4, 2.0), jsched.theorem1(0.3, 4, 2.0)),
             (tsched.cosine(1.0, 50), jsched.cosine(1.0, 50))]
    for tfn, jfn in pairs:
        np.testing.assert_allclose(tfn(step), float(jfn(jnp.int32(step))),
                                   rtol=1e-6)
    assert topt.lr_at(tsched.constant(0.25), step) == 0.25


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
    ("adam", {}), ("adagrad", {}), ("rmsprop", {}), ("rmsprop", {"mom": 0.9})])
def test_bf16_params_take_jax_dtypes(name, kw):
    """bf16 params and gradients, three steps: every delta, param and state
    leaf takes JAX's dtype. JAX's learning rate is an fp32 array, so a
    product with it promotes bf16 to fp32 (momentum, adagrad and rmsprop
    return an fp32 delta and the params turn fp32); sgd and adam cast the
    delta back. Values within two bf16 ulps of each leaf's largest
    element (the packages round bf16 intermediates in different places,
    and a difference of two bf16 values keeps their absolute error)."""
    params = jax.tree.map(lambda x: np.asarray(x, jnp.bfloat16), _tree(0))
    jo = jopt.get_optimizer(name, **kw)
    to = topt.get_optimizer(name, **kw)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        g = jax.tree.map(lambda x: np.asarray(x, jnp.bfloat16), _tree(10 + k))
        jd, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        td, ts = to.update(params_from_jax(g, "cpu"), ts, tp)
        jp, tp = jax.tree.map(jnp.add, jp, jd), tm.tree_add(tp, td)
        for jt, tt in ((jd, td), (jp, tp)) + tuple(
                (js[key], ts[key]) for key in ("m", "v") if key in js):
            for a, b in zip(jax.tree.leaves(jt), tm.tree_leaves(tt)):
                assert str(b.dtype) == f"torch.{a.dtype.name}"
                want = np.asarray(a, np.float32)
                np.testing.assert_allclose(
                    b.float().numpy(), want, rtol=0,
                    atol=2 * 2.0**-8 * float(np.abs(want).max()))
