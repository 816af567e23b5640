"""Port parity: repro_torch.models.mlp against repro.models.mlp from the
same weights (``params_from_jax``). fp32 matmuls in both packages with
different summation orders: rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jmlp
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.models import mlp as tmlp
from repro_torch.optim import value_and_grad

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _setup(depth, seed=0):
    cfg = jmlp.MLPConfig(in_dim=32, hidden=16, depth=depth)
    jp = jmlp.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((24, 32)).astype(np.float32)
    y = rng.integers(0, 10, 24).astype(np.int32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), x, y


@pytest.mark.parametrize("depth", [0, 2])
def test_loss_and_grads_match_jax(depth):
    jp, tp, x, y = _setup(depth)
    jl, jg = jax.value_and_grad(jmlp.loss_fn)(jp, (jnp.asarray(x),
                                                   jnp.asarray(y)))
    tl, tg = value_and_grad(tmlp.loss_fn, tp,
                            (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for a, b in zip(jax.tree.leaves(jg), tm.tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(
        float(tmlp.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jmlp.accuracy(jp, jnp.asarray(x), jnp.asarray(y))))


def test_worker_stacked_loss_gives_per_worker_grads():
    """The written-out vmap: [P] losses from stacked params, and the
    gradient of their sum is each worker's own gradient."""
    _, tp, x, y = _setup(2)
    p = 3
    stacked = tm.tree_map(
        lambda a: torch.stack([a * (1 + 0.1 * i) for i in range(p)]), tp)
    xs = torch.from_numpy(x).reshape(p, 8, 32)
    ys = torch.from_numpy(y).reshape(p, 8)
    losses, grads = value_and_grad(tmlp.loss_fn, stacked, (xs, ys))
    assert losses.shape == (p,)
    for i in range(p):
        one = tm.tree_index(stacked, i)
        li, gi = value_and_grad(tmlp.loss_fn, one, (xs[i], ys[i]))
        torch.testing.assert_close(losses[i], li, **TOL)
        for a, b in zip(tm.tree_leaves(tm.tree_index(grads, i)),
                        tm.tree_leaves(gi)):
            torch.testing.assert_close(a, b, **TOL)


def test_init_layout_matches_jax():
    cfg = tmlp.MLPConfig(in_dim=20, hidden=8, depth=3)
    tp = tmlp.init(0, cfg, device="cpu")
    jp = jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(20, 8, 3, 10))
    assert [tuple(x.shape) for x in tm.tree_leaves(tp)] == [
        tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert all(torch.all(layer["b"] == 0) for layer in tp["layers"])
    # He init: hidden weights have std ~ sqrt(2 / d_in)
    assert 0.5 < float(tp["layers"][0]["w"].std()) / (2 / 20) ** 0.5 < 1.5
    again = tmlp.init(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tm.tree_leaves(tp),
                                                 tm.tree_leaves(again)))
