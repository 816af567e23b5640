"""Port parity: repro_torch.treemath against repro.treemath.

The packed layout (leaf order, padding) must agree element for element, or
the port's packed rings and moments would not compare with the JAX
package's. Exact equality: packing only copies fp32 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import treemath as jtm
from repro.kernels import dispatch as jdispatch
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import dispatch

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)


def _numpy_tree(seed: int):
    """Dict keys deliberately out of sorted order at every level."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 30, size=5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "w": f(int(n[0]), int(n[1])),
        "b": f(int(n[2])),
        "nested": {"z": f(int(n[3])), "a": [f(2, int(n[4])), f(3)]},
    }


def test_pack_align_matches_jax():
    assert dispatch.PACK_ALIGN == jdispatch.PACK_ALIGN


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leaf_order_sorts_dict_keys_like_jax(seed):
    tree = _numpy_tree(seed)
    jl = jax.tree.leaves(jax.tree.map(jnp.asarray, tree))
    tl = tm.tree_leaves(params_from_jax(tree, device="cpu"))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pad_to", [0, 2048])
def test_tree_pack_equals_jax(seed, pad_to):
    tree = _numpy_tree(seed)
    want = np.asarray(jtm.tree_pack(jax.tree.map(jnp.asarray, tree),
                                    pad_to=pad_to))
    got = tm.tree_pack(params_from_jax(tree, device="cpu"), pad_to=pad_to)
    np.testing.assert_array_equal(got.numpy(), want)
    spec = tm.pack_spec(params_from_jax(tree, device="cpu"))
    jspec = jtm.pack_spec(jax.tree.map(jnp.asarray, tree))
    assert spec.shapes == jspec.shapes and spec.sizes == jspec.sizes
    assert spec.offsets == jspec.offsets and spec.total == jspec.total
    assert tm.padded_size(spec.total, pad_to) == jtm.padded_size(
        jspec.total, pad_to)


def test_tree_pack_leading_axis_equals_jax():
    tree = _numpy_tree(3)
    stacked = jax.tree.map(lambda x: np.stack([x, 2 * x, -x]), tree)
    want = np.asarray(jtm.tree_pack(jax.tree.map(jnp.asarray, stacked),
                                    lead_ndim=1, pad_to=2048))
    got = tm.tree_pack(params_from_jax(stacked, device="cpu"), lead_ndim=1,
                       pad_to=2048)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 4])
def test_pack_unpack_roundtrip(seed):
    """pack -> unpack restores every leaf exactly, the pad tail is zero, and
    widening bf16 to fp32 round-trips losslessly."""
    tree = params_from_jax(_numpy_tree(seed), device="cpu")
    tree["nested"]["z"] = tree["nested"]["z"].to(torch.bfloat16)
    spec = tm.pack_spec(tree)
    vec = tm.tree_pack(tree, pad_to=2048)
    assert vec.shape[-1] % 2048 == 0
    assert torch.all(vec[spec.total:] == 0)
    back = tm.tree_unpack(vec, spec)
    assert tm.tree_structure(back) == tm.tree_structure(tree)
    for a, b in zip(tm.tree_leaves(tree), tm.tree_leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_tree_arithmetic_matches_jax():
    a_np, b_np = _numpy_tree(5), _numpy_tree(5)
    b_np = jax.tree.map(lambda x: 0.5 * x + 1.0, b_np)
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a_np, b_np))
    ta, tb = (params_from_jax(t, device="cpu") for t in (a_np, b_np))
    for jfn, tfn in ((jtm.tree_add, tm.tree_add), (jtm.tree_sub, tm.tree_sub)):
        for x, y in zip(jax.tree.leaves(jfn(ja, jb)),
                        tm.tree_leaves(tfn(ta, tb))):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for jout, tout in ((jtm.tree_scale(ja, 0.5), tm.tree_scale(ta, 0.5)),
                       (jtm.tree_axpy(2.0, ja, jb), tm.tree_axpy(2.0, ta, tb)),
                       (jtm.tree_stack([ja, jb]), tm.tree_stack([ta, tb])),
                       (jtm.tree_flatten_to_vector(ja),
                        tm.tree_flatten_to_vector(ta))):
        for x, y in zip(jax.tree.leaves(jout), tm.tree_leaves(tout)):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6)
    np.testing.assert_allclose(float(tm.tree_dot(ta, tb)),
                               float(jtm.tree_dot(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(tm.tree_norm(ta)),
                               float(jtm.tree_norm(ja)), rtol=1e-5)
    assert tm.tree_allfinite(ta)
    assert not tm.tree_allfinite(tm.tree_scale(ta, float("inf")))
    assert all(x.dtype == torch.bfloat16
               for x in tm.tree_leaves(tm.tree_cast(ta, torch.bfloat16)))
    assert tm.tree_size(ta) == jtm.tree_size(ja)
    stacked = tm.tree_broadcast_leading({"x": ta["b"], "step": 3}, 4)
    assert stacked["x"].shape == (4,) + tuple(ta["b"].shape)
    assert stacked["step"] == 3          # Python scalars stay shared
    stacked["x"][0].add_(1.0)            # a real copy: rows can diverge
    assert not torch.equal(stacked["x"][0], stacked["x"][1])


def test_tree_map_rejects_mismatched_structures():
    with pytest.raises(ValueError):
        tm.tree_map(torch.add, {"a": torch.zeros(1)},
                    {"b": torch.zeros(1)})


def test_flatten_keeps_no_leaf_alive_after_the_caller_drops_it():
    """tree_flatten / tree_map leave no reference cycle behind: with the
    cyclic collector off, a leaf dies as soon as the caller drops it (a
    cycle would keep every leaf of a full-width tree allocated)."""
    import gc
    import weakref
    gc.disable()
    try:
        tree = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.ones(1),)]}
        refs = [weakref.ref(x) for x in tm.tree_leaves(tree)]
        mapped = tm.tree_map(lambda x: x + 1, tree)
        mapped_refs = [weakref.ref(x) for x in tm.tree_leaves(mapped)]
        del tree, mapped
        assert all(r() is None for r in refs + mapped_refs)
    finally:
        gc.enable()
