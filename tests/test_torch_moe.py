"""Port parity: the mixture-of-experts FFN (``repro_torch.models.moe``) and
the MoE transformers against ``repro``.

Inputs come from numpy; params from the JAX package's init, carried across
with ``convert.params_from_jax``. Routing is compared exactly (expert ids,
arrival ranks, kept slots) on inputs with ties: ``jax.lax.top_k`` keeps the
lower index among equal values and ``jnp.argsort`` is stable, and the port
must do the same. Floating results hold max |port - jax| <= 1e-5 x max
|jax| (the same fp32 products summed in other orders). Training through
the four engine modes is in ``test_torch_moe_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch import configs as tcfg
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from test_torch_lm_train import lm_batches, make_models

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

REL = 1e-5


def _close(got, want, rel=REL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _settings(**kw):
    base = dict(num_experts=4, num_experts_real=3, top_k=2, d_ff=24,
                shared_d_ff=16, capacity_factor=2.0)
    base.update(kw)
    return (jtr.MoESettings(**base), ttr.MoESettings(**base))


def test_router_topk_matches_jax_with_ties():
    """Rows of equal logits and rows whose top two tie: the same experts in
    the same order, the same weights and the same load-balance loss; the
    dead (padded) expert is never picked."""
    jm, tm_ = _settings()
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 4)).astype(np.float32)
    logits[:8] = 0.5                          # every expert ties
    logits[8:16, 1] = logits[8:16, 2]         # the top two may tie
    logits[16:24, 3] = 50.0                   # a dead expert's big logit
    jw, ji, jaux = jax.jit(jmoe.router_topk, static_argnums=1)(
        jnp.asarray(logits), jm)
    tw, ti, taux = tmoe.router_topk(torch.from_numpy(logits), tm_)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert (ti < 3).all()
    _close(tw, jw)
    _close(taux, jaux)


def test_positions_within_expert_match_jax_and_are_stable():
    """Arrival ranks over many ties equal JAX's, and within an expert they
    follow entry order (a stable sort)."""
    e_flat = np.random.default_rng(1).integers(0, 5, 300).astype(np.int32)
    want = np.asarray(jmoe._positions_within_expert(jnp.asarray(e_flat), 5))
    got = tmoe._positions_within_expert(torch.from_numpy(e_flat).long(), 5)
    assert np.array_equal(got.numpy(), want)
    for e in range(5):
        assert np.array_equal(got.numpy()[e_flat == e],
                              np.arange((e_flat == e).sum()))


@pytest.mark.parametrize("cf,expect_overflow", [(0.25, True), (2.0, False)])
def test_moe_ffn_matches_jax(cf, expect_overflow):
    """y and the aux loss of one MoE FFN over 48 tokens; at cf = 0.25 the
    capacity is the floor of 8 slots and most entries overflow into the
    dropped row (many writes to one slot)."""
    jm, tm_ = _settings(capacity_factor=cf)
    d = 32
    jp = jax.tree.map(lambda p: p.value, jmoe.init_moe(
        jax.random.PRNGKey(3), d, jm, jnp.float32),
        is_leaf=lambda x: hasattr(x, "axes"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 24, d)).astype(
        np.float32)
    cap = tmoe.capacity(48, tm_)
    assert cap == min(48 * 2, max(int(cf * 48 * 2 / 4), 8))
    entries = tmoe.router_topk(torch.from_numpy(x.reshape(48, d))
                               @ tp["router"], tm_)[1]
    overflow = torch.bincount(entries.reshape(-1), minlength=4).max() > cap
    assert bool(overflow) == expect_overflow
    jy, jaux = jax.jit(jmoe.moe_ffn, static_argnums=(2, 3))(
        jp, jnp.asarray(x), jm, jnp.float32)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tm_, torch.float32)
    _close(ty, jy)
    _close(taux, jaux)


def test_moe_init_structure_and_counts_match():
    japi, tapi, jp, _ = make_models("qwen2-moe-a2.7b")
    tparams, _ = tapi.init(1, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [tuple(x.shape) for x in tm.tree_leaves(tparams)] == \
        [tuple(x.shape) for _, x in jleaves]
    assert "shared" in tparams["layers"]["moe"]
    for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b"):
        for reduced in (True, False):
            assert (tcfg.count_params(tcfg.get(arch).api(reduced=reduced))
                    == jcfg.count_params(jcfg.get(arch).api(reduced=reduced)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
def test_moe_loss_and_grad_match_jax(arch):
    """The aux loss is summed over layers as JAX's loss_fn sums it; kimi's
    reduced config has no dead expert and a GQA of 8 over 1."""
    japi, tapi, jp, npp = make_models(arch)
    tokens = lm_batches(japi.vocab_real, steps=1)[0]
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, {"tokens": tokens})))(jp)
    _, jaux = jax.jit(lambda p: jtr.forward(p, tokens[:, :-1], japi.cfg))(jp)
    leaves, treedef = tm.tree_flatten(params_from_jax(npp, device="cpu"))
    leaves = [x.requires_grad_(True) for x in leaves]
    params = tm.tree_unflatten(treedef, leaves)
    _, taux = ttr.forward(params, torch.from_numpy(tokens[:, :-1]), tapi.cfg)
    assert float(taux.detach()) > 0
    _close(taux, jaux)
    tloss = tapi.loss(params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(tloss, leaves)
    _close(tloss, jloss)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        _close(g, jg)


def test_moe_remat_changes_no_number():
    _, tapi, _, npp = make_models("qwen2-moe-a2.7b")
    tokens = torch.from_numpy(lm_batches(500, steps=1)[0])
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tapi.cfg, remat=remat)
        leaves, treedef = tm.tree_flatten(params_from_jax(npp, device="cpu"))
        leaves = [x.requires_grad_(True) for x in leaves]
        loss = ttr.loss_fn(tm.tree_unflatten(treedef, leaves),
                           {"tokens": tokens}, cfg)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
