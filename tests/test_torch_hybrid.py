"""Port parity: ``repro_torch.models.hybrid`` (the Zamba2-style mamba +
shared-attention hybrid) against ``repro.models.hybrid``.

Two configs, fp32: the reduced ``zamba2-7b`` (4 mamba layers, the shared
block after every 2, no tail) and the same widths at 5 layers (two groups
and one tail layer after the last shared block, as the full config's 81 =
13 x 6 + 3 has). Weights come from the JAX package's init and cross with
``convert.params_from_jax``; tokens are drawn with numpy. Compared:
``forward`` logits and its prefill cache (mamba states, the shared block's
KV rings and ``attn_slot_pos``), ``init_cache``, three ``decode_step``s
from the prefill cache, ``loss_fn`` and its gradient; the served greedy
tokens of the port's ``Server`` against the JAX ``Server`` on the gather
route (the hybrid has no ``decode_paged`` in either package); the full
config's parameter count.

Tolerances: logits, caches and losses rtol 1e-5, atol 2e-5 (as
``test_torch_lm_train.py``); gradients within 1e-4 of the largest element
of JAX's. Logits are compared over the real vocab.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import serving as js
from repro.models import hybrid as jhybrid
from repro_torch import configs as tcfg
from repro_torch import serving as ts
from repro_torch import treemath as tm
from repro_torch.configs.base import count_params
from repro_torch.convert import params_from_jax
from repro_torch.models import hybrid as thybrid

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_REL = 1e-4
VOCAB_REAL = 500
SEQ = 19
CONFIGS = {"reduced": None, "tail": {"num_layers": 5}}


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_tree(got, want):
    gl, wl = tm.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def _logits_close(got, want):
    np.testing.assert_allclose(_np(got)[..., :VOCAB_REAL],
                               np.asarray(want)[..., :VOCAB_REAL], **TOL)


@functools.lru_cache(maxsize=None)
def models(name):
    over = CONFIGS[name]
    japi = jcfg.get(ARCH).api(reduced=True, overrides=over)
    tapi = tcfg.get(ARCH).api(reduced=True, overrides=over)
    jp = jax.jit(lambda k: japi.init(k)[0])(jax.random.PRNGKey(0))
    return japi, tapi, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB_REAL, (b, s)).astype(
        np.int32)


def test_configs_have_the_grouping_they_claim():
    assert models("reduced")[1].cfg.num_invocations == 2
    tail = models("tail")[1].cfg
    assert (tail.num_invocations, tail.num_layers
            - tail.num_invocations * tail.shared_period) == (2, 1)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_cache_and_decode(name):
    """forward over 19 tokens (chunks of 16) with its cache, then three
    decode steps from it; and the empty cache of init_cache."""
    japi, tapi, jp, tp = models(name)
    toks = _tokens(2, SEQ)
    jl, _, jc = jax.jit(lambda p, t: jhybrid.forward(
        p, t, japi.cfg, return_cache=True))(jp, toks)
    tl, _, tc = thybrid.forward(tp, torch.from_numpy(toks), tapi.cfg,
                                 return_cache=True)
    _logits_close(tl, jl)
    assert float(tl[..., VOCAB_REAL:].max()) < -1e8
    _close_tree(tc, jc)
    _close_tree(tapi.init_cache(2, 24, device="cpu")[0],
                japi.init_cache(2, 24)[0])
    # the prefill ring grafted into a 24-row cache, then decode
    jfull = jax.tree.map(
        lambda dst, src: dst.at[tuple(slice(0, d) for d in src.shape)]
        .set(src), japi.init_cache(2, 24)[0], jc)
    tfull = tapi.init_cache(2, 24, device="cpu")[0]
    tfull["mamba"] = tc["mamba"]
    for k in ("attn_k", "attn_v"):
        tfull[k][:, :, :SEQ] = tc[k]
    tfull["attn_slot_pos"][:, :SEQ] = tc["attn_slot_pos"]
    _close_tree(tfull, jfull)
    jdecode = jax.jit(japi.decode)
    for i in range(3):
        tok = _tokens(2, 1, seed=20 + i)
        jl, jfull = jdecode(jp, tok, jfull, jnp.int32(SEQ + i))
        with torch.no_grad():
            tl, tfull = tapi.decode(tp, torch.from_numpy(tok), tfull, SEQ + i)
        _logits_close(tl, jl)
        _close_tree(tfull, jfull)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grad(name):
    japi, tapi, jp, tp = models(name)
    toks = _tokens(2, SEQ + 1, seed=4)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, {"tokens": toks})))(jp)
    leaves, treedef = tm.tree_flatten(tp)
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    tloss = tapi.loss(tm.tree_unflatten(treedef, leaves),
                      {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for g, w in zip(grads, jax.tree.leaves(jgrad)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(_np(g) - w).max()) <= GRAD_REL * scale


def _serve_cfg(mod, **kw):
    return mod.ServingConfig(arch=ARCH, reduced=True, slots=2, prompt_len=8,
                             max_seq=24, page_tokens=4, temperature=0.0,
                             seed=0, virtual_dt=0.01, **kw)


def _requests(mod):
    reqs = mod.synthetic_requests(5, 8, 1, VOCAB_REAL,
                                  arrivals=(0.0, 0.0, 0.02, 0.03, 0.05),
                                  seed=3)
    for r, g in zip(reqs, (5, 9, 7, 3, 6)):
        r.max_new_tokens = g
    return reqs


def test_gather_route_serve_equals_jax():
    """Five requests over two slots: the same route, the same greedy tokens
    and the same join/evict/step counts as the JAX server."""
    _, _, jp, tp = models("reduced")
    jsrv = js.Server(_serve_cfg(js), params=jp)
    tsrv = ts.Server(_serve_cfg(ts), params=tp, device="cpu")
    assert tsrv.paged_route == jsrv.paged_route == "gather"
    jrep, trep = jsrv.run(_requests(js)), tsrv.run(_requests(ts))
    tokens = lambda rep: {r.rid: r.tokens for r in rep.completed}
    assert tokens(trep) == tokens(jrep)
    assert [len(t) for _, t in sorted(tokens(trep).items())] == [5, 9, 7, 3, 6]
    for f in ("decode_steps", "joins", "evicts", "prefill_calls"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert tsrv.cache.free_pages == tsrv.cache.num_pages


def test_full_config_param_count():
    assert count_params(tcfg.get(ARCH).api()) == 6_750_539_856
    params, _ = tcfg.get(ARCH).api().init(0, device="meta")
    assert params["mamba_layers"]["mamba"]["w_x"].shape == (81, 3584, 7168)
    assert params["shared"]["attn"]["wq"].shape == (3584, 32, 112)
