"""Port parity: ``repro_torch.models.transformer`` (the dense
self-attention path) against ``repro.models.transformer``.

Reduced configs, fp32: ``deepseek-7b`` (MHA), ``h2o-danube-1.8b`` (GQA with
one kv head, sliding window 16) and ``qwen3-14b`` (qk-norm, 5 query heads
over 1 kv head). The JAX package's ``init`` makes the weights and
``convert.params_from_jax`` carries them across; token inputs come from
numpy. Compared: ``forward`` logits (naive and chunked attention), the
prefill cache (including a prompt longer than the window), four
``decode_step``s, ``decode_step_paged`` through a ``PagedKV`` on a filled
page pool (positions below and past the ring length), and ``loss_fn`` with its gradient.

Tolerance: every comparison holds max |port - jax| <= 1e-5 x max |jax| (the
two packages sum the same fp32 products in different orders). Logits are
compared over the real vocab (the padded tail is -1e9 in both).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import dispatch as jdispatch
from repro.models import transformer as jtr
from repro.serving import cache as jcache
from repro_torch import configs as tcfg
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttr
from repro_torch.serving import cache as tcache

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

ARCHS = ["deepseek-7b", "h2o-danube-1.8b", "qwen3-14b"]
REL = 1e-5
MAX_SEQ = 24


def _close(got, want, rel=REL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    japi = jcfg.get(arch).api(reduced=True)
    tapi = tcfg.get(arch).api(reduced=True)
    jp, _ = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return arch, japi, tapi, jp, tp


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 500, (b, s)).astype(np.int32)


def test_init_structure_matches(models):
    _, japi, tapi, jp, _ = models
    tparams, taxes = tapi.init(1, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tnames = [n for n in _names(tparams)]
    assert tnames == [jax.tree_util.keystr(p) for p, _ in jleaves]
    assert [tuple(x.shape) for x in tm.tree_leaves(tparams)] == \
        [tuple(x.shape) for _, x in jleaves]
    assert tcfg.count_params(tapi) == jcfg.count_params(japi)


def _names(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{path}[{k!r}]")
    else:
        yield path


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_forward_logits(models, impl):
    _, japi, tapi, jp, tp = models
    ov = {"attn_impl": impl, "attn_chunk": 8}
    jc = dataclass_replace(japi.cfg, **ov)
    tc = dataclass_replace(tapi.cfg, **ov)
    toks = _tokens(2, 20)
    jl, _ = jtr.forward(jp, jnp.asarray(toks), jc)
    tl, _ = ttr.forward(tp, torch.from_numpy(toks), tc)
    v = tc.vocab_real
    _close(tl[..., :v], np.asarray(jl)[..., :v])
    assert torch.equal(tl[..., v:], torch.from_numpy(np.asarray(jl)[..., v:]))


def dataclass_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("seq", [8, 20])
def test_prefill_cache(models, seq):
    """seq 20 > danube's window 16: the ring keeps the last 16 positions,
    permuted so position p sits in row p % 16."""
    _, japi, tapi, jp, tp = models
    toks = _tokens(2, seq, seed=seq)
    jl, jcache_ = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache_ = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, np.asarray(jl))
    for k in ("k", "v"):
        assert tuple(tcache_[k].shape) == jcache_[k].shape
        _close(tcache_[k], np.asarray(jcache_[k]))
    np.testing.assert_array_equal(tcache_["slot_pos"].numpy(),
                                  np.asarray(jcache_["slot_pos"]))


def _graft_j(api, pc):
    full = api.init_cache(1, MAX_SEQ)[0]
    return jax.tree.map(
        lambda dst, src: src if dst.shape == src.shape
        else dst.at[tuple(slice(0, d) for d in src.shape)].set(src), full, pc)


def _graft_t(api, pc):
    full = api.init_cache(1, MAX_SEQ, device="cpu")[0]

    def put(dst, src):
        if dst.shape == src.shape:
            return src
        dst = dst.clone()
        dst[tuple(slice(0, d) for d in src.shape)] = src
        return dst
    return tm.tree_map(put, full, pc)


def test_decode_steps(models):
    """Prefill 8 tokens, then 4 single-token decode steps fed the JAX
    argmax, comparing logits and the ring cache after each."""
    _, japi, tapi, jp, tp = models
    toks = _tokens(1, 8, seed=3)
    jl, jpc = japi.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tpc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc, tc = _graft_j(japi, jpc), _graft_t(tapi, tpc)
    tok = int(jnp.argmax(jl[0, -1]))
    for j in range(4):
        jl, jc = japi.decode(jp, jnp.asarray([[tok]], jnp.int32), jc,
                             jnp.int32(8 + j))
        tl, tc = tapi.decode(tp, torch.tensor([[tok]]), tc, 8 + j)
        _close(tl, np.asarray(jl))
        for k in ("k", "v"):
            _close(tc[k], np.asarray(jc[k]))
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        tok = int(jnp.argmax(jl[0, -1]))


def test_decode_step_paged_on_filled_pool(models):
    """One batched-position decode step through each package's PagedKV on
    the same random pool (positions below the ring length)."""
    _paged_step_matches(models, lambda c: [c - 1, 9, 4])


def test_decode_step_paged_on_wrapped_ring(models, monkeypatch):
    """As above with every slot past its ring length. The cursor row then
    holds position pos - C, which the port drops as the JAX oracle does;
    the JAX side is held to its oracle (the Pallas kernel keeps that row
    once a ring has wrapped without a window: ROADMAP C, pinned in
    tests/test_torch_paged_attention.py)."""
    monkeypatch.setattr(jdispatch, "CONFIG", dataclasses.replace(
        jdispatch.CONFIG, interpret_max_elements=0))
    _paged_step_matches(models, lambda c: [c + 3, 2 * c + 1, c])


def _paged_step_matches(models, positions):
    _, japi, tapi, jp, tp = models
    jlay = jcache.build_layout(japi, MAX_SEQ, 4)
    tlay = tcache.build_layout(tapi, MAX_SEQ, 4, device="cpu")
    rng = np.random.default_rng(5)
    s, pps = 3, tlay.pages_per_slot
    n_pages = s * pps
    pages = (0.5 * rng.standard_normal(
        (n_pages + 1, tlay.page_tokens, tlay.width))).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(s, pps).astype(np.int32)
    tables[1, 3:] = n_pages                                # lazy slot
    pos = np.array(positions(tlay.tokens), np.int32)
    token = rng.integers(0, 500, (s, 1)).astype(np.int32)
    jkv = jlay.paged_kv(jnp.asarray(pages), jnp.asarray(tables),
                        jnp.asarray(pos))
    tkv = tlay.paged_kv(torch.from_numpy(pages), torch.from_numpy(tables),
                        torch.from_numpy(pos))
    jl, jnew = japi.decode_paged(jp, jnp.asarray(token),
                                 jlay.unpack_resident(jnp.zeros((s, 0))),
                                 jnp.asarray(pos), jkv)
    tl, tnew = tapi.decode_paged(tp, torch.from_numpy(token),
                                 tlay.unpack_resident(torch.zeros((s, 0))),
                                 torch.from_numpy(pos), tkv)
    _close(tl, np.asarray(jl))
    for k in ("k", "v"):
        assert tuple(tnew[k].shape) == jnew[k].shape
        _close(tnew[k], np.asarray(jnew[k]))
    np.testing.assert_array_equal(tnew["slot_pos"].numpy(),
                                  np.asarray(jnew["slot_pos"]))


def test_loss_and_grad(models):
    _, japi, tapi, jp, tp = models
    toks = _tokens(2, 13, seed=9)
    jloss, jgrad = jax.value_and_grad(japi.loss)(jp, {"tokens": jnp.asarray(toks)})
    leaves, treedef = tm.tree_flatten(tp)
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    tloss = tapi.loss(tm.tree_unflatten(treedef, leaves),
                      {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tloss, leaves)
    _close(tloss, np.asarray(jloss))
    for g, (path, jg) in zip(grads, jax.tree_util.tree_flatten_with_path(jgrad)[0]):
        _close(g, np.asarray(jg))


def test_unported_paths_raise():
    """Every arch of the JAX package now builds in the port, with the JAX
    family: the cross-attention archs too (the transformer takes any
    ``cross_attn_period``; its init and cache gain the cross leaves)."""
    cfg = dataclass_replace(tcfg.get("deepseek-7b").make_config(reduced=True),
                            cross_attn_period=1, cross_tokens=3, cross_dim=8)
    params, _ = ttr.init(0, cfg, device="cpu")
    assert params["cross_layers"]["xattn"]["wk"].shape == (2, 8, 4, 32)
    cache, _ = ttr.init_cache(cfg, 1, 4, device="cpu")
    assert cache["xk"].shape == (2, 1, 3, 4, 32)
    for arch in ("whisper-base", "llama-3.2-vision-11b", "mamba2-1.3b",
                 "zamba2-7b"):
        assert tcfg.get(arch).api(reduced=True).family == \
            jcfg.get(arch).api(reduced=True).family
    assert set(tcfg.list_archs()) == set(jcfg.list_archs())


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = tcfg.get("deepseek-7b").api(reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(1, 8)
