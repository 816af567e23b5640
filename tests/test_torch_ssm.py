"""Port parity: ``repro_torch.models.ssm`` (the Mamba2 SSD block and the
pure-SSM LM) against ``repro.models.ssm``.

Weights come from the JAX package's init and cross with
``convert.params_from_jax``; inputs are drawn with numpy. fp32 throughout.
Compared: ``mamba_forward`` with and without a cache at a length that is
not a multiple of the chunk, streaming against one batch pass, the T = 1
decode (the port's recurrence) against JAX's chunk-padded decode,
``lm_forward`` (logits and the returned cache), ``lm_loss`` and its
gradient at the reduced ``mamba2-1.3b``, and the full config's parameter
count.

Tolerances: outputs, caches, logits and losses rtol 1e-5, atol 2e-5 (the
two packages sum the same fp32 products in different orders, as in
``test_torch_lm_train.py``); gradients within 1e-4 of the largest element
of JAX's.

The reference's masked exponential is pinned too: at mamba2-1.3b's full
head count and chunk (64 heads, chunk 256) JAX's ``_ssd_chunked`` takes
``exp`` of the positive upper triangle, which overflows, and its gradient
turns non-finite there; the port masks before the ``exp`` and equals JAX
with a test-local copy of ``_ssd_chunked`` that does the same.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as jssm
from repro import configs as jcfg
from repro.models import layers as jlayers
from repro_torch import configs as tcfg
from repro_torch import treemath as tm
from repro_torch.configs.base import count_params
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as tssm

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_REL = 1e-4
BLOCK = dict(d_model=16, d_state=8, head_dim=8, expand=2, chunk=5,
             conv_width=4)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_tree(got, want, **tol):
    gl, wl = tm.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(_np(g), np.asarray(w), **(tol or TOL))


def _grad_close(got, want):
    for g, w in zip(tm.tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(_np(g) - w).max()) <= GRAD_REL * scale


@functools.lru_cache(maxsize=None)
def block(**kw):
    """(settings JAX, settings port, JAX params, port params)."""
    jc, tc = jssm.SSMSettings(**kw), tssm.SSMSettings(**kw)
    jp, _ = jlayers.unzip(jssm.init_mamba_block(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(b, t, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jforward(cfg):
    return jax.jit(lambda p, x, c: jssm.mamba_forward(p, x, cfg, cache=c))


def test_mamba_forward_with_and_without_cache():
    """T = 13 over chunks of 5 (two padded), then 7 more tokens through the
    cache the first segment left."""
    jc, tc, jp, tp = block(**BLOCK)
    x = _x(2, 20, BLOCK["d_model"])
    jy, jcache = _jforward(jc)(jp, x[:, :13], None)
    ty, tcache = tssm.mamba_forward(tp, torch.from_numpy(x[:, :13]), tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    _close_tree(tcache, jcache)
    jy2, jcache2 = _jforward(jc)(jp, x[:, 13:], jcache)
    ty2, tcache2 = tssm.mamba_forward(tp, torch.from_numpy(x[:, 13:]), tc,
                                      cache=tcache)
    np.testing.assert_allclose(_np(ty2), np.asarray(jy2), **TOL)
    _close_tree(tcache2, jcache2)


@pytest.mark.parametrize("seed,t", [(0, 4), (1, 9), (2, 16), (3, 11)])
def test_ssd_streaming_equals_batch(seed, t):
    """Two segments through the cache equal one full pass (the SSD state is
    a sufficient statistic): the port's twin of
    ``test_model_properties.test_ssd_streaming_equals_batch``, at its
    tolerance (2e-4)."""
    _, tc, _, tp = block(**BLOCK)
    x = torch.from_numpy(_x(1, t, BLOCK["d_model"], seed))
    y_full, _ = tssm.mamba_forward(tp, x, tc)
    cut = t // 2
    y1, cache = tssm.mamba_forward(tp, x[:, :cut], tc)
    y2, _ = tssm.mamba_forward(tp, x[:, cut:], tc, cache=cache)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full),
                               rtol=2e-4, atol=2e-4)


def test_single_token_recurrence_matches_jax_padded_decode():
    """The port runs T = 1 as the recurrence; JAX pads it to a whole chunk.
    Three decode steps from a 7-token prefix's cache."""
    jc, tc, jp, tp = block(**BLOCK)
    x = _x(3, 10, BLOCK["d_model"], seed=5)
    _, jcache = _jforward(jc)(jp, x[:, :7], None)
    _, tcache = tssm.mamba_forward(tp, torch.from_numpy(x[:, :7]), tc)
    for i in range(7, 10):
        jy, jcache = jax.jit(lambda p, x, c: jssm.mamba_decode(p, x, c, jc))(
            jp, x[:, i:i + 1], jcache)
        ty, tcache = tssm.mamba_decode(tp, torch.from_numpy(x[:, i:i + 1]),
                                       tcache, tc)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        _close_tree(tcache, jcache)


@functools.lru_cache(maxsize=None)
def lm():
    japi = jcfg.get("mamba2-1.3b").api(reduced=True)
    tapi = tcfg.get("mamba2-1.3b").api(reduced=True)
    jp = jax.jit(lambda k: japi.init(k)[0])(jax.random.PRNGKey(0))
    return japi, tapi, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 500, (b, s)).astype(
        np.int32)


def test_lm_forward_logits_and_cache():
    """T = 21 over chunks of 16; logits over the real vocab (the padded
    tail is -1e9 in both), and every layer's returned cache."""
    japi, tapi, jp, tp = lm()
    toks = _tokens(2, 21)
    jl, jc = jax.jit(lambda p, t: jssm.lm_forward(p, t, japi.cfg,
                                                  return_cache=True))(jp, toks)
    tl, tc = tssm.lm_forward(tp, torch.from_numpy(toks), tapi.cfg,
                             return_cache=True)
    np.testing.assert_allclose(_np(tl)[..., :500], np.asarray(jl)[..., :500],
                               **TOL)
    assert float(tl[..., 500:].max()) < -1e8
    _close_tree(tc, jc)
    # prefill + two decode steps through the API against JAX's
    jc_ = jax.jit(japi.prefill)(jp, {"tokens": toks})[1]
    tc_ = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)})[1]
    jdecode = jax.jit(japi.decode)
    for i in range(2):
        tok = _tokens(2, 1, seed=10 + i)
        jl, jc_ = jdecode(jp, tok, jc_, 21 + i)
        tl, tc_ = tapi.decode(tp, torch.from_numpy(tok), tc_, 21 + i)
        np.testing.assert_allclose(_np(tl)[..., :500],
                                   np.asarray(jl)[..., :500], **TOL)
        _close_tree(tc_, jc_)


def _loss_and_grads(api, params, tokens):
    leaves, treedef = tm.tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = api.loss(tm.tree_unflatten(treedef, leaves),
                    {"tokens": torch.from_numpy(tokens)})
    return loss, tm.tree_unflatten(treedef, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grad(remat):
    """lm_loss and its gradient against jax.value_and_grad (T = 20 inputs);
    with remat the port recomputes each layer in the backward pass."""
    japi, _, jp, tp = lm()
    tapi = tcfg.get("mamba2-1.3b").api(reduced=True,
                                       overrides={"remat": remat})
    toks = _tokens(2, 21, seed=3)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, {"tokens": toks})))(jp)
    tloss, tgrad = _loss_and_grads(tapi, tp, toks)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    _grad_close(tgrad, jgrad)


def test_full_config_param_count():
    assert count_params(tcfg.get("mamba2-1.3b").api()) == 1_446_538_240
    params, _ = tcfg.get("mamba2-1.3b").api().init(0, device="meta")
    assert params["layers"]["mamba"]["w_x"].shape == (48, 2048, 4096)


# -- the reference's masked exponential --------------------------------------

FULL_HEADS = dict(d_model=64, d_state=16, head_dim=2, expand=2, chunk=256,
                  conv_width=4)             # 64 heads, mamba2-1.3b's chunk


def _ssd_chunked_masked_first(xh, a_log_dt, dt, bmat, cmat, cfg, h0=None):
    """``repro.models.ssm._ssd_chunked`` with one change: ``diff`` is
    masked to -inf above the diagonal before the exponential."""
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    q = cfg.chunk
    pad = (-t) % q
    if pad:
        xh = jnp.pad(xh, ((0, 0), (0, pad), (0, 0), (0, 0)))
        a_log_dt = jnp.pad(a_log_dt, ((0, 0), (0, pad), (0, 0)))
        dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
        bmat = jnp.pad(bmat, ((0, 0), (0, pad), (0, 0)))
        cmat = jnp.pad(cmat, ((0, 0), (0, pad), (0, 0)))
    tt = t + pad
    nc = tt // q
    xh = xh.reshape(b, nc, q, h, p).astype(jnp.float32)
    la = a_log_dt.reshape(b, nc, q, h).astype(jnp.float32)
    dt = dt.reshape(b, nc, q, h).astype(jnp.float32)
    bm = bmat.reshape(b, nc, q, n).astype(jnp.float32)
    cm = cmat.reshape(b, nc, q, n).astype(jnp.float32)
    cum = jnp.cumsum(la, axis=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = jnp.tril(jnp.ones((q, q), bool))
    decay = jnp.exp(jnp.where(tri[None, None, :, :, None], diff, -jnp.inf))
    scores = jnp.einsum("bcin,bcjn->bcij", cm, bm)
    m = scores[..., None] * decay * dt[:, :, None, :, :]
    y_intra = jnp.einsum("bcijh,bcjhp->bcihp", m, xh)
    tail_decay = jnp.exp(cum[:, :, -1:, :] - cum)
    s_chunk = jnp.einsum("bcqh,bcqn,bcqhp->bchnp", dt * tail_decay, bm, xh)
    chunk_decay = jnp.exp(cum[:, :, -1, :])

    def chunk_step(hprev, inp):
        s_c, cd = inp
        return cd[..., None, None] * hprev + s_c, hprev

    h0 = (jnp.zeros((b, h, n, p), jnp.float32) if h0 is None
          else h0.astype(jnp.float32))
    h_final, h_prevs = jax.lax.scan(
        chunk_step, h0, (jnp.swapaxes(s_chunk, 0, 1),
                         jnp.swapaxes(chunk_decay, 0, 1)))
    h_prevs = jnp.swapaxes(h_prevs, 0, 1)
    y_inter = jnp.einsum("bcqn,bchnp,bcqh->bcqhp", cm, h_prevs, jnp.exp(cum))
    y = (y_intra + y_inter).reshape(b, tt, h, p)[:, :t]
    return y, h_final


def _jax_probe(cfg, jp, x, w):
    """JAX's forward output and the gradient of sum(y * w) (fixed weights),
    traced afresh, so a patched ``_ssd_chunked`` is the one it runs."""
    def loss(p):
        y = jssm.mamba_forward(p, x, cfg)[0]
        return (y * w).sum(), y
    grad, y = jax.jit(jax.grad(loss, has_aux=True))(jp)
    return np.asarray(y), grad


def test_reference_gradient_fault_and_the_port_fix(monkeypatch):
    """64 heads, chunk 256, T 256: JAX's gradient is non-finite in a_log,
    dt_bias and w_dt; the port's is finite and equals JAX's gradient under
    the masked-before-exp ``_ssd_chunked``; the forward outputs agree with
    JAX's in both cases."""
    jc, tc, jp, tp = block(**FULL_HEADS)
    assert tc.num_heads == 64 and tc.chunk == 256
    x = _x(1, 256, FULL_HEADS["d_model"], seed=7)
    w = np.random.default_rng(8).standard_normal((1, 256, 64)).astype(
        np.float32)
    jy_raw, jg_raw = _jax_probe(jc, jp, x, w)
    for name in ("a_log", "dt_bias", "w_dt"):
        assert not np.isfinite(np.asarray(jg_raw[name])).all(), name

    monkeypatch.setattr(jssm, "_ssd_chunked", _ssd_chunked_masked_first)
    jy_fix, jg_fix = _jax_probe(jc, jp, x, w)
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree.leaves(jg_fix))

    leaves, treedef = tm.tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    params = tm.tree_unflatten(treedef, leaves)
    ty, _ = tssm.mamba_forward(params, torch.from_numpy(x), tc)
    tgrad = tm.tree_unflatten(treedef, torch.autograd.grad(
        (ty * torch.from_numpy(w)).sum(), leaves))
    assert all(torch.isfinite(g).all() for g in tm.tree_leaves(tgrad))
    np.testing.assert_allclose(_np(ty), jy_raw, **TOL)
    np.testing.assert_allclose(_np(ty), jy_fix, **TOL)
    _grad_close(tgrad, jg_fix)
