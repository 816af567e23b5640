"""Port parity: cross-attention, ``repro_torch`` against ``repro``.

Three configs, fp32: the reduced ``llama-3.2-vision-11b`` (4 layers, a
cross layer after every 2nd: two groups, no tail), the same widths at 5
layers with period 2 (two groups and one tail layer, as a config whose
depth the period does not divide has), and the reduced ``whisper-base``
(2 + 2 layers; the decoder cross-attends to the encoder after every
layer). The JAX package's ``init`` makes the weights and
``convert.params_from_jax`` carries them across; tokens and features
(``cross_feats`` / ``frames``) come from numpy.

Every cross layer's ``gate`` starts at 0 in both packages, and tanh(0) = 0
switches the cross-attention off, so a comparison at init would exercise
no cross path. Every parity test therefore sets each gate to 0.5 in the
JAX params before they cross over (``with_gates``);
``test_gate_at_zero_ignores_the_features`` pins what the init does.

Compared: the init's tree and parameter count (reduced and full size);
whisper's ``encode``; ``prefill`` logits and cache (``k``, ``v``,
``slot_pos``, ``xk``, ``xv``); three ``decode_step``s from the prefill
cache, and the port's prefill + decode against one forward over the same
tokens; ``decode_step_paged`` through each package's ``PagedKV`` on the
same page pool and resident rows; ``loss_fn`` and its gradient in every
leaf (``cross_layers.gate`` too); remat on and off.

Tolerance: max |port - jax| <= 1e-5 x max |jax| for every tensor (the two
packages sum the same fp32 products in different orders); logits are
compared over the real vocab.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import encdec as jencdec
from repro.serving import cache as jcache
from repro_torch import configs as tcfg
from repro_torch import treemath as tm
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_jax
from repro_torch.models import encdec as tencdec
from repro_torch.serving import cache as tcache

from test_torch_lm_train import with_gates

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

VISION, WHISPER = "llama-3.2-vision-11b", "whisper-base"
CONFIGS = {"vision": (VISION, None),
           "vision-tail": (VISION, {"num_layers": 5, "cross_attn_period": 2}),
           "whisper": (WHISPER, None)}
REL = 1e-5
VOCAB_REAL = 500
PROMPT, MAX_SEQ = 8, 24

torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, rel=REL):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _logits_close(got, want):
    _close(got[..., :VOCAB_REAL], np.asarray(want)[..., :VOCAB_REAL])


@functools.lru_cache(maxsize=None)
def models(name):
    """(JAX api, port api, gated JAX params, the same params on the port)."""
    arch, over = CONFIGS[name]
    japi = jcfg.get(arch).api(reduced=True, overrides=over)
    tapi = tcfg.get(arch).api(reduced=True, overrides=over)
    jp = with_gates(jax.jit(lambda k: japi.init(k)[0])(jax.random.PRNGKey(0)))
    return japi, tapi, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def make_batch(tapi, b, s, kind="prefill", seed=0):
    """numpy batch for ``tapi.batch_spec``: tokens below the real vocab,
    each feature standard normal."""
    spec = tapi.batch_spec(InputShape("parity", s, b, kind))
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(spec):
        shape, _ = spec[name]
        out[name] = (rng.integers(0, VOCAB_REAL, shape).astype(np.int32)
                     if name == "tokens"
                     else rng.standard_normal(shape).astype(np.float32))
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _names(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{path}[{k!r}]")
    else:
        yield path


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_tree_and_param_count(name):
    japi, tapi, jp, _ = models(name)
    tparams, _ = tapi.init(1, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert list(_names(tparams)) == [jax.tree_util.keystr(p)
                                     for p, _ in jleaves]
    assert [tuple(x.shape) for x in tm.tree_leaves(tparams)] == \
        [tuple(x.shape) for _, x in jleaves]
    assert tcfg.count_params(tapi) == sum(x.size for _, x in jleaves)
    gates = [x for n, x in zip(_names(tparams), tm.tree_leaves(tparams))
             if n.endswith("['gate']")]
    assert len(gates) == 1 and not gates[0].any()         # tanh(0) = 0


@pytest.mark.parametrize("arch,count", [(VISION, 11_473_915_912),
                                        (WHISPER, 128_633_862)])
def test_full_config_param_count(arch, count):
    assert tcfg.count_params(tcfg.get(arch).api()) == count == \
        jcfg.count_params(jcfg.get(arch).api())


def test_whisper_encoder_matches_jax():
    japi, tapi, jp, tp = models("whisper")
    frames = make_batch(tapi, 2, PROMPT)["frames"]
    want = jax.jit(lambda p, f: jencdec.encode(p, f, japi.cfg))(jp, frames)
    _close(tencdec.encode(tp, torch.from_numpy(frames), tapi.cfg), want)


@functools.lru_cache(maxsize=None)
def _jax_prefill(name, seq):
    japi, tapi, jp, _ = models(name)
    batch = make_batch(tapi, 2, seq)
    return batch, jax.jit(japi.prefill)(jp, _jax(batch))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_and_cache(name):
    _, tapi, _, tp = models(name)
    batch, (jl, jc) = _jax_prefill(name, PROMPT)
    tl, tc = tapi.prefill(tp, _torch(batch))
    _logits_close(tl, jl)
    assert sorted(tc) == sorted(jc) == ["k", "slot_pos", "v", "xk", "xv"]
    for k in ("k", "v", "xk", "xv"):
        _close(tc[k], jc[k])
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))


def _graft(full, pc, put):
    return {k: (pc[k] if full[k].shape == pc[k].shape else put(full[k], pc[k]))
            for k in full}


def _put_t(dst, src):
    dst = dst.clone()
    dst[tuple(slice(0, d) for d in src.shape)] = src
    return dst


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_matches_jax_and_one_forward(name):
    """Prefill 8 tokens, graft into a 24-row cache, then three decode steps
    fed fixed tokens: logits and cache against JAX's after each step, and
    each step's logits against the port's one forward over all 11 tokens
    (prefill + decode computes the same function)."""
    japi, tapi, jp, tp = models(name)
    batch, (_, jpc) = _jax_prefill(name, PROMPT)
    _, tpc = tapi.prefill(tp, _torch(batch))
    jc = _graft(japi.init_cache(2, MAX_SEQ)[0], jpc,
                lambda d, s: d.at[tuple(slice(0, n) for n in s.shape)].set(s))
    tc = _graft(tapi.init_cache(2, MAX_SEQ, device="cpu")[0], tpc, _put_t)
    steps = np.random.default_rng(7).integers(0, VOCAB_REAL, (2, 3)).astype(
        np.int32)
    whole = dict(batch, tokens=np.concatenate([batch["tokens"], steps], 1))
    full_logits = _full_forward(tapi, tp, whole)
    jdecode = jax.jit(japi.decode)
    for j in range(3):
        tok = steps[:, j:j + 1]
        jl, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.int32(PROMPT + j))
        tl, tc = tapi.decode(tp, torch.from_numpy(tok), tc, PROMPT + j)
        _logits_close(tl, jl)
        for k in ("k", "v", "xk", "xv"):
            _close(tc[k], jc[k])
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        _close(tl[:, 0, :VOCAB_REAL],
               full_logits[:, PROMPT + j, :VOCAB_REAL].numpy())


def _full_forward(tapi, tp, batch):
    from repro_torch.models import transformer as ttr
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        if tapi.family == "encdec":
            return tencdec.forward(tp, tokens, torch.from_numpy(
                batch["frames"]), tapi.cfg)[0]
        return ttr.forward(tp, tokens, tapi.cfg, cross_feats=torch.from_numpy(
            batch["cross_feats"]))[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_step_paged_matches_jax(name):
    """One batched-position decode step through each package's PagedKV on
    the same random page pool (one slot lazily paged) and the same
    resident rows, which carry the slot-stacked cross K/V: logits, the
    one-token cache update, and xk/xv handed back unchanged."""
    japi, tapi, jp, tp = models(name)
    jlay = jcache.build_layout(japi, MAX_SEQ, 4)
    tlay = tcache.build_layout(tapi, MAX_SEQ, 4, device="cpu")
    assert tlay.res_width == jlay.res_width > 0
    rng = np.random.default_rng(5)
    s, pps = 3, tlay.pages_per_slot
    n_pages = s * pps
    pages = (0.5 * rng.standard_normal(
        (n_pages + 1, tlay.page_tokens, tlay.width))).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(s, pps).astype(np.int32)
    tables[1, 3:] = n_pages                                # lazy slot
    pos = np.array([tlay.tokens - 1, 9, 4], np.int32)
    res = rng.standard_normal((s, tlay.res_width)).astype(np.float32)
    token = rng.integers(0, VOCAB_REAL, (s, 1)).astype(np.int32)
    jkv = jlay.paged_kv(jnp.asarray(pages), jnp.asarray(tables),
                        jnp.asarray(pos))
    tkv = tlay.paged_kv(torch.from_numpy(pages), torch.from_numpy(tables),
                        torch.from_numpy(pos))
    jl, jnew = japi.decode_paged(jp, jnp.asarray(token),
                                 jlay.unpack_resident(jnp.asarray(res)),
                                 jnp.asarray(pos), jkv)
    tcache_in = tlay.unpack_resident(torch.from_numpy(res))
    tl, tnew = tapi.decode_paged(tp, torch.from_numpy(token), tcache_in,
                                 torch.from_numpy(pos), tkv)
    _logits_close(tl, jl)
    for k in ("k", "v"):
        _close(tnew[k], jnew[k])
    for k in ("xk", "xv"):
        assert tnew[k] is tcache_in[k]
        assert tuple(tnew[k].shape) == jnew[k].shape
        assert (tnew[k].shape[0], tnew[k].shape[2]) == (s, 1)
        _close(tnew[k], jnew[k])
    np.testing.assert_array_equal(tnew["slot_pos"].numpy(),
                                  np.asarray(jnew["slot_pos"]))


def _loss_and_grads(tapi, tp, batch):
    leaves, treedef = tm.tree_flatten(tp)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = tapi.loss(tm.tree_unflatten(treedef, leaves), _torch(batch))
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grad(name):
    """The loss and the gradient in every leaf, the gates' too."""
    japi, tapi, jp, tp = models(name)
    batch = make_batch(tapi, 2, 12, kind="train", seed=4)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, _jax(batch))))(jp)
    tloss, grads = _loss_and_grads(tapi, tp, batch)
    _close(tloss, np.asarray(jloss))
    jpaths = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert any(jax.tree_util.keystr(p).endswith("['gate']") for p, _ in jpaths)
    for g, (path, jg) in zip(grads, jpaths):
        assert float(np.abs(np.asarray(jg)).max()) > 0, \
            jax.tree_util.keystr(path)
        _close(g, jg)


@pytest.mark.parametrize("name", ["vision-tail", "whisper"])
def test_remat_changes_no_number(name):
    """Remat recomputes each self layer and each cross layer (the encoder's
    layers too) in the backward pass: the loss and every gradient equal
    the run without it bit for bit."""
    arch, over = CONFIGS[name]
    _, _, _, tp = models(name)
    runs = []
    for remat in (False, True):
        tapi = tcfg.get(arch).api(reduced=True,
                                  overrides=dict(over or {}, remat=remat))
        runs.append(_loss_and_grads(
            tapi, tp, make_batch(tapi, 2, 12, kind="train", seed=4)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["vision", "whisper"])
def test_gate_at_zero_ignores_the_features(name):
    """With the gates at 0.5 the features move the logits; at init (every
    gate 0, in both packages) they do not, yet the gates' gradient is not
    zero (d tanh / d gate = 1 at 0), so training opens them."""
    japi, tapi, jp, tp = models(name)
    feat = "frames" if tapi.family == "encdec" else "cross_feats"
    batch = make_batch(tapi, 2, PROMPT)
    other = dict(batch, **{feat: make_batch(tapi, 2, PROMPT, seed=9)[feat]})
    closed = params_from_jax(jax.tree.map(np.asarray, with_gates(jp, 0.0)),
                             "cpu")
    with torch.no_grad():
        for params, moves in ((tp, True), (closed, False)):
            a = tapi.prefill(params, _torch(batch))[0]
            b = tapi.prefill(params, _torch(other))[0]
            assert bool((a - b).abs().max() > 1e-3) is moves
    grads = dict(zip(_names(closed), _loss_and_grads(
        tapi, closed, make_batch(tapi, 2, 12, kind="train"))[1]))
    gate_grad = [g for n, g in grads.items() if n.endswith("['gate']")][0]
    assert bool((gate_grad != 0).all())
