"""Decoder transformer (port of ``repro/models/transformer.py``).

Dense or MoE FFN, GQA, qk-norm, RoPE, the sliding window and periodic
tanh-gated cross-attention (the VLM / encoder-decoder bridge), with the
reference's parameter and cache layouts kept as they are so that
``convert.params_from_jax`` and the checkpoint format carry over unchanged:

  * layer params are stacked ``[L, ...]`` leaves under ``params["layers"]``
    with JAX's dict keys; the JAX package's ``lax.scan`` over layers is a
    Python loop over the stacked leaves here;
  * KV caches are ring buffers ``k``/``v`` ``[L, B, C, Hkv, hd]`` with an
    explicit per-row absolute-position array ``slot_pos`` ``[L, C]``
    (-1 = empty); one code path serves full-causal and sliding-window
    attention, prefill and single-token decode;
  * with ``cross_attn_period`` every ``period``-th layer is followed by a
    cross layer (``params["cross_layers"]``, stacked ``[num_cross, ...]``:
    ``ln1``, ``xattn``, ``ln2``, ``mlp`` and a scalar ``gate``, 0 at init,
    that scales the cross-attention through ``tanh``). Layers after the
    last full group run as a tail with no cross layer. The cross K/V of
    the features are computed once at prefill and kept in the cache as
    ``xk``/``xv`` ``[num_cross, B, cross_tokens, Hkv, hd]``.

``cfg.remat`` recomputes each layer's activations in the backward pass
(``torch.utils.checkpoint`` per layer, as the JAX package wraps each scanned
layer in ``jax.checkpoint``): it changes no number, only the memory a
training step holds; each cross layer is recomputed as one unit, as the
JAX package checkpoints its ``run_cross``. The MoE FFN (``models/moe.py``)
groups its tokens by the ambient mesh. ``forward`` and the decode steps
read each layer's params (and ``embed``, ``head``, ``final_ln``) through
the ambient fetch (``sharding.rules.use_fetch``): the identity, or on a
mesh an FSDP arch's gather of that layer from its data-axis shards (in
``forward`` inside the remat body, so the backward pass gathers it again),
dropped once the layer has run. :func:`decode_slots` steps several slots
through each layer before it reads the next, so a serve step reads each
param once.

Tensor-parallel compute (the JAX package's ``cfg.tp`` layouts, which GSPMD
partitions there): under ``sharding.rules.use_model_parallel`` (installed
by the engine's loss on a model axis > 1) the params are this rank's
model-axis shards and each layer computes on them. ``copy`` (identity
forward, all-reduce backward) marks where a replicated value enters a
rank-partial product, ``reduce`` (all-reduce forward) closes one:

  * attention by ``cfg.attn_mode``: ``head`` runs this rank's q and kv
    heads; ``mixed`` its q heads and the kv heads they use, from the
    replicated ``wk``/``wv``; ``contraction`` projects q/k/v from its
    ``d_model`` slice (``reduce`` makes them whole), attends on whole heads
    and multiplies its ``head_dim`` slice of the output into its ``wo``
    block. ``wo`` is row-parallel in every mode;
  * the dense FFN column-parallel on ``mlp``, ``w_down`` row-parallel.
    A row-parallel product keeps its partial sums fp32 until ``reduce``
    has summed them, so it rounds once, as one process's does;
  * the embedding from this rank's vocab rows, the head column-parallel on
    ``vocab`` and ``sharded_ce`` vocab-parallel (max, sum of exp and the
    picked logit each summed over the ranks);
  * the MoE FFN over this rank's experts (``models/moe.py``).

The serving plane runs prefill (``forward(return_cache=True)``) and both
decode steps under the same context: a rank's cache holds the kv heads it
attends with (:func:`rank_kv_heads`), and its logits are its vocab columns,
which the serve step gathers whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.sharding import rules as rules_lib

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class MoESettings:
    num_experts: int          # padded to a multiple of tp
    num_experts_real: int
    top_k: int
    d_ff: int                 # per-expert hidden width
    shared_d_ff: int = 0      # total hidden width of always-on shared experts
    capacity_factor: float = 1.25
    aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int                # padded to a multiple of tp
    vocab_real: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    swa_window: Optional[int] = None     # sliding-window size (None = full)
    moe: Optional[MoESettings] = None
    causal: bool = True                  # False => encoder (bidirectional)
    cross_attn_period: Optional[int] = None  # every Nth layer cross-attends
    cross_tokens: int = 0                # encoder/vision sequence length
    cross_dim: int = 0                   # encoder/vision feature dim
    tp: int = 16
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    remat: bool = True                   # recompute layers in backward
    logit_softcap: float = 0.0
    # "naive": materialise the [S, S] scores; "chunked": online softmax over
    # kv blocks of ``attn_chunk``.
    attn_impl: str = "naive"
    attn_chunk: int = 1024
    attn_softmax_dtype: Any = torch.float32

    @property
    def attn_mode(self) -> str:
        if self.num_heads % self.tp == 0 and self.num_kv_heads % self.tp == 0:
            return "head"
        if self.num_heads % self.tp == 0:
            return "mixed"
        return "contraction"

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def num_cross_layers(self) -> int:
        if not self.cross_attn_period:
            return 0
        return self.num_layers // self.cross_attn_period


# ---------------------------------------------------------------- init -----

def _attn_axes(cfg: TransformerConfig):
    mode = cfg.attn_mode
    if mode == "head":
        return (("embed", "heads", None), ("embed", "kv_heads", None),
                ("heads", None, "embed"))
    if mode == "mixed":
        return (("embed", "heads", None), ("embed", None, None),
                ("heads", None, "embed"))
    return (("d_sharded", None, None), ("d_sharded", None, None),
            (None, "head_dim_sharded", "embed"))


def _init_attention(gen, cfg: TransformerConfig, dev, lead=(),
                    cross: bool = False):
    """One attention block's Params (``lead`` prepends stacked axes). A
    cross block's K/V project from ``cross_dim`` features."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = cfg.cross_dim if cross else d
    q_axes, kv_axes, o_axes = _attn_axes(cfg)
    dense = lambda shape, axes, **kw: L.dense_init(
        gen, shape, axes, dtype=cfg.param_dtype, device=dev, lead=lead, **kw)
    attn = {"wq": dense((d, h, hd), q_axes),
            "wk": dense((kv_in, hkv, hd), kv_axes),
            "wv": dense((kv_in, hkv, hd), kv_axes),
            "wo": dense((h, hd, d), o_axes, in_axis=-1)}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            attn[name] = L.scale_init(tuple(lead) + (hd,), (None,),
                                      dtype=cfg.param_dtype, device=dev)
    return attn


def _init_dense_ffn(gen, cfg: TransformerConfig, dev, lead=()):
    """One SwiGLU FFN's Params (``lead`` prepends stacked axes)."""
    d, f = cfg.d_model, cfg.d_ff
    dense = lambda shape, axes: L.dense_init(
        gen, shape, axes, dtype=cfg.param_dtype, device=dev, lead=lead)
    return {"w_gate": dense((d, f), ("embed", "mlp")),
            "w_up": dense((d, f), ("embed", "mlp")),
            "w_down": dense((f, d), ("mlp", "embed"))}


def _init_layers(gen, cfg: TransformerConfig, dev):
    """All ``L`` layers at once, as stacked ``[L, ...]`` Params."""
    d, pdt = cfg.d_model, cfg.param_dtype
    lead = (cfg.num_layers,)
    scale = lambda shape, axes: L.scale_init(lead + shape, axes, dtype=pdt,
                                             device=dev)
    layer = {"ln1": scale((d,), ("embed",)),
             "attn": _init_attention(gen, cfg, dev, lead),
             "ln2": scale((d,), ("embed",))}
    if cfg.moe is not None:
        layer["moe"] = moe_lib.init_moe(gen, d, cfg.moe, pdt, device=dev,
                                        lead=lead)
    else:
        layer["mlp"] = _init_dense_ffn(gen, cfg, dev, lead)
    return layer


def _init_cross_layers(gen, cfg: TransformerConfig, dev):
    """All ``num_cross_layers`` cross layers at once, stacked; each
    ``gate`` starts at 0, so an initialised model ignores its features."""
    d, pdt = cfg.d_model, cfg.param_dtype
    lead = (cfg.num_cross_layers,)
    scale = lambda shape, axes, value=1.0: L.scale_init(
        lead + shape, axes, value=value, dtype=pdt, device=dev)
    return {"ln1": scale((d,), ("embed",)),
            "xattn": _init_attention(gen, cfg, dev, lead, cross=True),
            "ln2": scale((d,), ("embed",)),
            "mlp": _init_dense_ffn(gen, cfg, dev, lead),
            "gate": scale((), (), value=0.0)}


def init(key, cfg: TransformerConfig, device=None) -> Tuple[Any, Any]:
    """Returns (params, axes), parallel trees. ``key`` is an int seed or a
    ``torch.Generator`` on ``device`` (CUDA unless ``device="cpu"``; on
    ``"meta"`` only shapes are made). The draws differ from ``jax.random``'s;
    carry JAX's weights over with ``convert.params_from_jax``."""
    dev = device_lib.resolve(device)
    gen = device_lib.init_generator(key, dev)
    pdt = cfg.param_dtype
    emb = L.embed_init(gen, (cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       dtype=pdt, device=dev)
    head = L.dense_init(gen, (cfg.d_model, cfg.vocab), ("embed", "vocab"),
                        dtype=pdt, device=dev)
    final_ln = L.scale_init((cfg.d_model,), ("embed",), dtype=pdt, device=dev)
    layer_values, layer_axes = L.unzip(_init_layers(gen, cfg, dev))
    params = {"embed": emb.value, "head": head.value,
              "final_ln": final_ln.value, "layers": layer_values}
    axes = {"embed": emb.axes, "head": head.axes, "final_ln": final_ln.axes,
            "layers": L.stacked_axes(layer_axes)}
    if cfg.num_cross_layers:
        params["cross_layers"], cross_axes = L.unzip(
            _init_cross_layers(gen, cfg, dev))
        axes["cross_layers"] = L.stacked_axes(cross_axes)
    return params, axes


# --------------------------------------------------------------- cache -----

def cache_len(cfg: TransformerConfig, seq_len: int) -> int:
    return min(seq_len, cfg.swa_window) if cfg.swa_window else seq_len


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               device=None):
    """Ring-buffer KV cache + per-row absolute positions (-1 = empty).
    Returns (cache, axes). Under an ambient model-parallel context the
    k/v rings hold this rank's kv heads (:func:`rank_kv_heads`); the axes
    name the whole cache's dims."""
    dev = device_lib.resolve(device)
    clen = cache_len(cfg, seq_len)
    hd, nl = cfg.head_dim, cfg.num_layers
    hkv = rank_kv_heads(cfg, rules_lib.ambient_model_parallel())
    if cfg.attn_mode == "head":
        kv_axes = ("layers", "cache_batch", None, "kv_heads", None)
    else:
        kv_axes = ("layers", "cache_batch", "cache_seq", None, None)
    cache = {
        "k": torch.zeros((nl, batch, clen, hkv, hd), dtype=cfg.dtype,
                         device=dev),
        "v": torch.zeros((nl, batch, clen, hkv, hd), dtype=cfg.dtype,
                         device=dev),
        "slot_pos": torch.full((nl, clen), -1, dtype=torch.int32, device=dev),
    }
    axes = {"k": kv_axes, "v": kv_axes, "slot_pos": ("layers", None)}
    if cfg.num_cross_layers:
        # The features' K/V: their length does not grow with seq_len, so
        # the serving plane keeps them in a slot's resident row.
        x_axes = ("layers", "cache_batch", None,
                  "kv_heads" if cfg.num_kv_heads % cfg.tp == 0 else None, None)
        xshape = (cfg.num_cross_layers, batch, cfg.cross_tokens,
                  cfg.num_kv_heads, hd)
        for name in ("xk", "xv"):
            cache[name] = torch.zeros(xshape, dtype=cfg.dtype, device=dev)
            axes[name] = x_axes
    return cache, axes


# ----------------------------------------------------------- attention -----

def _project_qkv(p, x, kv_src, cfg: TransformerConfig):
    dt = cfg.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"].to(dt))
    if cfg.qk_norm and "q_norm" in p:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attend(q, k, v, mask, cfg: TransformerConfig):
    """q: [B,S,H,hd], k/v: [B,K,Hkv,hd], mask: [B or 1, S, K] bool.

    The scores are taken in ``attn_softmax_dtype`` from operands cast up to
    it, which is what JAX's ``preferred_element_type`` does (a product of
    two bf16 numbers is exact in fp32)."""
    b, s, h, hd = q.shape
    n = k.shape[2]                 # kv heads (a rank's, tensor-parallel)
    g = h // n
    sdt = cfg.attn_softmax_dtype
    qg = q.reshape(b, s, n, g, hd)
    scores = torch.einsum("bsngd,bknd->bngsk", qg.to(sdt), k.to(sdt))
    scores = scores / math.sqrt(hd)
    neg = -3e38 if sdt == torch.float32 else -3e4
    scores = scores.masked_fill(~mask[:, None, None, :, :], neg)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    pdt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bngsk,bknd->bsngd", probs.to(pdt), v.to(pdt))
    return out.reshape(b, s, h, hd)


def _attend_chunked(q, k, v, cfg: TransformerConfig):
    """Flash-style online-softmax attention over kv chunks of
    ``cfg.attn_chunk``, carrying (m, l, acc) in fp32; q and kv both start
    at position 0 (train/prefill)."""
    b, s, h, hd = q.shape
    kv_len = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    c = min(cfg.attn_chunk, kv_len)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(b, s, hkv, g, hd).float() * scale
    q_pos = torch.arange(s, device=dev)
    m = torch.full((b, hkv, g, s), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, s), device=dev)
    acc = torch.zeros((b, hkv, g, s, hd), device=dev)
    for c0 in range(0, kv_len, c):
        kb, vb = k[:, c0:c0 + c], v[:, c0:c0 + c]
        k_pos = c0 + torch.arange(kb.shape[1], device=dev)
        scores = torch.einsum("bsngd,bknd->bngsk", qg, kb.float())
        mask = torch.ones((s, kb.shape[1]), dtype=torch.bool, device=dev)
        if cfg.causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if cfg.swa_window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - cfg.swa_window)
        scores = scores.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p_blk = torch.exp(scores - m_new[..., None])
        l = l * alpha + p_blk.sum(dim=-1)
        # probs rounded to the compute dtype, fp32 accumulation
        pv = torch.einsum("bngsk,bknd->bngsd", p_blk.to(cfg.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1).reshape(b, s, h, hd)
    return out.to(cfg.dtype)


def _attend_full(q, k, v, positions, cfg: TransformerConfig):
    """Rotary, then train/prefill attention over the full sequence (causal
    or bidi) -> (out, rotated k)."""
    s = q.shape[1]
    cos, sin = L.rotary(cfg.rope_theta, positions, cfg.head_dim)
    q = L.apply_rotary(q, cos, sin)
    k = L.apply_rotary(k, cos, sin)
    if cfg.attn_impl == "chunked":
        return _attend_chunked(q, k, v, cfg), k
    if not cfg.causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    elif cfg.swa_window:
        mask = L.sliding_window_mask(s, s, 0, cfg.swa_window, q.device)
    else:
        mask = L.causal_mask(s, s, 0, q.device)
    return _attend(q, k, v, mask[None], cfg), k


def _self_attention_full(p, x, positions, cfg: TransformerConfig):
    """Train/prefill attention over the full sequence (causal or bidi);
    tensor-parallel under an ambient model-parallel context."""
    mp = rules_lib.ambient_model_parallel()
    if mp is not None:
        return _self_attention_tp(p, x, positions, cfg, mp)
    q, k, v = _project_qkv(p, x, x, cfg)
    out, k = _attend_full(q, k, v, positions, cfg)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cfg.dtype))
    return y, (k, v)


def _row_parallel(a, w, n: int, mp, dt):
    """A rank-partial product (``a``'s last ``n`` dims with ``w``'s first
    ``n``), summed over the ranks by ``reduce``: the partial sums stay fp32
    and round to ``dt`` once, after the sum, as one process's product (its
    accumulation fp32) rounds once."""
    return mp.reduce(L.contract_f32(a.to(dt), w.to(dt), n)).to(dt)


def _mixed_kv(cfg: TransformerConfig, mp) -> tuple:
    """Mixed mode's kv heads for this rank's q heads: ``(k0, k1, kv_of_q)``,
    the replicated ``wk``/``wv`` heads ``[k0, k1)`` its q heads read and,
    where a group is split between ranks, one kv head a q head (indices
    into ``[k0, k1)``), else None (whole groups: the grouped product)."""
    q0, qn = mp.span(cfg.num_heads)
    g = cfg.q_groups
    k0, k1 = q0 // g, (q0 + qn - 1) // g + 1
    kv_of_q = [(q0 + i) // g - k0 for i in range(qn)]
    n = k1 - k0
    if qn % n == 0 and kv_of_q == [i // (qn // n) for i in range(qn)]:
        kv_of_q = None
    return k0, k1, kv_of_q


def rank_kv_heads(cfg: TransformerConfig, mp) -> int:
    """The kv heads this rank attends with, and so holds in its cache,
    under ``mp`` (all of them without): ``head`` its own, ``mixed`` those
    its q heads read (one a q head where a group is split), ``contraction``
    all (it attends on whole heads)."""
    if mp is None or cfg.attn_mode == "contraction":
        return cfg.num_kv_heads
    if cfg.attn_mode == "head":
        return mp.span(cfg.num_kv_heads)[1]
    k0, k1, kv_of_q = _mixed_kv(cfg, mp)
    return k1 - k0 if kv_of_q is None else len(kv_of_q)


def _project_tp(p, x, cfg: TransformerConfig, mp):
    """q, k, v from this rank's shards of ``p`` (``cfg.attn_mode``'s
    layout; module docstring): its q heads and :func:`rank_kv_heads` kv
    heads, whole heads in contraction mode."""
    dt = cfg.dtype
    xc = mp.copy(x)
    if cfg.attn_mode == "contraction":
        d0, dn = mp.span(cfg.d_model)
        xs = xc[..., d0:d0 + dn]
        q, k, v = (_row_parallel(xs, p[w], 1, mp, dt)
                   for w in ("wq", "wk", "wv"))
        if cfg.qk_norm:
            q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
        return q, k, v
    # head: this rank's q and kv heads; mixed: its q heads and the kv heads
    # they use, from the replicated wk/wv. A replicated leaf read here
    # (mixed wk/wv, the qk norms) gets this rank's part of its gradient,
    # which ``copy`` sums over the ranks.
    shards = {w: mp.copy(p[w]) for w in ("q_norm", "k_norm") if w in p}
    kv_of_q = None
    if cfg.attn_mode == "mixed":
        k0, k1, kv_of_q = _mixed_kv(cfg, mp)
        shards.update({w: mp.copy(p[w])[:, k0:k1] for w in ("wk", "wv")})
    q, k, v = _project_qkv({**p, **shards}, xc, xc, cfg)
    if kv_of_q is not None:
        # A group split between ranks: one kv head a q head.
        idx = torch.tensor(kv_of_q, device=x.device)
        k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v


def _out_tp(out, p, cfg: TransformerConfig, mp):
    """The attention output ``[B, S, H, hd]`` (this rank's q heads; whole
    heads in contraction mode, where its ``head_dim`` slice meets its
    ``wo`` block) through the row-parallel ``wo``."""
    if cfg.attn_mode == "contraction":
        h0, hn = mp.span(cfg.head_dim)
        out = mp.copy(out)[..., h0:h0 + hn]
    return _row_parallel(out, p["wo"], 2, mp, cfg.dtype)


def _self_attention_tp(p, x, positions, cfg: TransformerConfig, mp):
    """Attention on this rank's shards of ``p``. Returns this layer's
    output, whole on every rank, and the k/v it attended with."""
    q, k, v = _project_tp(p, x, cfg, mp)
    out, k = _attend_full(q, k, v, positions, cfg)
    return _out_tp(out, p, cfg, mp), (k, v)


def _self_attention_decode(p, x, cache_k, cache_v, slot_pos, pos: int,
                           cfg: TransformerConfig):
    """One-token decode: x [B,1,d]; ring cache [B,C,Hkv,hd]; ``pos`` the
    absolute position (an int). Returns new copies of the cache rows.
    Tensor-parallel under an ambient model-parallel context: the cache
    holds this rank's kv heads (:func:`rank_kv_heads`)."""
    mp = rules_lib.ambient_model_parallel()
    q, k, v = (_project_qkv(p, x, x, cfg) if mp is None
               else _project_tp(p, x, cfg, mp))
    posv = torch.tensor([pos], device=x.device)
    cos, sin = L.rotary(cfg.rope_theta, posv, cfg.head_dim)
    q = L.apply_rotary(q, cos[None], sin[None])
    k = L.apply_rotary(k, cos[None], sin[None])

    slot = pos % cache_k.shape[1]
    ck, cv, spos = cache_k.clone(), cache_v.clone(), slot_pos.clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    spos[slot] = pos

    valid = (spos >= 0) & (spos <= pos)
    if cfg.swa_window:
        valid = valid & (spos > pos - cfg.swa_window)
    out = _attend(q, ck, cv, valid[None, None, :], cfg)
    if mp is not None:
        return _out_tp(out, p, cfg, mp), (ck, cv, spos)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cfg.dtype))
    return y, (ck, cv, spos)


def _cross_attention(p, x, xk, xv, cfg: TransformerConfig):
    """Cross-attend to precomputed feature K/V ``[B, T, Hkv, hd]``; x
    ``[B, S, d]``. Every query sees every feature token."""
    dt = cfg.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if cfg.qk_norm and "q_norm" in p:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
    mask = torch.ones((1, x.shape[1], xk.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _attend(q, xk, xv, mask, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _cross_kv(p, feats, cfg: TransformerConfig):
    """The features' K/V ``[B, T, Hkv, hd]`` for one cross layer."""
    dt = cfg.dtype
    k = torch.einsum("bsd,dhk->bshk", feats.to(dt), p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", feats.to(dt), p["wv"].to(dt))
    if cfg.qk_norm and "k_norm" in p:
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _cross_decode_apply(h, xp, xk, xv, cfg: TransformerConfig):
    """One cross layer over prefilled feature K/V (decode, and the second
    half of :func:`_cross_body`): the tanh-gated cross-attention residual,
    then a dense SwiGLU FFN residual (dense even in an MoE model)."""
    a_in = L.rms_norm(h, xp["ln1"], cfg.norm_eps)
    x_out = _cross_attention(xp["xattn"], a_in, xk, xv, cfg)
    h = h + torch.tanh(xp["gate"]).to(h.dtype) * x_out
    f_in = L.rms_norm(h, xp["ln2"], cfg.norm_eps)
    return h + _dense_ffn(xp["mlp"], f_in, cfg)


def _cross_body(h, xp, feats, cfg: TransformerConfig):
    """One cross layer over the full sequence -> (h, xk, xv)."""
    xk, xv = _cross_kv(xp["xattn"], feats, cfg)
    return _cross_decode_apply(h, xp, xk, xv, cfg), xk, xv


# --------------------------------------------------------------- ffn -------

def _dense_ffn(p, x, cfg: TransformerConfig):
    """SwiGLU; under an ambient model-parallel context ``w_gate``/``w_up``
    hold this rank's ``mlp`` columns and ``w_down`` its rows."""
    dt = cfg.dtype
    mp = rules_lib.ambient_model_parallel()
    if mp is not None:
        x = mp.copy(x)
    gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    if mp is not None:
        return _row_parallel(L.swiglu(gate, up), p["w_down"], 1, mp, dt)
    return torch.einsum("bsf,fd->bsd", L.swiglu(gate, up), p["w_down"].to(dt))


def _ffn(p_layer, x, cfg: TransformerConfig):
    """-> (y, aux loss): the MoE FFN's load-balance loss, 0 for a dense
    FFN."""
    if cfg.moe is not None:
        return moe_lib.moe_ffn(p_layer["moe"], x, cfg.moe, cfg.dtype)
    return (_dense_ffn(p_layer["mlp"], x, cfg),
            torch.zeros((), device=x.device))


# ----------------------------------------------------------- forward -------

def _layer(params, i: int, stack: str = "layers"):
    """Layer ``i``'s params: index ``i`` of every stacked leaf of
    ``params[stack]``."""
    return tm.tree_map(lambda x: x[i], params[stack])


def _cross_after(cfg: TransformerConfig, i: int) -> Optional[int]:
    """The cross layer that follows self layer ``i``, or None. Self layers
    run in groups of ``cross_attn_period``, each followed by its cross
    layer; the ``num_layers % period`` after the last group are a tail
    (the JAX package's grouped scan, in the same order)."""
    period = cfg.cross_attn_period
    if cfg.num_cross_layers and (i + 1) % period == 0:
        return (i + 1) // period - 1
    return None


def _logits(params, h, cfg: TransformerConfig, fetch=None, mp=None):
    """Masked logits; with ``mp`` (tensor-parallel) this rank's vocab
    columns of them, from its columns of ``head``."""
    fetch = fetch or rules_lib.ambient_fetch()
    h = L.rms_norm(h, fetch(params["final_ln"], "final_ln"), cfg.norm_eps)
    v0, vn = (0, cfg.vocab) if mp is None else mp.span(cfg.vocab)
    if mp is not None:
        h = mp.copy(h)
    logits = torch.einsum("bsd,dv->bsv", h,
                          fetch(params["head"], "head").to(cfg.dtype))
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    vmask = torch.where(
        torch.arange(v0, v0 + vn, device=h.device) < cfg.vocab_real,
        0.0, NEG_INF)
    return logits + vmask.to(logits.dtype)


def _embed(params, tokens, cfg: TransformerConfig, fetch, mp=None):
    """Token embeddings; with ``mp`` this rank's vocab rows give the
    tokens it owns (zero for the rest) and ``reduce`` sums them: one
    nonzero term each, so the result is exact."""
    emb = fetch(params["embed"], "embed").to(cfg.dtype)
    if mp is None:
        return emb[tokens.long()]
    v0, vn = mp.span(cfg.vocab)
    local = tokens.long() - v0
    own = (local >= 0) & (local < vn)
    rows = emb[local.clamp(0, max(vn - 1, 0))]
    return mp.reduce(torch.where(own[..., None], rows, torch.zeros_like(rows)))


def _layer_body(h, lp, positions, cfg: TransformerConfig):
    """One decoder layer over the full sequence -> (h, k, v, aux)."""
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    attn_out, (k, v) = _self_attention_full(lp["attn"], a_in, positions, cfg)
    h = h + attn_out
    f_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    ffn_out, aux = _ffn(lp, f_in, cfg)
    return h + ffn_out, k, v, aux


def forward(params, tokens, cfg: TransformerConfig, cross_feats=None,
            return_cache: bool = False):
    """Full-sequence forward. tokens [B,S] -> (logits [B,S,V], aux loss),
    plus a prefill cache with ``return_cache=True``. ``cross_feats``
    ``[B, cross_tokens, cross_dim]`` feeds the cross layers."""
    b, s = tokens.shape
    # Params are read through the ambient fetch (on a mesh, an FSDP arch's
    # gather of one layer at a time), taken once: a layer recomputed in the
    # backward pass reads through the same one, under the same ambient
    # mesh (the MoE layer's groups).
    fetch, mesh = rules_lib.ambient_fetch(), rules_lib.ambient_mesh()
    mp = rules_lib.ambient_model_parallel()
    h = _embed(params, tokens, cfg, fetch, mp)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    # With remat each layer keeps only its input for the backward pass and
    # runs again there (only while autograd records), its params read again.
    remat = cfg.remat and torch.is_grad_enabled()
    run = lambda body, h: (torch.utils.checkpoint.checkpoint(
        body, h, use_reentrant=False) if remat else body(h))

    def self_layer(h, i):
        with rules_lib.use_mesh(mesh), rules_lib.use_model_parallel(mp):
            lp = fetch(_layer(params, i), "layers")
            return _layer_body(h, lp, positions, cfg)

    def cross_layer(h, g):
        with rules_lib.use_mesh(mesh):
            xp = fetch(_layer(params, g, "cross_layers"), "cross_layers")
            return _cross_body(h, xp, cross_feats, cfg)

    ks, vs, xks, xvs = [], [], [], []
    aux = torch.zeros((), device=tokens.device)
    for i in range(cfg.num_layers):
        h, k, v, layer_aux = run(lambda h, i=i: self_layer(h, i), h)
        aux = aux + layer_aux
        ks.append(k)
        vs.append(v)
        g = _cross_after(cfg, i)
        if g is not None:
            h, xk, xv = run(lambda h, g=g: cross_layer(h, g), h)
            xks.append(xk)
            xvs.append(xv)
    logits = _logits(params, h, cfg, fetch, mp)
    if not return_cache:
        return logits, aux

    # Ring invariant: position p lives in row p % clen (the order decode's
    # eviction follows); perm maps row -> index into the last-clen slice.
    clen = cache_len(cfg, s)
    perm = (torch.arange(clen, device=tokens.device) - (s - clen)) % clen
    last_pos = torch.arange(s - clen, s, device=tokens.device)[perm]
    k_all, v_all = torch.stack(ks), torch.stack(vs)    # [L, B, S, Hkv, hd]
    cache = {
        "k": k_all[:, :, s - clen:][:, :, perm].to(cfg.dtype),
        "v": v_all[:, :, s - clen:][:, :, perm].to(cfg.dtype),
        "slot_pos": last_pos.to(torch.int32)[None].expand(
            cfg.num_layers, clen).contiguous(),
    }
    if xks:                                   # [num_cross, B, T, Hkv, hd]
        cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    return logits, aux, cache


def _given(tree, _name: str):
    """The read of params already fetched."""
    return tree


def decode_step(params, token, cache, pos: int, cfg: TransformerConfig):
    """One-token decode. token [B,1] int; ``pos`` the shared absolute
    position (an int). The cross layers read the prefilled ``xk``/``xv``,
    which pass through unchanged. Returns (logits [B,1,V], new_cache).
    Under an ambient model-parallel context it computes on this rank's
    shards, its cache holds this rank's kv heads and the logits are this
    rank's vocab columns (``forward``'s)."""
    logits, caches = decode_slots(params, [token], [cache], [pos], cfg)
    return logits[0], caches[0]


def decode_slots(params, tokens, caches, positions, cfg: TransformerConfig):
    """:func:`decode_step` over several slots, slot ``j`` its own
    ``tokens[j]`` [B,1], ``caches[j]`` and ``positions[j]`` (an int), each
    param read once through the ambient fetch for all of them: every slot
    steps through a layer before the next layer is read, and a read is
    dropped once its layer has run. Each slot's arithmetic is
    ``decode_step``'s alone, so its logits and cache are bit for bit those
    of a call of its own. Returns ([logits [B,1,V]], [new_cache]), one a
    slot."""
    mp = rules_lib.ambient_model_parallel()
    fetch = rules_lib.ambient_fetch()
    pos = [int(p) for p in positions]
    read = {"embed": fetch(params["embed"], "embed")}
    hs = [_embed(read, token, cfg, _given, mp) for token in tokens]
    del read
    new = [{"k": [], "v": [], "slot_pos": []} for _ in caches]
    for i in range(cfg.num_layers):
        lp = fetch(_layer(params, i), "layers")
        for j, cache in enumerate(caches):
            h = hs[j]
            a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
            attn_out, (ck, cv, spos) = _self_attention_decode(
                lp["attn"], a_in, cache["k"][i], cache["v"][i],
                cache["slot_pos"][i], pos[j], cfg)
            h = h + attn_out
            f_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
            hs[j] = h + _ffn(lp, f_in, cfg)[0]
            for key, x in zip(("k", "v", "slot_pos"), (ck, cv, spos)):
                new[j][key].append(x)
        del lp
        g = _cross_after(cfg, i)
        if g is not None:
            xp = fetch(_layer(params, g, "cross_layers"), "cross_layers")
            for j, cache in enumerate(caches):
                hs[j] = _cross_decode_apply(hs[j], xp, cache["xk"][g],
                                            cache["xv"][g], cfg)
            del xp
    read = {k: fetch(params[k], k) for k in ("final_ln", "head")}
    logits = [_logits(read, h, cfg, _given, mp) for h in hs]
    return logits, [dict(cache, **{k: torch.stack(v) for k, v in n.items()})
                    for cache, n in zip(caches, new)]


def decode_step_paged(params, token, cache, pos, kv, cfg: TransformerConfig):
    """Batched-position decode against the in-place page pool.

    token [S,1] int; pos [S] int (one absolute position per slot, so one
    call serves a whole continuous batch). ``cache`` carries only the
    length-independent leaves: the K/V ring leaves arrive as ``None``
    (their data lives in the page pool behind ``kv``, a
    ``serving.cache.PagedKV``), and a cross model's ``xk``/``xv`` arrive
    slot-stacked from the resident rows, ``[S, num_cross, 1, T, Hkv, hd]``,
    and are handed back unchanged. Each self layer's attention goes through
    ``kv.attend`` (the CUDA page-table kernel, or its plain version on the
    CPU; both take the softmax in fp32, as the Pallas kernel does, whatever
    ``attn_softmax_dtype`` says). Returns (logits [S,1,V], the one-token
    cache update: k/v ``[S, L, 1, 1, Hkv, hd]`` and slot_pos ``[S, L, 1]``,
    ready for the serve step's single-row page scatter). Tensor-parallel
    under an ambient model-parallel context, as :func:`decode_step`: the
    kernel then runs on this rank's q heads against the kv heads its pool
    holds."""
    s = token.shape[0]
    mp = rules_lib.ambient_model_parallel()
    fetch = rules_lib.ambient_fetch()
    h = _embed(params, token, cfg, fetch, mp)
    cos, sin = L.rotary(cfg.rope_theta, pos, cfg.head_dim)   # [S, hd/2]
    cos, sin = cos[:, None], sin[:, None]                    # [S, 1, hd/2]
    window = cfg.swa_window or 0
    if cfg.num_cross_layers:                  # -> [num_cross, S, T, ...]
        xk_s = torch.movedim(cache["xk"], 0, 1)[:, :, 0]
        xv_s = torch.movedim(cache["xv"], 0, 1)[:, :, 0]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = fetch(_layer(params, i), "layers")
        a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = (_project_qkv(lp["attn"], a_in, a_in, cfg) if mp is None
                   else _project_tp(lp["attn"], a_in, cfg, mp))
        q = L.apply_rotary(q, cos, sin)
        k = L.apply_rotary(k, cos, sin)
        kc = k[:, 0].to(cfg.dtype)                            # [S, Hkv, hd]
        vc = v[:, 0].to(cfg.dtype)
        out = kv.attend(i, q[:, 0], kc, vc, window=window)[:, None]
        h = h + (torch.einsum("bshk,hkd->bsd", out,
                              lp["attn"]["wo"].to(cfg.dtype)) if mp is None
                 else _out_tp(out, lp["attn"], cfg, mp))
        f_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + _ffn(lp, f_in, cfg)[0]
        del lp
        ks.append(kc)
        vs.append(vc)
        g = _cross_after(cfg, i)
        if g is not None:
            h = _cross_decode_apply(
                h, fetch(_layer(params, g, "cross_layers"), "cross_layers"),
                xk_s[g], xv_s[g], cfg)
    new_cache = {
        "k": torch.stack(ks, dim=1)[:, :, None, None],
        "v": torch.stack(vs, dim=1)[:, :, None, None],
        "slot_pos": pos.to(torch.int32)[:, None, None].expand(
            s, cfg.num_layers, 1).contiguous(),
    }
    if cfg.num_cross_layers:
        new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
    return _logits(params, h, cfg, fetch, mp), new_cache


# --------------------------------------------------------------- loss ------

def sharded_ce(logits: torch.Tensor, targets: torch.Tensor, mp=None,
               offset: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy, written as the JAX package writes it
    (a max-shifted logsumexp and a masked pick of the target logit). With
    ``mp`` the logits are this rank's vocab columns from ``offset`` on: the
    max (detached) is taken over the ranks, and the sum of ``exp`` and the
    picked logit are each summed over them (``reduce``)."""
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True).detach()
    if mp is not None:
        m = mp.max(m)
    sum_exp = torch.sum(torch.exp(logits32 - m), dim=-1)
    iota = torch.arange(offset, offset + logits.shape[-1],
                        device=logits.device)
    picked = torch.sum(torch.where(iota == targets[..., None], logits32,
                                   torch.zeros_like(logits32)), dim=-1)
    if mp is not None:
        sum_exp, picked = mp.reduce(sum_exp), mp.reduce(picked)
    lse = torch.log(sum_exp) + m[..., 0]
    return (lse - picked).mean()


def loss_fn(params, batch, cfg: TransformerConfig):
    """Next-token CE. batch: {"tokens": [B, S+1], optional
    "cross_feats"}."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg,
                          cross_feats=batch.get("cross_feats"))
    mp = rules_lib.ambient_model_parallel()
    offset = 0 if mp is None else mp.span(cfg.vocab)[0]
    return sharded_ce(logits, targets, mp, offset) + aux
