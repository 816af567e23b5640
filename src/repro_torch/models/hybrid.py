"""Zamba2-style hybrid LM (arXiv:2411.15242; port of
``repro/models/hybrid.py``): a Mamba2 backbone with ONE shared
attention+MLP block applied after every ``shared_period`` mamba layers
(weights shared across invocations; each invocation keeps its own KV ring).

The JAX package's simplification is kept: one shared block (Zamba2 has two
alternating ones with per-invocation LoRA deltas) and a plain residual.
Mamba layers after the last full group (``num_layers % shared_period`` of
them) run last, with no shared block after them. The parameter and cache
trees keep the JAX names and layout, so ``convert.params_from_jax`` carries
weights across unchanged; the shared block reuses the transformer's
attention (``transformer._self_attention_full`` / ``_decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tr


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    num_layers: int            # mamba layers
    d_model: int
    vocab: int
    vocab_real: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int                  # shared block MLP width
    shared_period: int = 6
    ssm: ssm_lib.SSMSettings = None  # type: ignore
    swa_window: Optional[int] = None  # windowed shared attention (long ctx)
    rope_theta: float = 10000.0
    tp: int = 16
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    remat: bool = True

    @property
    def num_invocations(self) -> int:
        return self.num_layers // self.shared_period

    def attn_cfg(self) -> tr.TransformerConfig:
        """A TransformerConfig view of the shared block, so the
        transformer's attention code is reused as it is."""
        return tr.TransformerConfig(
            name=self.name + "-shared", num_layers=1, d_model=self.d_model,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, d_ff=self.d_ff, vocab=self.vocab,
            vocab_real=self.vocab_real, swa_window=self.swa_window,
            rope_theta=self.rope_theta, tp=self.tp, dtype=self.dtype,
            param_dtype=self.param_dtype, norm_eps=self.norm_eps, remat=False)


def init(key, cfg: HybridConfig, device=None) -> Tuple[Any, Any]:
    """Returns (params, axes). ``key`` is an int seed or a
    ``torch.Generator``; on ``device`` (CUDA unless ``device="cpu"``;
    ``"meta"`` makes shapes only)."""
    dev = device_lib.resolve(device)
    gen = device_lib.init_generator(key, dev)
    acfg = cfg.attn_cfg()
    pdt = cfg.param_dtype
    emb = L.embed_init(gen, (cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       dtype=pdt, device=dev)
    head = L.dense_init(gen, (cfg.d_model, cfg.vocab), ("embed", "vocab"),
                        dtype=pdt, device=dev)
    final_ln = L.scale_init((cfg.d_model,), ("embed",), dtype=pdt, device=dev)
    mamba_values, mamba_axes = ssm_lib.init_mamba_layers(
        gen, cfg.d_model, cfg.ssm, cfg.num_layers, pdt, dev)
    shared = {
        "ln1": L.scale_init((cfg.d_model,), ("embed",), dtype=pdt,
                            device=dev),
        "attn": tr._init_attention(gen, acfg, dev),
        "ln2": L.scale_init((cfg.d_model,), ("embed",), dtype=pdt,
                            device=dev),
        "mlp": tr._init_dense_ffn(gen, acfg, dev),
    }
    shared_values, shared_axes = L.unzip(shared)
    params = {"embed": emb.value, "head": head.value,
              "final_ln": final_ln.value, "mamba_layers": mamba_values,
              "shared": shared_values}
    axes = {"embed": emb.axes, "head": head.axes, "final_ln": final_ln.axes,
            "mamba_layers": mamba_axes, "shared": shared_axes}
    return params, axes


def init_cache(cfg: HybridConfig, batch: int, seq_len: int, device=None):
    """Every mamba layer's zero cache (stacked ``[L, ...]``) and one empty
    KV ring per shared-block invocation. Returns (cache, axes)."""
    dev = device_lib.resolve(device)
    acfg = cfg.attn_cfg()
    clen = tr.cache_len(acfg, seq_len)
    ninv, hkv, hd = cfg.num_invocations, cfg.num_kv_heads, cfg.head_dim
    mcache, maxes = ssm_lib.mamba_cache_init(cfg.ssm, batch, cfg.dtype,
                                             device=dev,
                                             lead=(cfg.num_layers,))
    if acfg.attn_mode == "head":
        kv_axes = ("layers", "cache_batch", None, "kv_heads", None)
    else:
        kv_axes = ("layers", "cache_batch", "cache_seq", None, None)
    cache = {
        "mamba": mcache,
        "attn_k": torch.zeros((ninv, batch, clen, hkv, hd), dtype=cfg.dtype,
                              device=dev),
        "attn_v": torch.zeros((ninv, batch, clen, hkv, hd), dtype=cfg.dtype,
                              device=dev),
        "attn_slot_pos": torch.full((ninv, clen), -1, dtype=torch.int32,
                                    device=dev),
    }
    axes = {"mamba": L.stacked_axes(maxes), "attn_k": kv_axes,
            "attn_v": kv_axes, "attn_slot_pos": ("layers", None)}
    return cache, axes


def _shared_mlp(shared, h, acfg):
    f_in = L.rms_norm(h, shared["ln2"], acfg.norm_eps)
    mlp = shared["mlp"]
    gate = torch.einsum("bsd,df->bsf", f_in, mlp["w_gate"].to(acfg.dtype))
    up = torch.einsum("bsd,df->bsf", f_in, mlp["w_up"].to(acfg.dtype))
    y = torch.einsum("bsf,fd->bsd", L.swiglu(gate, up),
                     mlp["w_down"].to(acfg.dtype))
    return h + y


def _shared_block_full(shared, h, positions, acfg):
    a_in = L.rms_norm(h, shared["ln1"], acfg.norm_eps)
    attn_out, (k, v) = tr._self_attention_full(shared["attn"], a_in,
                                               positions, acfg)
    return _shared_mlp(shared, h + attn_out, acfg), k, v


def forward(params, tokens, cfg: HybridConfig, return_cache: bool = False):
    """Full-sequence forward -> (logits, aux=0[, cache])."""
    b, s = tokens.shape
    acfg = cfg.attn_cfg()
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    period, ninv = cfg.shared_period, cfg.num_invocations
    remat = cfg.remat and torch.is_grad_enabled()
    mcaches, ks, vs = [], [], []

    def mamba(h, i):
        layer_p = tm.tree_index(params["mamba_layers"], i)
        h, mc = ssm_lib.mamba_layer(h, layer_p, cfg.ssm, cfg.dtype,
                                    cfg.norm_eps, remat=cfg.remat)
        if return_cache:
            mcaches.append(mc)
        return h

    # ``period`` mamba layers, then the shared block; then the tail layers.
    for g in range(ninv):
        for i in range(g * period, (g + 1) * period):
            h = mamba(h, i)
        run_attn = lambda h: _shared_block_full(params["shared"], h,
                                                positions, acfg)
        if remat:
            h, k, v = torch.utils.checkpoint.checkpoint(run_attn, h,
                                                        use_reentrant=False)
        else:
            h, k, v = run_attn(h)
        if return_cache:
            ks.append(k)
            vs.append(v)
    for i in range(ninv * period, cfg.num_layers):
        h = mamba(h, i)

    logits = tr._logits(params, h, acfg)
    aux = torch.zeros((), device=tokens.device)
    if not return_cache:
        return logits, aux

    # Ring invariant: position p lives in row p % clen; perm maps row ->
    # index into the last-clen slice.
    clen = tr.cache_len(acfg, s)
    perm = (torch.arange(clen, device=tokens.device) - (s - clen)) % clen
    last_pos = torch.arange(s - clen, s, device=tokens.device)[perm]
    slot = lambda kv: torch.stack([x[:, s - clen:][:, perm].to(cfg.dtype)
                                   for x in kv])
    cache = {
        "mamba": tm.tree_stack(mcaches),
        "attn_k": slot(ks),
        "attn_v": slot(vs),
        "attn_slot_pos": last_pos.to(torch.int32)[None].expand(
            ninv, clen).contiguous(),
    }
    return logits, aux, cache


def decode_step(params, token, cache, pos: int, cfg: HybridConfig):
    """One-token decode. token [B,1] int; ``pos`` the shared absolute
    position (an int). Returns (logits [B,1,V], new_cache)."""
    acfg = cfg.attn_cfg()
    pos = int(pos)
    h = params["embed"].to(cfg.dtype)[token.long()]
    period, ninv = cfg.shared_period, cfg.num_invocations
    new_mc, nk, nv, nspos = [], [], [], []

    def mamba(h, i):
        h, mc = ssm_lib.mamba_layer(
            h, tm.tree_index(params["mamba_layers"], i), cfg.ssm, cfg.dtype,
            cfg.norm_eps, cache=tm.tree_index(cache["mamba"], i))
        new_mc.append(mc)
        return h

    shared = params["shared"]
    for g in range(ninv):
        for i in range(g * period, (g + 1) * period):
            h = mamba(h, i)
        a_in = L.rms_norm(h, shared["ln1"], cfg.norm_eps)
        attn_out, (ck, cv, spos) = tr._self_attention_decode(
            shared["attn"], a_in, cache["attn_k"][g], cache["attn_v"][g],
            cache["attn_slot_pos"][g], pos, acfg)
        h = _shared_mlp(shared, h + attn_out, acfg)
        nk.append(ck)
        nv.append(cv)
        nspos.append(spos)
    for i in range(ninv * period, cfg.num_layers):
        h = mamba(h, i)

    new_cache = {"mamba": tm.tree_stack(new_mc), "attn_k": torch.stack(nk),
                 "attn_v": torch.stack(nv),
                 "attn_slot_pos": torch.stack(nspos)}
    return tr._logits(params, h, acfg), new_cache


def loss_fn(params, batch, cfg: HybridConfig):
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, cfg)
    return ssm_lib.token_nll(logits, targets) + aux
