"""Whisper-style encoder-decoder backbone (arXiv:2212.04356; port of
``repro/models/encdec.py``).

The mel-spectrogram + conv feature extractor is a stub, as in the JAX
package: the model consumes precomputed frame embeddings
``[B, num_frames, d_model]``. The encoder is a bidirectional transformer
(the transformer's ``_layer_body`` with ``causal=False``, RoPE over frame
positions); the decoder is a causal transformer with cross-attention to the
encoder output after EVERY layer (``cross_attn_period=1``). RoPE/RMSNorm
replace Whisper's learned positions/LayerNorm, as in the JAX package. The
parameter tree is ``{"encoder": ..., "decoder": ...}`` with JAX's keys
(the encoder has no ``embed``/``head``), so ``convert.params_from_jax``
carries weights across unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import device as device_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as tr


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    num_layers: int           # per stack (encoder and decoder each)
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_real: int
    num_frames: int = 1500    # encoder sequence length (audio frames)
    tp: int = 16
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    remat: bool = True

    def _stack_cfg(self, suffix: str, **kw) -> tr.TransformerConfig:
        return tr.TransformerConfig(
            name=self.name + suffix, num_layers=self.num_layers,
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            d_ff=self.d_ff, vocab=self.vocab, vocab_real=self.vocab_real,
            tp=self.tp, dtype=self.dtype, param_dtype=self.param_dtype,
            norm_eps=self.norm_eps, remat=self.remat, **kw)

    def encoder_cfg(self) -> tr.TransformerConfig:
        return self._stack_cfg("-enc", causal=False)

    def decoder_cfg(self) -> tr.TransformerConfig:
        return self._stack_cfg("-dec", causal=True, cross_attn_period=1,
                               cross_tokens=self.num_frames,
                               cross_dim=self.d_model)


def init(key, cfg: EncDecConfig, device=None) -> Tuple[Any, Any]:
    """Returns (params, axes). ``key`` is an int seed or a
    ``torch.Generator``; on ``device`` (CUDA unless ``device="cpu"``;
    ``"meta"`` makes shapes only)."""
    dev = device_lib.resolve(device)
    gen = device_lib.init_generator(key, dev)
    enc_params, enc_axes = tr.init(gen, cfg.encoder_cfg(), device=dev)
    dec_params, dec_axes = tr.init(gen, cfg.decoder_cfg(), device=dev)
    # The encoder consumes frame embeddings, not tokens: drop its embed/head.
    for tree in (enc_params, enc_axes):
        del tree["embed"], tree["head"]
    return ({"encoder": enc_params, "decoder": dec_params},
            {"encoder": enc_axes, "decoder": dec_axes})


def encode(params, frames, cfg: EncDecConfig) -> torch.Tensor:
    """frames [B, num_frames, d_model] -> encoder states (bidirectional)."""
    ecfg = cfg.encoder_cfg()
    enc = params["encoder"]
    b, s, _ = frames.shape
    h = frames.to(ecfg.dtype)
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    remat = ecfg.remat and torch.is_grad_enabled()
    for i in range(ecfg.num_layers):
        lp = tr._layer(enc, i)
        body = lambda h, lp=lp: tr._layer_body(h, lp, positions, ecfg)[0]
        h = (torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
             if remat else body(h))
    return L.rms_norm(h, enc["final_ln"], ecfg.norm_eps)


def forward(params, tokens, frames, cfg: EncDecConfig,
            return_cache: bool = False):
    """Teacher-forced decode over the full target sequence."""
    enc_states = encode(params, frames, cfg)
    return tr.forward(params["decoder"], tokens, cfg.decoder_cfg(),
                      cross_feats=enc_states, return_cache=return_cache)


def init_cache(cfg: EncDecConfig, batch: int, seq_len: int, device=None):
    return tr.init_cache(cfg.decoder_cfg(), batch, seq_len, device=device)


def decode_step(params, token, cache, pos, cfg: EncDecConfig):
    """One decoder token; the encoder states live in the cross cache."""
    return tr.decode_step(params["decoder"], token, cache, pos,
                          cfg.decoder_cfg())


def decode_step_paged(params, token, cache, pos, kv, cfg: EncDecConfig):
    """Paged decode: self-attention K/V read in place from the page pool;
    the prefilled cross K/V ride in the resident cache leaves."""
    return tr.decode_step_paged(params["decoder"], token, cache, pos, kv,
                                cfg.decoder_cfg())


def loss_fn(params, batch, cfg: EncDecConfig):
    """batch: {"tokens": [B, S+1], "frames": [B, num_frames, d_model]}."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(params, inputs, batch["frames"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean() + aux
