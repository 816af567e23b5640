"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) blocks and a pure-SSM
LM (port of ``repro/models/ssm.py``).

The selective state-space recurrence per head (state size N, head dim P):

    h_t = a_t * h_{t-1} + dt_t * B_t x_t^T        (h: [N, P])
    y_t = C_t^T h_t + D * x_t                      (a_t = exp(dt_t * A))

Training and prefill use the chunked SSD algorithm: within a chunk of
length Q the recurrence is a masked, decay-weighted quadratic form (batched
matmuls over ``[B, NC, H, Q, Q]``); across chunks a loop carries the fp32
``[B, H, N, P]`` state. A single token (T = 1, the serve decode) runs the
recurrence itself, which is the chunked algorithm's value at one token
without the padding to a whole chunk.

The parameter and cache trees keep the JAX package's names and layout
(layer params stacked ``[L, ...]`` under ``params["layers"]``), so
``convert.params_from_jax`` carries weights across unchanged.

One deliberate difference: the intra-chunk decay ``exp(cum_i - cum_j)``
is masked to ``-inf`` above the diagonal *before* the exponential. The JAX
module masks after it (``jnp.where(tri, jnp.exp(diff), 0.0)``); there
``diff`` is positive and, at 64 heads and chunk 256, overflows to ``inf``,
which the forward pass masks away but the backward pass multiplies by the
zero cotangent (``0 * inf = nan``). The forward values are the same; the
port's gradient is the finite one (``tests/test_torch_ssm.py`` pins both).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SSMSettings:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba_block(gen: torch.Generator, cfg: SSMSettings,
                     param_dtype=torch.float32, device=None,
                     lead: Tuple[int, ...] = ()) -> Any:
    """One block's ``Param`` tree; ``lead`` prepends stacked axes (e.g.
    ``[L]`` layers, each slice drawn independently)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.num_heads
    w = cfg.conv_width
    lead = tuple(lead)
    dense = lambda shape, axes: L.dense_init(gen, shape, axes,
                                             dtype=param_dtype, device=device,
                                             lead=lead)
    # dt bias init so softplus(bias) spans [dt_min, dt_max] (mamba convention)
    u = L._fill(torch.empty(lead + (h,), device=device),
                lambda t: t.uniform_(generator=gen))
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))      # inverse softplus
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=device)).expand(lead + (h,))
    conv_x = L._fill(torch.empty(lead + (w, di), device=device),
                     lambda t: t.normal_(generator=gen).div_(math.sqrt(w)))
    zeros = lambda shape: torch.zeros(lead + shape, dtype=param_dtype,
                                      device=device)
    return {
        "w_z": dense((d, di), ("embed", "ssm_inner")),
        "w_x": dense((d, di), ("embed", "ssm_inner")),
        "w_b": dense((d, n), ("embed", "state")),
        "w_c": dense((d, n), ("embed", "state")),
        "w_dt": dense((d, h), ("embed", "ssm_heads")),
        "dt_bias": L.Param(dt_bias.to(param_dtype), ("ssm_heads",)),
        "a_log": L.Param(a_log.to(param_dtype).contiguous(), ("ssm_heads",)),
        "d_skip": L.Param(torch.ones(lead + (h,), dtype=param_dtype,
                                     device=device), ("ssm_heads",)),
        "conv_x": L.Param(conv_x.to(param_dtype), ("conv", "ssm_inner")),
        "conv_b": L.Param(zeros((w, n)), ("conv", "state")),
        "conv_c": L.Param(zeros((w, n)), ("conv", "state")),
        "norm": L.scale_init(lead + (di,), ("ssm_inner",), dtype=param_dtype,
                             device=device),
        "w_out": dense((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x [B,T,C], w [W,C]; ``tail`` [B,W-1,C] is the
    pre-conv context from a previous segment (decode). Sums the taps in
    order. Returns (y [B,T,C], new_tail [B,W-1,C])."""
    width, t = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                      # [B, T+W-1, C]
    y = xp[:, 0:t] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + t] * w[i]
    return y, xp[:, xp.shape[1] - (width - 1):]


def _identity_tap(width: int, channels: int, dtype, device) -> torch.Tensor:
    """conv_b/conv_c start as identity (last tap = 1) so an untrained conv
    passes B/C through, as mamba2's conv init on B/C does."""
    tap = torch.zeros((width, channels), dtype=dtype, device=device)
    tap[width - 1] = 1.0
    return tap


def _ssd_step(xh, a_log_dt, dt, bmat, cmat, h0=None):
    """One token of the recurrence (T = 1): the shapes of ``_ssd_chunked``.
    h = exp(dt A) h0 + dt B x^T, y = C^T h, in fp32."""
    x = xh[:, 0].float()                                  # [B, H, P]
    a = torch.exp(a_log_dt[:, 0].float())                 # [B, H]
    d = dt[:, 0].float()
    bm, cm = bmat[:, 0].float(), cmat[:, 0].float()       # [B, N]
    inject = (d[:, :, None, None] * bm[:, None, :, None]) * x[:, :, None, :]
    if h0 is None:
        hn = inject
    else:
        hn = a[:, :, None, None] * h0.float() + inject    # [B, H, N, P]
    y = torch.matmul(cm[:, None, None, :], hn)             # [B, H, 1, P]
    return y.transpose(1, 2), hn


def _ssd_chunked(xh, a_log_dt, dt, bmat, cmat, cfg: SSMSettings, h0=None):
    """Chunked SSD scan.

    xh:       [B, T, H, P]   per-head inputs (post conv/activation)
    a_log_dt: [B, T, H]      log a_t = dt_t * A  (negative)
    dt:       [B, T, H]
    bmat/cmat:[B, T, N]
    h0:       [B, H, N, P]   initial state (None = zeros)
    Returns (y [B,T,H,P], h_final [B,H,N,P]), fp32. The intra-chunk tensors
    are laid out [B, NC, H, Qi, Qj] so both contractions are batched
    matmuls."""
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    q = cfg.chunk
    pad = (-t) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a_log_dt = F.pad(a_log_dt, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    tt = t + pad
    nc = tt // q

    xh = xh.reshape(b, nc, q, h, p).float()
    la = a_log_dt.reshape(b, nc, q, h).float()
    dt = dt.reshape(b, nc, q, h).float()
    bm = bmat.reshape(b, nc, q, n).float()
    cm = cmat.reshape(b, nc, q, n).float()

    cum = torch.cumsum(la, dim=2)                          # [B,NC,Q,H]
    cum_h = cum.transpose(2, 3)                            # [B,NC,H,Q]
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, masked before the
    # exponential (above the diagonal cum_i - cum_j > 0 can overflow)
    diff = cum_h[..., :, None] - cum_h[..., None, :]       # [B,NC,H,Qi,Qj]
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = diff.masked_fill(~tri, float("-inf")).exp()
    scores = torch.einsum("bcin,bcjn->bcij", cm, bm)       # [B,NC,Qi,Qj]
    m = scores[:, :, None] * decay * dt.transpose(2, 3)[:, :, :, None, :]
    xh_h = xh.permute(0, 1, 3, 2, 4)                       # [B,NC,H,Q,P]
    y_intra = torch.matmul(m, xh_h)                        # [B,NC,H,Qi,P]

    # chunk summaries
    tail_decay = torch.exp(cum[:, :, -1:, :] - cum)        # [B,NC,Q,H]
    s_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchnp", dt * tail_decay, bm, xh)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [B,NC,H]

    hprev = (torch.zeros((b, h, n, p), device=xh.device) if h0 is None
             else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,NC,H,N,P]

    inter_decay = torch.exp(cum)                           # [B,NC,Q,H]
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cm, h_prevs) * \
        inter_decay[..., None]

    y = (y_intra.permute(0, 1, 3, 2, 4) + y_inter).reshape(b, tt, h, p)
    return y[:, :t], hprev


def mamba_forward(p: Any, x: torch.Tensor, cfg: SSMSettings,
                  dtype=torch.float32, cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """Full-segment forward. x [B,T,d] -> (y [B,T,d], new_cache).
    ``cache`` carries {conv_x, conv_b, conv_c, h} across segments/decode; a
    single token (T = 1) runs the recurrence (``_ssd_step``)."""
    b, t, _ = x.shape
    h, pdim, n = cfg.num_heads, cfg.head_dim, cfg.d_state
    z = x @ p["w_z"].to(dtype)                             # [B,T,di]
    xi = x @ p["w_x"].to(dtype)
    bm = x @ p["w_b"].to(dtype)                            # [B,T,N]
    cm = x @ p["w_c"].to(dtype)
    dt_raw = x @ p["w_dt"].to(dtype)                       # [B,T,H]

    tails = cache or {}
    tap = _identity_tap(cfg.conv_width, n, dtype, x.device)
    xi, tail_x = _causal_conv(xi, p["conv_x"].to(dtype), tails.get("conv_x"))
    bm, tail_b = _causal_conv(bm, p["conv_b"].to(dtype) + tap,
                              tails.get("conv_b"))
    cm, tail_c = _causal_conv(cm, p["conv_c"].to(dtype) + tap,
                              tails.get("conv_c"))
    xi = F.silu(xi)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                     # [H] negative
    a_log_dt = dt * a

    xh = xi.reshape(b, t, h, pdim)
    if t == 1:
        y, h_final = _ssd_step(xh, a_log_dt, dt, bm, cm, tails.get("h"))
    else:
        y, h_final = _ssd_chunked(xh, a_log_dt, dt, bm, cm, cfg,
                                  h0=tails.get("h"))
    y = y + xh.float() * p["d_skip"].float()[:, None]
    y = y.reshape(b, t, cfg.d_inner).to(dtype)

    y = y * F.silu(z)
    y = L.rms_norm(y, p["norm"])
    out = y @ p["w_out"].to(dtype)
    new_cache = {"conv_x": tail_x, "conv_b": tail_b, "conv_c": tail_c,
                 "h": h_final.float()}
    return out, new_cache


def mamba_cache_init(cfg: SSMSettings, batch: int, dtype=torch.float32,
                     device=None, lead: Tuple[int, ...] = ()):
    """Zero conv tails (``dtype``) and fp32 state; ``lead`` prepends stacked
    axes. Returns (cache, axes)."""
    w = cfg.conv_width - 1
    lead = tuple(lead)
    zeros = lambda shape, dt: torch.zeros(lead + shape, dtype=dt,
                                          device=device)
    cache = {
        "conv_x": zeros((batch, w, cfg.d_inner), dtype),
        "conv_b": zeros((batch, w, cfg.d_state), dtype),
        "conv_c": zeros((batch, w, cfg.d_state), dtype),
        "h": zeros((batch, cfg.num_heads, cfg.d_state, cfg.head_dim),
                   torch.float32),
    }
    axes = {
        "conv_x": ("cache_batch", None, "ssm_inner"),
        "conv_b": ("cache_batch", None, None),
        "conv_c": ("cache_batch", None, None),
        "h": ("cache_batch", "ssm_heads", None, None),
    }
    return cache, axes


def mamba_decode(p: Any, x: torch.Tensor, cache: dict, cfg: SSMSettings,
                 dtype=torch.float32) -> Tuple[torch.Tensor, dict]:
    """Single-token decode via the O(1) recurrence. x [B,1,d]."""
    return mamba_forward(p, x, cfg, dtype=dtype, cache=cache)


# ------------------------------------------------------ pure-SSM LM --------

@dataclasses.dataclass(frozen=True)
class MambaLMConfig:
    name: str
    num_layers: int
    d_model: int
    vocab: int
    vocab_real: int
    ssm: SSMSettings = None  # type: ignore
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    norm_eps: float = 1e-6
    remat: bool = True


def init_mamba_layers(gen, d_model: int, ssm: SSMSettings, num_layers: int,
                      param_dtype, dev):
    """``num_layers`` stacked ``{"ln", "mamba"}`` layers -> (values, axes)
    with the ``"layers"`` axis first."""
    block = {"ln": L.scale_init((num_layers, d_model), ("embed",),
                                dtype=param_dtype, device=dev),
             "mamba": init_mamba_block(gen, ssm, param_dtype, device=dev,
                                       lead=(num_layers,))}
    values, axes = L.unzip(block)
    return values, L.stacked_axes(axes)


def lm_init(key, cfg: MambaLMConfig, device=None):
    """Returns (params, axes). ``key`` is an int seed or a
    ``torch.Generator``; on ``device`` (CUDA unless ``device="cpu"``;
    ``"meta"`` makes shapes only). The draws differ from ``jax.random``'s;
    carry JAX's weights over with ``convert.params_from_jax``."""
    dev = device_lib.resolve(device)
    gen = device_lib.init_generator(key, dev)
    pdt = cfg.param_dtype
    emb = L.embed_init(gen, (cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       dtype=pdt, device=dev)
    head = L.dense_init(gen, (cfg.d_model, cfg.vocab), ("embed", "vocab"),
                        dtype=pdt, device=dev)
    final_ln = L.scale_init((cfg.d_model,), ("embed",), dtype=pdt, device=dev)
    values, layer_axes = init_mamba_layers(gen, cfg.d_model, cfg.ssm,
                                           cfg.num_layers, pdt, dev)
    params = {"embed": emb.value, "head": head.value,
              "final_ln": final_ln.value, "layers": values}
    axes = {"embed": emb.axes, "head": head.axes, "final_ln": final_ln.axes,
            "layers": layer_axes}
    return params, axes


def mamba_layer(h, layer_p, ssm: SSMSettings, dtype, eps: float,
                cache=None, remat: bool = False):
    """One residual ``{"ln", "mamba"}`` layer -> (h, new_cache); with
    ``remat`` (and autograd recording) its activations are recomputed in
    the backward pass."""
    def run(h):
        norm = L.rms_norm(h, layer_p["ln"], eps)
        y, new_c = mamba_forward(layer_p["mamba"], norm, ssm, dtype=dtype,
                                 cache=cache)
        return h + y, new_c

    if remat and cache is None and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False)
    return run(h)


def lm_forward(params, tokens, cfg: MambaLMConfig, cache=None,
               return_cache: bool = False):
    """tokens [B,T] -> logits [B,T,V], plus the new cache with a ``cache``
    or ``return_cache=True``."""
    hdn = params["embed"].to(cfg.dtype)[tokens.long()]
    had_cache = cache is not None
    new = []
    for i in range(cfg.num_layers):
        layer_p = tm.tree_index(params["layers"], i)
        layer_c = tm.tree_index(cache, i) if had_cache else None
        hdn, new_c = mamba_layer(hdn, layer_p, cfg.ssm, cfg.dtype,
                                 cfg.norm_eps, cache=layer_c,
                                 remat=cfg.remat)
        if return_cache or had_cache:
            new.append(new_c)
    hdn = L.rms_norm(hdn, params["final_ln"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", hdn, params["head"].to(cfg.dtype))
    vmask = torch.where(torch.arange(cfg.vocab, device=hdn.device)
                        < cfg.vocab_real, 0.0, -1e9)
    logits = logits + vmask.to(logits.dtype)
    if return_cache or had_cache:
        return logits, tm.tree_stack(new)
    return logits


def lm_cache_init(cfg: MambaLMConfig, batch: int, device=None):
    """Every layer's zero cache, stacked ``[L, ...]``. Returns (cache,
    axes)."""
    dev = device_lib.resolve(device)
    cache, axes = mamba_cache_init(cfg.ssm, batch, cfg.dtype, device=dev,
                                   lead=(cfg.num_layers,))
    return cache, L.stacked_axes(axes)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL: log-softmax in fp32, the target's entry."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def lm_loss(params, batch, cfg: MambaLMConfig):
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    return token_nll(lm_forward(params, inputs, cfg), targets)
