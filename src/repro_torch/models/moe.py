"""Mixture-of-experts FFN (port of ``repro/models/moe.py``), one device.

Sort-based dispatch with a fixed capacity (GShard-style dropping): each
(token, choice) entry is ranked within its expert by a stable sort, entries
ranked past the capacity go to one overflow slot whose row is dropped, the
experts run as one batched matmul over ``[E, cap, d]`` buffers, and the
outputs are gathered back and weighted.

The JAX package splits tokens into data-parallel groups when a mesh is
ambient; on one device there is none, so there is one group and no sharding
constraint. The grouped, expert-sharded path waits for multi-GPU placement
(ROADMAP A.12).

Routed-expert counts are padded (dead experts: router logits forced to
``NEG_INF``, so they are never selected).

Ties follow the JAX package: ``jax.lax.top_k`` keeps the lower expert index
among equal probabilities, and ``jnp.argsort`` is stable, so both are
stable sorts here.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models import layers as L

NEG_INF = -1e9


def init_moe(gen: torch.Generator, d_model: int, moe, param_dtype,
             device=None, lead: Tuple[int, ...] = ()) -> Any:
    """The MoE leaves of one layer (``lead`` prepends stacked axes), as
    ``Param``s: router ``[d, E]`` (fp32: router math stays fp32), expert
    weights ``[E, d, f]`` / ``[E, f, d]``, and the fused shared expert
    when ``moe.shared_d_ff``."""
    e, f = moe.num_experts, moe.d_ff
    dense = lambda shape, axes, **kw: L.dense_init(
        gen, shape, axes, device=device, lead=lead, **kw)
    p = {
        "router": dense((d_model, e), ("embed", "experts"),
                        dtype=torch.float32),
        "w_gate": dense((e, d_model, f), ("experts", "embed", "expert_mlp"),
                        in_axis=1, dtype=param_dtype),
        "w_up": dense((e, d_model, f), ("experts", "embed", "expert_mlp"),
                      in_axis=1, dtype=param_dtype),
        "w_down": dense((e, f, d_model), ("experts", "expert_mlp", "embed"),
                        in_axis=1, dtype=param_dtype),
    }
    if moe.shared_d_ff:
        fs = moe.shared_d_ff
        p["shared"] = {
            "w_gate": dense((d_model, fs), ("embed", "mlp"), dtype=param_dtype),
            "w_up": dense((d_model, fs), ("embed", "mlp"), dtype=param_dtype),
            "w_down": dense((fs, d_model), ("mlp", "embed"), dtype=param_dtype),
        }
    return p


def router_topk(logits: torch.Tensor, moe):
    """logits [T, E] -> (weights [T,k], idx [T,k], aux_loss). Dead (padded)
    experts are masked out; weights are renormalised over the selected k;
    among equal probabilities the lower expert index wins."""
    e = logits.shape[1]
    dead = torch.arange(e, device=logits.device) >= moe.num_experts_real
    logits = logits.float().masked_fill(dead[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = ranked[:, :moe.top_k], order[:, :moe.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance loss over the real experts.
    counts = torch.zeros((e,), device=logits.device).index_add_(
        0, idx.reshape(-1), torch.ones((idx.numel(),), device=logits.device))
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.mean(dim=0)
    aux = (moe.num_experts_real * torch.sum(frac_tokens * frac_probs)
           * moe.aux_weight)
    return weights, idx, aux


def _positions_within_expert(e_flat: torch.Tensor,
                             num_experts: int) -> torch.Tensor:
    """For each (token, choice) entry, its arrival rank within its expert:
    a stable sort, then each entry's offset from its expert's first
    sorted position (``searchsorted``, left side)."""
    n = e_flat.shape[0]
    dev = e_flat.device
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=dev, dtype=sorted_e.dtype),
        side="left")
    pos_sorted = torch.arange(n, device=dev) - seg_start[sorted_e]
    out = torch.zeros((n,), dtype=torch.int64, device=dev)
    out[order] = pos_sorted
    return out


def capacity(tokens: int, moe) -> int:
    """Slots per expert: ``cf * T * k / E`` floored, at least 8 (decode-sized
    batches would otherwise starve), at most ``T * k`` (dropless)."""
    k, e = moe.top_k, moe.num_experts
    return min(tokens * k, max(int(moe.capacity_factor * tokens * k / e), 8))


def _dispatch(xt, logits, moe, cap: int, dtype):
    """Scatter the tokens into their ``[E, cap, d]`` buffers; run nothing.
    Returns (xin [E,cap,d], slot [t*k], w_keep [t*k], aux)."""
    t, d = xt.shape
    weights, idx, aux = router_topk(logits, moe)
    k, e = moe.top_k, moe.num_experts
    e_flat = idx.reshape(-1)
    w_flat = weights.reshape(-1)
    tok_of = torch.arange(t * k, device=xt.device) // k
    pos = _positions_within_expert(e_flat, e)
    keep = pos < cap
    # Entries past the capacity all land on the overflow row e * cap, which
    # is dropped.
    slot = torch.where(keep, e_flat * cap + pos,
                       torch.full_like(pos, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=xt.device)
    buf = buf.index_add(0, slot, xt[tok_of].to(dtype))
    return buf[:e * cap].reshape(e, cap, d), slot, w_flat * keep, aux


def moe_ffn(p: Any, x: torch.Tensor, moe, dtype):
    """x [B, S, d] -> (y [B, S, d], aux_loss), one dispatch group."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    k, e = moe.top_k, moe.num_experts
    logits = xt.float() @ p["router"]
    cap = capacity(t, moe)
    xin, slot, w_keep, aux = _dispatch(xt, logits, moe, cap, dtype)

    gate = torch.einsum("ecd,edf->ecf", xin, p["w_gate"].to(dtype))
    up = torch.einsum("ecd,edf->ecf", xin, p["w_up"].to(dtype))
    h = torch.einsum("ecf,efd->ecd", L.swiglu(gate, up), p["w_down"].to(dtype))

    # Combine: gather expert outputs back to entries (the overflow row is
    # zero), weight them and sum each token's k choices.
    h_flat = torch.cat([h.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=h.dtype, device=h.device)])
    y_ent = h_flat[slot] * w_keep.to(dtype)[:, None]
    y = y_ent.reshape(t, k, d).sum(dim=1)

    if "shared" in p:
        sp = p["shared"]
        g = torch.einsum("td,df->tf", xt, sp["w_gate"].to(dtype))
        u = torch.einsum("td,df->tf", xt, sp["w_up"].to(dtype))
        y = y + torch.einsum("tf,fd->td", L.swiglu(g, u),
                             sp["w_down"].to(dtype))
    return y.reshape(b, s, d), aux
