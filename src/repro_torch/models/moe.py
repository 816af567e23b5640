"""Mixture-of-experts FFN (port of ``repro/models/moe.py``).

Sort-based dispatch with a fixed capacity (GShard-style dropping): each
(token, choice) entry is ranked within its expert by a stable sort, entries
ranked past the capacity go to one overflow slot whose row is dropped, the
experts run as one batched matmul over ``[G, E, cap, d]`` buffers, and the
outputs are gathered back and weighted.

Grouped local dispatch, as in the JAX package: the tokens split into G
groups, G the largest divisor of the token count within the data extent of
the ambient mesh (``sharding.rules.use_mesh``; one group without one, and
one group for decode-sized work, ``t * k <= 4 * E``). Each group ranks and
drops against its own capacity ``cf * T/G * k / E``, and the aux loss is the
mean of the groups'. On a mesh the engine decides what a rank's tokens are:
a per-worker step sees the mesh and groups each worker's tokens, a
batch-split step holds one data shard, which is its one group.

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
from repro_torch.sharding import rules as rules_lib

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


def groups_for(tokens: int, moe) -> int:
    """Dispatch groups: the largest divisor of ``tokens`` within the
    ambient mesh's data extent; one for decode-sized work."""
    extent = rules_lib.data_extent(rules_lib.ambient_mesh())
    g = max(g for g in range(1, extent + 1)
            if tokens % g == 0 and extent % g == 0)
    return 1 if tokens * moe.top_k <= 4 * moe.num_experts else g


def _dispatch_group(xt, logits, moe, cap: int, dtype):
    """Scatter one group's tokens into their ``[E, cap, d]`` buffers; run
    nothing. Returns (xin [E,cap,d], slot [t*k], w_keep [t*k], aux)."""
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
    """x [B, S, d] -> (y [B, S, d], aux_loss) over ``groups_for`` groups."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    k, e = moe.top_k, moe.num_experts
    logits = xt.float() @ p["router"]
    groups = groups_for(t, moe)
    t_loc = t // groups
    cap = capacity(t_loc, moe)
    parts = [_dispatch_group(xt[g * t_loc:(g + 1) * t_loc],
                             logits[g * t_loc:(g + 1) * t_loc], moe, cap,
                             dtype) for g in range(groups)]
    # [G, E, cap, d]; one group (one device, decode) is a view, no copy.
    xin = (parts[0][0].unsqueeze(0) if groups == 1
           else torch.stack([q[0] for q in parts]))

    gate = torch.einsum("gecd,edf->gecf", xin, p["w_gate"].to(dtype))
    up = torch.einsum("gecd,edf->gecf", xin, p["w_up"].to(dtype))
    h = torch.einsum("gecf,efd->gecd", L.swiglu(gate, up),
                     p["w_down"].to(dtype))

    # Combine, per group: gather expert outputs back to entries (the
    # overflow row is zero), weight them and sum each token's k choices.
    zero = torch.zeros((1, d), dtype=h.dtype, device=h.device)
    ys = [(torch.cat([h[g].reshape(e * cap, d), zero])[slot]
           * w_keep.to(dtype)[:, None]).reshape(t_loc, k, d).sum(dim=1)
          for g, (_, slot, w_keep, _) in enumerate(parts)]
    y = ys[0] if groups == 1 else torch.cat(ys)
    aux = torch.stack([q[3] for q in parts]).mean()

    if "shared" in p:
        sp = p["shared"]
        g = torch.einsum("td,df->tf", xt, sp["w_gate"].to(dtype))
        u = torch.einsum("td,df->tf", xt, sp["w_up"].to(dtype))
        y = y + torch.einsum("tf,fd->td", L.swiglu(g, u),
                             sp["w_down"].to(dtype))
    return y.reshape(b, s, d), aux
