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

Experts over the model axis: under an ambient model-parallel context
(``sharding.rules.use_model_parallel``) the router's expert columns, the
experts and the shared FFN's ``mlp`` dim are this rank's shards. Every
rank routes every token with the whole router logits (gathered), exactly as
one process does, evaluates only its experts' block of ``[G, E, cap, d]``,
combines the slots that land on them, and one ``reduce`` sums the ranks'
parts of the combine and of the shared FFN's row-parallel product. Each of
the two sums then rounds once and they add as one process adds them, so
the layer rounds as one process's does. The combine weights enter the
partial product through ``copy``, so the router's gradient is whole where
the gather's backward takes this rank's columns of it.

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


def _dispatch_group(xt, logits, moe, cap: int, dtype, e0: int, en: int):
    """Scatter one group's tokens into the ``[en, cap, d]`` buffers of the
    experts ``[e0, e0 + en)`` (all of them: ``(0, E)``); run nothing.
    Entries past the capacity, and those routed to other experts, land on
    the overflow row ``en * cap``, which is dropped. Returns (xin
    [en,cap,d], slot [t*k], w_keep [t*k], aux)."""
    t, d = xt.shape
    weights, idx, aux = router_topk(logits, moe)
    k = moe.top_k
    e_flat = idx.reshape(-1)
    tok_of = torch.arange(t * k, device=xt.device) // k
    pos = _positions_within_expert(e_flat, moe.num_experts)
    keep = pos < cap
    mine = keep & (e_flat >= e0) & (e_flat < e0 + en)
    slot = torch.where(mine, (e_flat - e0) * cap + pos,
                       torch.full_like(pos, en * cap))
    buf = torch.zeros((en * cap + 1, d), dtype=dtype, device=xt.device)
    buf = buf.index_add(0, slot, xt[tok_of].to(dtype))
    return (buf[:en * cap].reshape(en, cap, d), slot,
            weights.reshape(-1) * keep, aux)


def moe_ffn(p: Any, x: torch.Tensor, moe, dtype):
    """x [B, S, d] -> (y [B, S, d], aux_loss) over ``groups_for`` groups;
    over this rank's experts under an ambient model-parallel context
    (module docstring)."""
    mp = rules_lib.ambient_model_parallel()
    copy = (lambda v: v) if mp is None else mp.copy
    b, s, d = x.shape
    t = b * s
    xt = copy(x.reshape(t, d))
    k, e = moe.top_k, moe.num_experts
    e0, en = (0, e) if mp is None else mp.span(e)
    logits = xt.float() @ p["router"]
    if mp is not None:
        logits = mp.gather(logits, 1, e, "router")
    groups = groups_for(t, moe)
    t_loc = t // groups
    cap = capacity(t_loc, moe)
    parts = [_dispatch_group(xt[g * t_loc:(g + 1) * t_loc],
                             logits[g * t_loc:(g + 1) * t_loc], moe, cap,
                             dtype, e0, en) for g in range(groups)]
    # [G, en, cap, d]; one group (one device, decode) is a view, no copy.
    xin = (parts[0][0].unsqueeze(0) if groups == 1
           else torch.stack([q[0] for q in parts]))

    gate = torch.einsum("gecd,edf->gecf", xin, p["w_gate"].to(dtype))
    up = torch.einsum("gecd,edf->gecf", xin, p["w_up"].to(dtype))
    h = torch.einsum("gecf,efd->gecd", L.swiglu(gate, up),
                     p["w_down"].to(dtype))

    # Combine, per group: gather expert outputs back to entries (the
    # overflow row is zero) and weight them: [t, k, d].
    zero = torch.zeros((1, d), dtype=h.dtype, device=h.device)
    yk = torch.cat([(torch.cat([h[g].reshape(en * cap, d), zero])[slot]
                     * copy(w_keep).to(dtype)[:, None]).reshape(t_loc, k, d)
                    for g, (_, slot, w_keep, _) in enumerate(parts)])
    aux = torch.stack([q[3] for q in parts]).mean()

    shared = None
    if "shared" in p:
        sp = p["shared"]
        g = torch.einsum("td,df->tf", xt, sp["w_gate"].to(dtype))
        u = torch.einsum("td,df->tf", xt, sp["w_up"].to(dtype))
        shared = L.swiglu(g, u)
    if mp is None:
        # Each token's sum over its k choices, and the shared FFN's.
        y = yk.sum(dim=1)
        if shared is not None:
            y = y + torch.einsum("tf,fd->td", shared, sp["w_down"].to(dtype))
        return y.reshape(b, s, d), aux
    # This rank's parts of the same two sums (its experts' choices; the
    # shared FFN's row-parallel product), fp32 until one ``reduce`` has
    # summed the ranks' parts; each then rounds to ``dtype`` once and they
    # add in ``dtype``, as one process's two sums do.
    y = yk.float().sum(dim=1)
    if shared is None:
        return mp.reduce(y).to(dtype).reshape(b, s, d), aux
    both = mp.reduce(torch.stack(
        [y, L.contract_f32(shared, sp["w_down"].to(dtype), 1)])).to(dtype)
    return (both[0] + both[1]).reshape(b, s, d), aux
