"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py`` for the kernels this package has).

These are what a CPU tensor runs, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card. All math is fp32, except that
``paged_attention`` rounds the gathered K/V to the cache dtype as the JAX
oracle does, and ``flash_attention`` returns q's dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def stale_accum(params: torch.Tensor, buffer: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """params [D] + sum_s weights[s] * buffer[s, D] (fp32 accumulation)."""
    acc = torch.einsum("s,sd->d", weights.float(), buffer.float())
    return (params.float() + acc).to(params.dtype)


def sparsify_mask(acc: torch.Tensor, thr):
    """sent = where(|acc| >= thr, acc, 0); resid = acc - sent.

    ``thr`` has one value per leading row of ``acc`` (shape
    ``acc.shape[:-1]``, or a scalar); magnitudes compare in fp32. The split
    is exact: ``sent + resid == acc`` bit for bit."""
    a32 = acc.float()
    t32 = torch.as_tensor(thr, dtype=torch.float32,
                          device=acc.device).unsqueeze(-1)
    sent = torch.where(a32.abs() >= t32, a32, torch.zeros_like(a32))
    return sent.to(acc.dtype), (a32 - sent).to(acc.dtype)


def coherence_dots(history: torch.Tensor, g: torch.Tensor):
    """history [W, D], g [D] -> (dots [W], hist_sq [W], g_sq []). fp32."""
    h32 = history.float()
    g32 = g.float()
    dots = h32 @ g32
    hist_sq = torch.sum(h32 * h32, dim=-1)
    g_sq = torch.sum(g32 * g32)
    return dots, hist_sq, g_sq


def adam_scalars(lr, b1, b2, eps, step):
    """The fp32 scalars of one Adam step, as ``repro/kernels/fused_adam.py``
    stacks them: ``(lr, b1, b2, eps, 1-b1, 1-b2, 1-b1^t, 1-b2^t)``. Each is
    returned as a Python float that holds an exact fp32 value, so the kernel
    (which takes fp32 arguments) and this module compute with the same
    numbers."""
    f = np.float32
    b1_, b2_, t = f(b1), f(b2), f(step)
    vals = (f(lr), b1_, b2_, f(eps), f(1) - b1_, f(1) - b2_,
            f(1) - b1_ ** t, f(1) - b2_ ** t)
    return tuple(float(v) for v in vals)


def fused_adam(p, m, v, g, lr, b1, b2, eps, step):
    """One Adam step with bias correction; returns (p', m', v'). fp32 math,
    one rounding per operation in the kernel's order."""
    lr, b1, b2, eps, omb1, omb2, bc1, bc2 = adam_scalars(lr, b1, b2, eps, step)
    g32 = g.float()
    m_new = b1 * m.float() + omb1 * g32
    v_new = b2 * v.float() + omb2 * g32 * g32
    update = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    p_new = p.float() - update
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def fused_update(p, m, v, stale, weights, lr, b1, b2, eps, step, scale=1.0,
                 acc=None, thr=None, fresh=None, mom=None):
    """One-pass update: the ``sparsify_mask`` split of the R source rows
    (optional, with DGC masked momentum), the weighted delivery
    ``u = sum_r w[r] * delivered[r]`` where ``delivered[r]`` is this step's
    ``sent[r]`` for fresh rows and the ring row ``stale[r]`` otherwise, and
    the ``fused_adam`` formula with the LR factor multiplied in last
    (``p' = p - scale * update``). Returns ``(p', m', v', u)``, plus
    ``(sent, resid)`` when ``acc``/``thr`` are given and ``mom'`` when
    ``mom`` is. With ``acc``, ``stale=None, fresh=None`` makes every row
    fresh (nothing is read from a ring). All math fp32; the rows are summed
    one at a time in row order, as the kernel sums them."""
    lr, b1, b2, eps, omb1, omb2, bc1, bc2 = adam_scalars(lr, b1, b2, eps,
                                                         step)
    w32 = weights.float()
    rows = None if stale is None else stale.float()
    extras = ()
    if acc is not None:
        a32 = acc.float()
        t32 = torch.as_tensor(thr, dtype=torch.float32,
                              device=acc.device).unsqueeze(-1)
        keep = a32.abs() >= t32
        sent = torch.where(keep, a32, torch.zeros_like(a32))
        extras = (sent.to(acc.dtype), (a32 - sent).to(acc.dtype))
        if mom is not None:
            mom32 = mom.float()
            extras += (torch.where(keep, torch.zeros_like(mom32),
                                   mom32).to(mom.dtype),)
        rows = (sent if fresh is None else
                torch.where(fresh.float().unsqueeze(-1) > 0, sent, rows))
    u = torch.zeros_like(rows[0])
    for r in range(rows.shape[0]):
        u = u + w32[r] * rows[r]
    m_new = b1 * m.float() + omb1 * u
    v_new = b2 * v.float() + omb2 * u * u
    update = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    update = torch.as_tensor(scale, dtype=torch.float32,
                             device=p.device) * update
    p_new = p.float() - update
    return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype),
            u) + extras


def paged_attention(q, k_new, v_new, pages, tables, pos, layer: int, *,
                    k_off: int, v_off: int, kv_heads: int, head_dim: int,
                    tokens: int, page_tokens: int, window: int = 0):
    """Page-table decode attention, written as the JAX package's oracle
    (``repro/kernels/ref.py::paged_attention``) writes it. q [S,H,hd];
    k_new/v_new [S,Hkv,hd] (cache dtype); pages [P+1,T,W] packed pool
    (null page = P); tables [S,PPS]; pos [S]; ``layer`` picks the per-layer
    K/V column block at ``k_off + layer * Hkv*hd``.

    The layer's columns are gathered through the page table into contiguous
    [S, C] rings and cast to the cache dtype, the new token lands on the
    ring cursor ``pos % C``, and the validity mask is the ring invariant
    ``spos(r) = pos-1-((pos-1-r) % C)`` with null-page rows masked. Scores
    and softmax run in fp32, as the CUDA kernel's do (the oracle's
    ``softmax_dtype`` is every config's fp32 ``attn_softmax_dtype``); the
    output is in v_new's dtype."""
    s, h, hd = q.shape
    hkv = kv_heads
    g = h // hkv
    kvsz = hkv * hd
    c = tokens
    null = pages.shape[0] - 1
    dev = q.device
    tables = tables.long()
    pos = pos.long()
    k0 = k_off + layer * kvsz
    v0 = v_off + layer * kvsz
    # [S, PPS, T, kvsz] -> contiguous ring rows [S, C, Hkv, hd]; the padded
    # tail rows of a last page fall off the [:c] slice.
    kg = pages[:, :, k0:k0 + kvsz][tables].reshape(s, -1, hkv, hd)[:, :c]
    vg = pages[:, :, v0:v0 + kvsz][tables].reshape(s, -1, hkv, hd)[:, :c]
    kg, vg = kg.to(k_new.dtype), vg.to(v_new.dtype)
    cur = pos % c
    sidx = torch.arange(s, device=dev)
    kg[sidx, cur] = k_new.to(kg.dtype)
    vg[sidx, cur] = v_new.to(vg.dtype)

    rows = torch.arange(c, device=dev)
    spos = pos[:, None] - 1 - ((pos[:, None] - 1 - rows[None, :]) % c)
    page_ok = tables[:, rows // page_tokens] != null
    valid = page_ok & (spos >= 0)
    if window:
        valid = valid & (spos > pos[:, None] - window)
    valid = valid | (rows[None, :] == cur[:, None])

    qg = q.reshape(s, 1, hkv, g, hd)
    scores = torch.einsum("bsngd,bknd->bngsk", qg.float(), kg.float())
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, None, :], -3e38)
    probs = torch.softmax(scores, dim=-1).to(vg.dtype)
    out = torch.einsum("bngsk,bknd->bsngd", probs, vg)
    return out.reshape(s, h, hd)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Attention over the whole sequence, the JAX oracle's function.

    q [B,Sq,H,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,H,hd] in q's dtype. GQA: q
    head h reads kv head h // (H // Hkv). q is right-aligned to the kv
    sequence (q row i sits at position i + Sk - Sq). ``causal`` keeps keys
    at or before the query's position; ``window > 0`` implies causal and
    also drops keys at or before ``position - window``. Scores, softmax and
    the weighted sum run in fp32."""
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    if scale is None:
        # As the oracle computes it: 1 / sqrt(hd) in fp32.
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qg = q.reshape(b, sq, hkv, g, hd).float()
    scores = torch.einsum("bsngd,bknd->bngsk", qg, k.float()) * scale
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal or window:
        mask = k_pos <= q_pos
    if window:
        mask = mask & (k_pos > q_pos - window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngsk,bknd->bsngd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)
