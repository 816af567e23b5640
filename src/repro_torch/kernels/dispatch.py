"""Kernel dispatch: the one layer that decides how each hot spot executes
(port of ``repro/kernels/dispatch.py``).

The backend follows the tensor's device:

* a CUDA tensor runs the hand-written kernel (``kernels/csrc``), or raises;
* a CPU tensor runs the plain PyTorch version (``kernels/ref.py``).

There is no interpret mode and no fallback on shape: the CUDA kernels mask
their own ragged tail, so any D runs, ``paged_attention`` takes any head
width and column offset, and ``flash_attention`` any Sq <= Sk and head width
up to 256 (the JAX dispatcher sends sequence lengths that do not divide its
blocks to the oracle). Decisions are recorded into a report,
``report()`` / ``report_lines()``, which ``Engine.dispatch_report`` surfaces.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import coherence as _co
from repro_torch.kernels import flash_attention as _fl
from repro_torch.kernels import fused_adam as _fa
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import sparsify as _sp
from repro_torch.kernels import stale_accum as _sa

# Width packed flat views are zero-padded to, kept equal to the JAX
# package's so packed layouts compare element-wise.
PACK_ALIGN = 2048

# -- decision report ---------------------------------------------------------

_DECISIONS: dict = {}


def _decide(op: str, backend: str, why: str = "") -> str:
    _DECISIONS[op] = backend + (f" ({why})" if why else "")
    return backend


def report() -> dict:
    """op -> last backend decision recorded since the last reset."""
    return dict(_DECISIONS)


def report_lines() -> list:
    return [f"  {op:<16} -> {backend}" for op, backend in _DECISIONS.items()]


def reset_report() -> None:
    _DECISIONS.clear()


def note(op: str, backend: str, why: str = "") -> None:
    """Record an engine-level routing decision into the dispatch report."""
    _decide(op, backend, why)


def fuses(t: torch.Tensor) -> bool:
    """Does an operand on this tensor's device reach a CUDA kernel (rather
    than the plain version)? Raises for devices the port has no path for."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def _backend(op: str, t: torch.Tensor) -> str:
    if fuses(t):
        return _decide(op, "cuda")
    return _decide(op, "ref", "cpu tensor")


# -- dispatchers -------------------------------------------------------------

def stale_accum(params, buffer, weights):
    """params [D] + sum_s weights[s] * buffer[s, D]: the delayed-update
    delivery."""
    if _backend("stale_accum", params) == "ref":
        return ref.stale_accum(params, buffer, weights)
    return _sa.stale_accum(params, buffer, weights)


def fused_adam(p, m, v, g, lr, b1=0.9, b2=0.999, eps=1e-8, step=1):
    """One fused Adam step over flat [D] views -> (p', m', v')."""
    if _backend("fused_adam", p) == "ref":
        return ref.fused_adam(p, m, v, g, lr, b1, b2, eps, step)
    return _fa.fused_adam(p, m, v, g, lr, b1, b2, eps, step)


def sparsify_topk(acc, thr):
    """Error-feedback split: acc [*, D], thr [*] -> (sent, resid), both
    [*, D], with ``sent = where(|acc| >= thr, acc, 0)`` and
    ``resid = acc - sent``. Takes a flat [D] accumulator with a scalar
    threshold or row-batched [R, D] with per-row thresholds."""
    if _backend("sparsify_topk", acc) == "ref":
        return ref.sparsify_mask(acc, thr)
    d = acc.shape[-1]
    lead = tuple(acc.shape[:-1])
    rows = acc.numel() // d if d else 0
    thr = torch.as_tensor(thr, dtype=torch.float32, device=acc.device)
    sent, resid = _sp.sparsify_topk(
        acc.reshape(rows, d).contiguous(),
        thr.expand(lead).reshape(rows).contiguous())
    return sent.reshape(acc.shape), resid.reshape(acc.shape)


def fused_update(p, m, v, stale, weights, lr, b1=0.9, b2=0.999, eps=1e-8,
                 step=1, scale=1.0, acc=None, thr=None, fresh=None, mom=None):
    """One-pass fused step over packed flat [D] views: optional EF split of
    the R source rows (``acc``/``thr``; DGC masked momentum via ``mom``),
    weighted delivery of the ring rows ``stale`` with per-row ``fresh`` flags
    selecting this step's ``sent`` over the gathered ring row (with EF,
    ``stale=None, fresh=None``: every row delivers ``sent``), and the
    bias-corrected Adam update with the LR factor ``scale`` (a float or a
    one-element device tensor) multiplied in. Returns ``(p', m', v', u)``
    (+ ``sent, resid`` with EF, + ``mom'``)."""
    if _backend("fused_update", p) == "ref":
        return ref.fused_update(p, m, v, stale, weights, lr, b1, b2, eps,
                                step, scale, acc=acc, thr=thr, fresh=fresh,
                                mom=mom)
    if not torch.is_tensor(scale):
        scale = torch.full((1,), scale, device=p.device)
    # Per-row operands often arrive as strided views (a top-k column, a
    # reshaped scalar); the kernel reads them dense.
    dense = lambda t: None if t is None else t.contiguous()
    return _fu.fused_update(p, m, v, dense(stale), dense(weights), lr, b1,
                            b2, eps, step, scale.float().reshape(1),
                            acc=dense(acc), thr=dense(thr),
                            fresh=dense(fresh), mom=dense(mom))


def coherence_dots(history, g):
    """history [W, D], g [D] -> (dots [W], hist_sq [W], g_sq []): the
    Definition-1 reduction in one pass. No block-size contract: the kernel
    masks its own ragged tail."""
    if _backend("coherence_dots", history) == "ref":
        return ref.coherence_dots(history, g)
    return _co.coherence_dots(history, g)


def paged_attention(q, k_new, v_new, pages, tables, pos, layer, *,
                    k_off, v_off, kv_heads, head_dim, tokens, page_tokens,
                    window=0):
    """Serve-decode attention read in place from the packed page pool
    (``serving/cache.py``). Both the CUDA kernel and the plain version take
    their scores and softmax in fp32, as the Pallas kernel does."""
    kw = dict(k_off=k_off, v_off=v_off, kv_heads=kv_heads,
              head_dim=head_dim, tokens=tokens, page_tokens=page_tokens,
              window=window)
    if _backend("paged_attention", pages) == "ref":
        return ref.paged_attention(q, k_new, v_new, pages, tables, pos,
                                   layer, **kw)
    return _pa.paged_attention(q, k_new, v_new, pages, tables, pos, layer,
                               **kw)


def flash_attention(q, k, v, causal=True, window=0):
    """Blockwise attention over a whole sequence: q [B,Sq,H,hd], k/v
    [B,Sk,Hkv,hd] -> [B,Sq,H,hd] in q's dtype (causal and sliding-window
    masks, GQA, q right-aligned to the keys). The decision records the
    shape, since the JAX dispatcher decides on it."""
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    shape = f"B={b} Sq={sq} Sk={sk} H={h}/Hkv={hkv} hd={hd}"
    if fuses(q):
        _decide("flash_attention", "cuda", shape)
        return _fl.flash_attention(q, k, v, causal=causal, window=window)
    _decide("flash_attention", "ref", f"cpu tensor; {shape}")
    return ref.flash_attention(q, k, v, causal=causal, window=window)
