"""Gradient sparsification with error feedback over packed flat views,
port of ``repro/compensate/sparsify.py``.

Each step the un-sent mass is carried in a residual and re-offered the next
step (Candela et al., arXiv:1910.09466):

    acc    = g + resid          (fp32, packed [*, D] treemath view)
    sent   = acc * 1[|acc| >= t]
    resid' = acc - sent

with ``t`` the per-row k-th largest magnitude (``topk:K``) or a fixed
threshold (``thresh:V``). The split runs through
``kernels.dispatch.sparsify_topk`` (the CUDA kernel for CUDA tensors); the
threshold selection stays in torch. Rows wider than
:data:`EXACT_TOPK_MAX` estimate the threshold from a strided subsample of at
most :data:`TOPK_SAMPLE` magnitudes, as the reference does, so they keep
about k elements; the realized sparsity is reported per step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import dispatch

COMPRESS_KINDS = ("none", "topk", "thresh")

# Above this row width the top-k threshold is estimated from a subsample.
EXACT_TOPK_MAX = 1 << 16
# Subsample size the threshold is estimated from (strided, deterministic).
TOPK_SAMPLE = 1 << 13


def parse_compress(text: Optional[str]) -> Tuple[str, Optional[float]]:
    """``"none" | "topk:K" | "thresh:V"`` -> (kind, amount).

    ``K`` is the kept fraction when 0 < K < 1 (``topk:0.1`` keeps 10%) or
    an element count when K >= 1; ``V`` is the magnitude threshold
    (>= 0)."""
    text = (text or "none").strip()
    kind, _, arg = text.partition(":")
    if kind == "none":
        if arg:
            raise ValueError(f"compress='none' takes no argument, got {text!r}")
        return "none", None
    if kind not in COMPRESS_KINDS:
        raise ValueError(f"unknown compress kind {text!r}; grammar: "
                         "none | topk:K | thresh:V")
    if not arg:
        raise ValueError(f"compress={kind!r} needs an argument: {kind}:VALUE")
    try:
        amount = float(arg)
    except ValueError as e:
        raise ValueError(f"bad compress spec {text!r}: {e}") from e
    if kind == "topk" and amount <= 0:
        raise ValueError(f"topk:K needs K > 0, got {text!r}")
    if kind == "thresh" and amount < 0:
        raise ValueError(f"thresh:V needs V >= 0, got {text!r}")
    return kind, amount


def topk_threshold(absacc: torch.Tensor, k: int,
                   true_size: Optional[int] = None) -> torch.Tensor:
    """Per-row magnitude threshold keeping ~k of the ``true_size`` real
    elements: the exact k-th largest up to EXACT_TOPK_MAX, a strided-sample
    estimate above. The zero pad tail past ``true_size`` is excluded."""
    d = absacc.shape[-1]
    n = d if true_size is None else min(true_size, d)
    real = absacc if n == d else absacc[..., :n]
    if n <= EXACT_TOPK_MAX:
        return torch.topk(real, min(k, n), dim=-1).values[..., -1]
    stride = -(-n // TOPK_SAMPLE)            # ceil: sample <= TOPK_SAMPLE
    sample = real[..., ::stride]
    ks = max(1, round(k * sample.shape[-1] / n))
    return torch.topk(sample, ks, dim=-1).values[..., -1]


def topk_count(amount: float, true_size: int) -> int:
    """Elements kept per row: a fraction of the unpadded packed width when
    0 < K < 1, an element count otherwise (clamped to the row)."""
    k = int(round(amount * true_size)) if amount < 1.0 else int(amount)
    return max(1, min(k, true_size))


def sparsity_of(sent: torch.Tensor, true_size: int) -> torch.Tensor:
    """Realized zero fraction of a sent payload over its real entries (a
    device scalar)."""
    rows = sent.numel() // sent.shape[-1] if sent.shape[-1] else 0
    nnz = (sent != 0).float().sum()
    return 1.0 - nnz / (rows * true_size)


def sparsify_with_feedback(vec: torch.Tensor, resid: torch.Tensor, kind: str,
                           amount: float, true_size: int):
    """One EF step over a packed view: ``vec``/``resid`` are [*, D] fp32,
    possibly zero-padded past ``true_size`` (the pad tail stays zero).
    Returns ``(sent, resid', sparsity)`` with ``sent + resid' == vec +
    resid`` bit for bit."""
    acc = vec + resid
    if kind == "topk":
        thr = topk_threshold(acc.abs(), topk_count(amount, true_size),
                             true_size)
    else:  # thresh
        thr = torch.full(acc.shape[:-1], amount, device=acc.device)
    sent, new_resid = dispatch.sparsify_topk(acc, thr)
    return sent, new_resid, sparsity_of(sent, true_size)
