"""CUDA kernel: EF split + weighted stale delivery + Adam in one pass
(``csrc/fused_update.cu``), the port of ``repro/kernels/fused_update.py``.

Three variants share one entry point: ``plain`` (delivery + Adam), ``ef``
(adds the split of ``acc`` against ``thr`` with ``fresh`` rows delivering
this step's ``sent``) and ``ef_mom`` (adds the DGC masked momentum). With
EF, ``stale=None, fresh=None`` means every row is fresh (the sync tail: no
ring to read). ``weights``, ``thr``, ``fresh`` and ``scale`` are device
tensors; the Adam scalars are computed here in fp32 (``ref.adam_scalars``)
and passed by value. Launches are counted per variant in
``fused_update.by_variant``. The kernel takes contiguous fp32 CUDA
tensors; anything else raises. CPU tensors go to ``kernels/ref.py``
through ``kernels/dispatch.py``, never through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

VARIANTS = ("plain", "ef", "ef_mom")


def variant(acc=None, mom=None) -> str:
    """The kernel variant a call with these operands runs."""
    if acc is None:
        return "plain"
    return "ef" if mom is None else "ef_mom"


def fused_update(p, m, v, stale, weights, lr, b1, b2, eps, step, scale,
                 acc=None, thr=None, fresh=None, mom=None):
    """p/m/v [D]; stale [R, D]; weights [R]; scale a [1] or 0-dim device
    tensor; with EF also acc [R, D], thr [R], fresh [R] (or stale and
    fresh both None: every row fresh) and optionally mom [R, D]. Returns
    ``(p', m', v', u)`` (+ ``sent, resid`` with EF, + ``mom'``).
    step >= 1."""
    name = variant(acc, mom)
    lead = acc if stale is None and name != "plain" else stale
    if lead is None or p.dim() != 1 or lead.dim() != 2:
        raise ValueError("fused_update: p must be [D] and stale [R, D]")
    (d,) = p.shape
    r = lead.shape[0]
    dev = p.device
    rows = [] if stale is None else [("stale", stale)]
    if name != "plain":
        if thr is None or (fresh is None) != (stale is None):
            raise ValueError("fused_update: acc needs thr, and fresh "
                             "unless stale is None too")
        rows.append(("acc", acc))
        if mom is not None:
            rows.append(("mom", mom))
    elif thr is not None or fresh is not None or mom is not None:
        raise ValueError("fused_update: thr, fresh and mom need acc")
    for nm, t in (("p", p), ("m", m), ("v", v)):
        build.check_operand("fused_update", nm, t, (d,), dev)
    for nm, t in rows:
        build.check_operand("fused_update", nm, t, (r, d), dev)
    per_row = [("weights", weights)]
    if name != "plain":
        per_row.append(("thr", thr))
        if fresh is not None:
            per_row.append(("fresh", fresh))
    for nm, t in per_row:
        build.check_operand("fused_update", nm, t, (r,), dev)
    if not torch.is_tensor(scale) or scale.numel() != 1:
        raise ValueError("fused_update: scale must be a one-element device "
                         "tensor")
    build.check_operand("fused_update", "scale", scale, tuple(scale.shape), dev)
    if step < 1:
        raise ValueError(f"fused_update: step must be >= 1, got {step}")
    p_out, m_out, v_out, u_out = (torch.empty_like(p) for _ in range(4))
    outs = (p_out, m_out, v_out, u_out)
    sent = resid = mom_out = None
    if name != "plain":
        sent, resid = torch.empty_like(acc), torch.empty_like(acc)
        outs += (sent, resid)
        if mom is not None:
            mom_out = torch.empty_like(mom)
            outs += (mom_out,)
    if d == 0:
        return outs
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = build.library().repro_fused_update_f32(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), ptr(stale),
            weights.data_ptr(), ptr(acc), ptr(thr), ptr(fresh), ptr(mom),
            scale.data_ptr(), p_out.data_ptr(), m_out.data_ptr(),
            v_out.data_ptr(), u_out.data_ptr(), ptr(sent), ptr(resid),
            ptr(mom_out), r, d, *ref.adam_scalars(lr, b1, b2, eps, step),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_update")
    fused_update.by_variant[name] += 1
    return outs


fused_update.by_variant = dict.fromkeys(VARIANTS, 0)
