"""CUDA kernel: error-feedback split (``csrc/sparsify.cu``).

``sent = where(|acc| >= thr[row], acc, 0)``, ``resid = acc - sent`` over
``[R, D]`` rows, the port of ``repro/kernels/sparsify.py``. The threshold is
a device tensor (one value per row), so the engine never reads it on the
host. The kernel takes contiguous fp32 CUDA tensors; anything else raises.
CPU tensors go to ``kernels/ref.py`` through ``kernels/dispatch.py``, never
through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def sparsify_topk(acc: torch.Tensor, thr: torch.Tensor):
    """acc [R, D], thr [R] (fp32, CUDA) -> (sent [R, D], resid [R, D])."""
    if acc.dim() != 2:
        raise ValueError("sparsify_topk: acc must be [R, D]")
    r, d = acc.shape
    build.check_operand("sparsify_topk", "acc", acc, (r, d), acc.device)
    build.check_operand("sparsify_topk", "thr", thr, (r,), acc.device)
    sent, resid = torch.empty_like(acc), torch.empty_like(acc)
    if r == 0 or d == 0:
        return sent, resid
    with torch.cuda.device(acc.device):
        err = build.library().repro_sparsify_f32(
            acc.data_ptr(), thr.data_ptr(), sent.data_ptr(), resid.data_ptr(),
            r, d, torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(err, "sparsify_topk")
    sparsify_topk.launches += 1
    return sent, resid


sparsify_topk.launches = 0
