"""CUDA kernel: fused delayed-update delivery (``csrc/stale_accum.cu``).

``out = params + sum_s weights[s] * buffer[s, :]``, the port of
``repro/kernels/stale_accum.py``. The kernel takes contiguous fp32 CUDA
tensors; anything else raises. CPU tensors go to ``kernels/ref.py`` through
``kernels/dispatch.py``, never through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def stale_accum(params: torch.Tensor, buffer: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """params [D], buffer [S, D], weights [S] (fp32, CUDA) -> out [D]."""
    if params.dim() != 1 or buffer.dim() != 2:
        raise ValueError("stale_accum: params must be [D] and buffer [S, D]")
    s, d = buffer.shape
    for name, t, shape in (("params", params, (d,)), ("buffer", buffer, (s, d)),
                           ("weights", weights, (s,))):
        build.check_operand("stale_accum", name, t, shape, params.device)
    out = torch.empty_like(params)
    if d == 0:
        return out
    with torch.cuda.device(params.device):
        err = build.library().repro_stale_accum_f32(
            out.data_ptr(), params.data_ptr(), buffer.data_ptr(),
            weights.data_ptr(), s, d,
            torch.cuda.current_stream(params.device).cuda_stream)
    build.check(err, "stale_accum")
    stale_accum.launches += 1
    return out


stale_accum.launches = 0
