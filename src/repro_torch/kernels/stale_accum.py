"""CUDA kernel: fused delayed-update delivery (``csrc/stale_accum.cu``).

``out = params + sum_s weights[s] * buffer[s, :]``, the port of
``repro/kernels/stale_accum.py``. The kernel takes contiguous fp32 CUDA
tensors; anything else raises. CPU tensors go to ``kernels/ref.py`` through
``kernels/dispatch.py``, never through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"stale_accum: {name} must be a CUDA tensor, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"stale_accum: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"stale_accum: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"stale_accum: {name} must be contiguous")


def stale_accum(params: torch.Tensor, buffer: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """params [D], buffer [S, D], weights [S] (fp32, CUDA) -> out [D]."""
    if params.dim() != 1 or buffer.dim() != 2:
        raise ValueError("stale_accum: params must be [D] and buffer [S, D]")
    s, d = buffer.shape
    _check("params", params, (d,))
    _check("buffer", buffer, (s, d))
    _check("weights", weights, (s,))
    if weights.device != params.device or buffer.device != params.device:
        raise ValueError("stale_accum: operands lie on different devices")
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
