"""CUDA kernel: fused Adam step (``csrc/fused_adam.cu``).

One pass reads (p, m, v, g) and writes (p', m', v'), the port of
``repro/kernels/fused_adam.py``. The step's scalars are computed here in
fp32 (``ref.adam_scalars``) and passed by value. The kernel takes contiguous
fp32 CUDA tensors; anything else raises. CPU tensors go to
``kernels/ref.py`` through ``kernels/dispatch.py``, never through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def fused_adam(p, m, v, g, lr, b1, b2, eps, step):
    """All of p, m, v, g are [D] fp32 CUDA; returns (p', m', v'). step >= 1."""
    if p.dim() != 1:
        raise ValueError("fused_adam: operands must be flat [D] tensors")
    (d,) = p.shape
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        build.check_operand("fused_adam", name, t, (d,), p.device)
    if step < 1:
        raise ValueError(f"fused_adam: step must be >= 1, got {step}")
    p_out, m_out, v_out = (torch.empty_like(p) for _ in range(3))
    if d == 0:
        return p_out, m_out, v_out
    scalars = ref.adam_scalars(lr, b1, b2, eps, step)
    with torch.cuda.device(p.device):
        err = build.library().repro_fused_adam_f32(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), d,
            *scalars, torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "fused_adam")
    fused_adam.launches += 1
    return p_out, m_out, v_out


fused_adam.launches = 0
