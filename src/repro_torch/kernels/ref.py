"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py`` for the kernels this package has).

These are what a CPU tensor runs, and what ``chip_smoke.py`` holds each CUDA
kernel against on the card. All math is fp32.
"""
from __future__ import annotations

import numpy as np
import torch


def stale_accum(params: torch.Tensor, buffer: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """params [D] + sum_s weights[s] * buffer[s, D] (fp32 accumulation)."""
    acc = torch.einsum("s,sd->d", weights.float(), buffer.float())
    return (params.float() + acc).to(params.dtype)


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
