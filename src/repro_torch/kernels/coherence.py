"""CUDA kernel: the Definition-1 reduction (``csrc/coherence.cu``).

``dots = H @ g``, ``hist_sq[w] = <H[w], H[w]>`` and ``g_sq = <g, g>`` in one
pass over the probe-gradient history, the port of
``repro/kernels/coherence.py``. Two fixed-order stages (no atomics), so two
calls on the same inputs are equal bit for bit. The kernel takes contiguous
fp32 CUDA tensors, any W >= 1 and any D (it masks its own ragged tail);
anything else raises. CPU tensors go to ``kernels/ref.py`` through
``kernels/dispatch.py``, never through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def coherence_dots(history: torch.Tensor, g: torch.Tensor):
    """history [W, D], g [D] (fp32, CUDA) -> (dots [W], hist_sq [W],
    g_sq []), views of one [2W + 1] output."""
    if history.dim() != 2:
        raise ValueError("coherence_dots: history must be [W, D]")
    w, d = history.shape
    if w < 1:
        raise ValueError("coherence_dots: history needs at least one row")
    build.check_operand("coherence_dots", "history", history, (w, d),
                        history.device)
    build.check_operand("coherence_dots", "g", g, (d,), history.device)
    # Stage 2 writes every output; with D = 0 the sums are empty (zero).
    out = (torch.empty if d else torch.zeros)((2 * w + 1,),
                                              device=history.device)
    if d > 0:
        lib = build.library()
        ws = torch.empty((lib.repro_coherence_workspace_f32(w, d),),
                         device=history.device)
        with torch.cuda.device(history.device):
            err = lib.repro_coherence_f32(
                out.data_ptr(), ws.data_ptr(), history.data_ptr(),
                g.data_ptr(), w, d,
                torch.cuda.current_stream(history.device).cuda_stream)
        build.check(err, "coherence_dots")
        coherence_dots.launches += 1
    return out[:w], out[w:2 * w], out[2 * w]


coherence_dots.launches = 0
