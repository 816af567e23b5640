"""Kernel dispatch: the one layer that decides how each hot spot executes
(port of ``repro/kernels/dispatch.py``).

The backend follows the tensor's device:

* a CUDA tensor runs the hand-written kernel (``kernels/csrc``), or raises;
* a CPU tensor runs the plain PyTorch version (``kernels/ref.py``).

There is no interpret mode and no fallback on shape: the CUDA kernels mask
their own ragged tail, so any D runs. Decisions are recorded into a report,
``report()`` / ``report_lines()``, which ``Engine.dispatch_report`` surfaces.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_adam as _fa
from repro_torch.kernels import ref
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
