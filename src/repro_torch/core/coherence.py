"""Gradient coherence (Definition 1) and the Theorem-1 stepsize, port of
``repro/core/coherence.py``.

This slice holds only :func:`theorem1_stepsize`, which the ``theorem1`` LR
policy (``compensate/lr.py``) needs. The coherence monitor, the secant
Lipschitz estimate and the controller follow with the coherence slice
(ROADMAP A.7), in this module.
"""
from __future__ import annotations

import numpy as np
import torch


def theorem1_stepsize(mu: torch.Tensor, s: int, lipschitz: torch.Tensor,
                      k: int) -> torch.Tensor:
    """eta_k = mu / (s L sqrt(k)) (Theorem 1), guarded for k = 0 and
    mu <= 0. ``mu`` and ``lipschitz`` are fp32 tensors (on the device in
    the engine), ``k`` the 1-based step; fp32, in the reference's operation
    order, with ``sqrt(k)`` rounded to fp32 on the host."""
    sqrt_k = float(np.sqrt(np.float32(max(k, 1))))
    mu_pos = torch.clamp(mu.float(), min=1e-8)
    return mu_pos / (max(s, 1) * torch.clamp(lipschitz.float(), min=1e-8)
                     * sqrt_k)
