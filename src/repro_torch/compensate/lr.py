"""Staleness-aware learning-rate policies, port of
``repro/compensate/lr.py``.

* ``"inverse"`` (Zhang & Gupta, arXiv:1511.05950): scale the stepsize by
  ``1 / (1 + d)`` with ``d`` the realized mean delay of this step (``d = 0``,
  as in mode ``sync``, leaves it untouched). In ``simulate`` mode the rule
  is per source worker: ``d`` is ``[P]``.
* ``"theorem1"``: the paper's ``mu / (max(s, 1) L sqrt(k))`` with
  ``k = step + 1``, on live ``mu`` / ``L`` signals carried in
  ``EngineState.comp`` (defaults 1.0, refreshed by
  ``Engine.with_lr_signals``).

The factor multiplies the optimizer's additive delta, so it scales the
effective stepsize of every optimizer alike. A factor computed from device
values (realized delays, live signals) is an fp32 device tensor, so applying
it never forces a host sync; from host values it is a Python float holding
an fp32 value.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import treemath as tm
from repro_torch.core import coherence as coh

LR_POLICIES = ("none", "inverse", "theorem1")


def init_signals(policy: str, device=None) -> dict:
    """State the policy carries in ``EngineState.comp`` (empty for the
    stateless rules)."""
    if policy == "theorem1":
        one = lambda: torch.ones((), device=device)
        return {"mu": one(), "lip": one()}
    return {}


def lr_factor(policy: str, comp: dict, staleness, step: int,
              s: int) -> torch.Tensor:
    """The per-step stepsize factor. ``staleness`` is the realized mean
    delay (a scalar, or [P] per source worker in simulate mode; the factor
    takes its shape); ``step`` the 0-based iteration counter."""
    if policy == "inverse":
        if not torch.is_tensor(staleness):
            one = np.float32(1.0)
            return float(one / (one + np.float32(staleness)))
        return 1.0 / (1.0 + staleness.float())
    if policy == "theorem1":
        eta = coh.theorem1_stepsize(comp["mu"], s, comp["lip"], step + 1)
        shape = staleness.shape if torch.is_tensor(staleness) else ()
        return eta.expand(shape)
    raise ValueError(f"unknown lr_scale policy {policy!r}; have {LR_POLICIES}")


def scale_tree(tree, factor):
    """delta * factor per leaf, in fp32, keeping each leaf's dtype.
    ``factor`` is a scalar, or [P] against [P, ...] leaves."""
    def one(x):
        f = factor
        if torch.is_tensor(f) and f.dim():
            f = f.reshape(tuple(f.shape) + (1,) * (x.dim() - f.dim()))
        return (x.float() * f).to(x.dtype)

    return tm.tree_map(one, tree)
