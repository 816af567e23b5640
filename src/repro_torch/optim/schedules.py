"""Learning-rate schedules, including the Theorem-1 stepsize (port of
``repro/optim/schedules.py``). A schedule maps the Python int step count to
a Python float, so evaluating it never touches the device."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def inv_sqrt(base: float, warmup: int = 0):
    """base / sqrt(k), with optional linear warmup."""
    def sched(step):
        if warmup > 0 and step < warmup:
            return base * step / warmup / math.sqrt(1.0 * warmup)
        return base / math.sqrt(max(float(step), 1.0))
    return sched


def theorem1(mu: float, s: int, lipschitz: float):
    """eta_k = mu / (s L sqrt(k)): the stepsize of Theorem 1."""
    denom = max(s, 1) * max(lipschitz, 1e-8)
    return lambda step: mu / (denom * math.sqrt(max(float(step), 1.0)))


def cosine(base: float, total_steps: int, floor: float = 0.0):
    def sched(step):
        frac = min(max(step / total_steps, 0.0), 1.0)
        return floor + 0.5 * (base - floor) * (1 + math.cos(math.pi * frac))
    return sched
