"""Gradient coherence (Definition 1) and the Theorem-1 stepsize, as runtime
tools (port of ``repro/core/coherence.py``).

The paper defines the coherence at iteration k as

    mu_k = min_{k-s+1 <= t <= k} <gF(x_k), gF(x_t)> / ||gF(x_k)||^2

and proves (Theorem 1) that Async-SGD with stepsize eta_k = mu / (s L sqrt(k))
reaches min_k E||gF(x_k)||^2 <= (s L DeltaF / mu^2 + sigma^2 log T / s)/sqrt(T).

Following the paper's footnote 6, coherence is estimated on a fixed probe
batch: the monitor keeps a ring of the last ``window`` probe gradients
(flattened to fp32 vectors, on the device) and computes mu_k and the
cosine-vs-lag profile (Figures 4 and 5) in one reduction, the CUDA kernel
``coherence_dots`` with ``kernels=True``.

Beyond the paper: :class:`CoherenceController` turns mu_k from a diagnostic
into a control law: when coherence degrades, shrink the effective staleness
bound; when it recovers, relax again.

The ring slot and count are Python ints (as the engines' step counts are),
so observing never reads the device on the host; the history ring is
written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import treemath as tm

Pytree = Any


@dataclasses.dataclass
class CoherenceState:
    history: torch.Tensor   # [window, dim] fp32 ring of probe gradients
    head: int               # slot the *next* gradient will be written to
    count: int              # number of gradients seen so far


def init_coherence(dim: int, window: int, device=None) -> CoherenceState:
    return CoherenceState(
        history=torch.zeros((window, dim), dtype=torch.float32,
                            device=device),
        head=0, count=0)


def observe(state: CoherenceState, grad_vec: torch.Tensor,
            kernels: bool = False) -> Tuple[CoherenceState, dict]:
    """Push the current probe gradient; return mu_k and the cosine profile.

    ``cos_by_lag[m-1]`` is cos(g_k, g_{k-m}) for lag m = 1..window (lags
    beyond ``count`` report 1.0 and are kept out of mu via +inf; with no
    history mu = 1). ``kernels=True`` computes the history-dot reduction in
    one pass over the [window, dim] ring via ``dispatch.coherence_dots``
    (the CUDA kernel for a ring on the card); the default keeps the plain
    three-op reduction. The outputs are device tensors; ``state.history``
    is updated in place and returned in the new state."""
    g = grad_vec.float()
    hist = state.history
    window, dim_h = hist.shape
    if g.shape[-1] != dim_h:
        # A block-padded ring (CoherenceHook(kernels=True)); the zero tail
        # changes no dot, norm or cosine.
        g = torch.nn.functional.pad(g, (0, dim_h - g.shape[-1]))

    if kernels:
        from repro_torch.kernels import dispatch
        dots, hist_sq, g_sq = dispatch.coherence_dots(hist, g.contiguous())
    else:
        dots = hist @ g                                   # [window]
        hist_sq = torch.sum(hist * hist, dim=-1)          # [window]
        g_sq = torch.sum(g * g)

    # slot -> lag: the slot written j steps ago has lag j + 1 relative to
    # g_k. Built on the device from the host ints (no transfer).
    slots = torch.arange(window, device=hist.device)
    lag = (state.head - 1 - slots) % window + 1            # 1..window
    valid = lag <= min(state.count, window)

    coh = dots / torch.clamp(g_sq, min=1e-30)
    if state.count > 0:
        mu_k = torch.min(torch.where(valid, coh, torch.full_like(coh,
                                                                math.inf)))
    else:
        mu_k = torch.ones((), device=hist.device)  # no history: neutral

    cos = dots / torch.clamp(torch.sqrt(hist_sq * g_sq), min=1e-30)
    cos_by_lag = torch.where(valid, cos,
                             torch.ones_like(cos))[torch.argsort(lag)]

    hist[state.head] = g
    new_state = CoherenceState(history=hist, head=(state.head + 1) % window,
                               count=state.count + 1)
    return new_state, {"mu": mu_k, "cos_by_lag": cos_by_lag,
                       "grad_norm": torch.sqrt(g_sq)}


def probe_gradient(loss_fn, params: Pytree, probe_batch) -> torch.Tensor:
    """gF on a fixed probe set (paper Fig. 4: 1000 held-out training
    samples), by autograd at ``params``, flattened in the JAX leaf order to
    one fp32 vector. ``params`` are not modified."""
    leaves, treedef = tm.tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(tm.tree_unflatten(treedef, live), probe_batch)
        grads = torch.autograd.grad(loss, live)
    return tm.tree_flatten_to_vector(tm.tree_unflatten(treedef, list(grads)))


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


def optimal_staleness(mu, sigma, lipschitz, delta_f, horizon) -> torch.Tensor:
    """s* = sigma * mu * sqrt(log T / (L * DeltaF)): the staleness that
    minimizes the Theorem-1 bound (Section 5). Numbers or tensors; fp32."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return f32(sigma) * f32(mu) * torch.sqrt(
        torch.log(torch.clamp(f32(horizon), min=2))
        / torch.clamp(f32(lipschitz) * f32(delta_f), min=1e-30))


@dataclasses.dataclass
class SecantLipschitz:
    """Online L estimate: L_hat = max_k ||g_k - g_{k-1}|| / ||x_k - x_{k-1}||
    (with a 0.9 decay of the running max)."""
    prev_g: torch.Tensor
    prev_x: torch.Tensor
    l_hat: torch.Tensor     # fp32 scalar on the device
    seen: bool


def init_secant(dim: int, device=None) -> SecantLipschitz:
    return SecantLipschitz(
        prev_g=torch.zeros((dim,), dtype=torch.float32, device=device),
        prev_x=torch.zeros((dim,), dtype=torch.float32, device=device),
        l_hat=torch.ones((), dtype=torch.float32, device=device),
        seen=False)


def update_secant(st: SecantLipschitz, x_vec: torch.Tensor,
                  g_vec: torch.Tensor) -> SecantLipschitz:
    dx = torch.linalg.vector_norm(x_vec - st.prev_x)
    dg = torch.linalg.vector_norm(g_vec - st.prev_g)
    est = dg / torch.clamp(dx, min=1e-12)
    l_new = torch.maximum(st.l_hat * 0.9, est) if st.seen else st.l_hat
    return SecantLipschitz(prev_g=g_vec, prev_x=x_vec, l_hat=l_new,
                           seen=True)


@dataclasses.dataclass(frozen=True)
class CoherenceController:
    """Beyond-paper: coherence-gated synchronization.

    While mu_k >= hi for ``patience`` probes in a row, the allowed staleness
    bound relaxes one notch (up to ``s_max``); if mu_k drops below ``lo``,
    it halves (repeatedly, down to 0 == synchronous). ``step`` takes mu_k
    and the controller state as host numbers (compared in fp32, as the
    reference compares) or as device tensors, and returns the same kind.
    """
    s_max: int
    lo: float = 0.0
    hi: float = 0.25
    patience: int = 20

    def init(self):
        return {"allowed_s": int(self.s_max), "healthy": 0}

    def step(self, ctl, mu_k):
        if torch.is_tensor(mu_k):
            return self._step_tensor(ctl, mu_k)
        mu = np.float32(mu_k)
        allowed, healthy = int(ctl["allowed_s"]), int(ctl["healthy"])
        unhealthy = mu < np.float32(self.lo)
        healthy = healthy + 1 if mu >= np.float32(self.hi) else 0
        if unhealthy:
            allowed = max(allowed // 2, 0)
        elif healthy >= self.patience:
            allowed = min(allowed + 1, self.s_max)
        if healthy >= self.patience:
            healthy = 0
        return {"allowed_s": allowed, "healthy": healthy}

    def _step_tensor(self, ctl, mu_k):
        i32 = lambda x: torch.as_tensor(x, dtype=torch.int32,
                                        device=mu_k.device)
        mu = mu_k.float()
        allowed, healthy = i32(ctl["allowed_s"]), i32(ctl["healthy"])
        unhealthy = mu < self.lo
        healthy = torch.where(mu >= self.hi, healthy + 1, i32(0))
        shrunk = torch.clamp(torch.div(allowed, 2, rounding_mode="floor"),
                             min=0)
        relax = torch.clamp(allowed + 1, max=self.s_max)
        done = healthy >= self.patience
        allowed = torch.where(unhealthy, shrunk,
                              torch.where(done, relax, allowed))
        healthy = torch.where(done, i32(0), healthy)
        return {"allowed_s": allowed, "healthy": healthy}
