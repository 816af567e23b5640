"""Pytree optimizers matching Table 1 of the paper (port of
``repro/optim/optimizers.py``).

Each optimizer is an ``(init, update)`` pair where
``update(grads, state, params) -> (delta, new_state)`` returns the additive
parameter delta, which is what the staleness engine transports. The updates
are elementwise, so one call serves a single worker's tree or the
simulate engine's worker-stacked ``[P, ...]`` tree alike. The step count is a
Python int in the state: it is shared by all workers (each steps once per
iteration), and computing a learning rate or Adam's bias corrections from it
never forces a device sync.

Learning rates may be floats or callables of the int step count.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch import treemath as tm
from repro_torch.kernels import dispatch, ref

Pytree = Any
Schedule = Union[float, Callable[[int], float]]


class Optimizer(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], tuple]
    # Hyperparameters of optimizers whose update the engine can run as the
    # fused packed pass (``dispatch.fused_adam``); None = opaque.
    spec: Any = None


def lr_at(lr: Schedule, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a product with the learning rate promotes it in the JAX
    package, where the rate is an fp32 array: bf16 becomes fp32 (a Python
    float would keep bf16), so bf16 params take an fp32 delta and turn
    fp32 after their first update, as there."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def sgd(lr: Schedule = 0.01) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        eta = lr_at(lr, state["step"] + 1)
        delta = tm.tree_map(lambda g: (-eta * g.float()).to(g.dtype), grads)
        return delta, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(lr: Schedule = 0.01, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": 0, "m": tm.tree_zeros_like(params)}

    def update(grads, state, params):
        eta = lr_at(lr, state["step"] + 1)
        m = tm.tree_map(lambda mi, g: beta * mi + g, state["m"], grads)
        if nesterov:
            delta = tm.tree_map(lambda mi, g: -eta * _f32(beta * mi + g), m,
                                grads)
        else:
            delta = tm.tree_map(lambda mi: -eta * _f32(mi), m)
        return delta, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adagrad(lr: Schedule = 0.01, eps: float = 1e-7) -> Optimizer:
    def init(params):
        return {"step": 0, "v": tm.tree_zeros_like(params)}

    def update(grads, state, params):
        eta = lr_at(lr, state["step"] + 1)
        v = tm.tree_map(lambda vi, g: vi + g * g, state["v"], grads)
        delta = tm.tree_map(
            lambda vi, g: -eta * _f32(g) / (torch.sqrt(vi) + eps), v, grads)
        return delta, {"step": state["step"] + 1, "v": v}

    return Optimizer(init, update)


def rmsprop(lr: Schedule = 0.01, decay: float = 0.9, eps: float = 1e-7,
            mom: float = 0.0) -> Optimizer:
    """Table 1: eta=0.01, decay=0.9, momentum=0 (Hinton 2012 formulation)."""
    def init(params):
        st = {"step": 0, "v": tm.tree_zeros_like(params)}
        if mom > 0:
            st["m"] = tm.tree_zeros_like(params)
        return st

    def update(grads, state, params):
        eta = lr_at(lr, state["step"] + 1)
        v = tm.tree_map(lambda vi, g: decay * vi + (1 - decay) * g * g,
                        state["v"], grads)
        scaled = tm.tree_map(lambda vi, g: g / (torch.sqrt(vi) + eps), v, grads)
        new = {"step": state["step"] + 1, "v": v}
        if mom > 0:
            m = tm.tree_map(lambda mi, sg: mom * mi + sg, state["m"], scaled)
            new["m"] = m
            delta = tm.tree_map(lambda mi: -eta * _f32(mi), m)
        else:
            delta = tm.tree_map(lambda sg: -eta * _f32(sg), scaled)
        return delta, new

    return Optimizer(init, update)


def adam(lr: Schedule = 0.001, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         kernel: bool = False) -> Optimizer:
    """Table 1 defaults. With weight_decay > 0 this is AdamW (decoupled).

    ``kernel=True`` runs the moment/update math as ONE fused pass over packed
    flat [D] views (``dispatch.fused_adam``: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones). The kernel is fed a zero
    parameter vector, so ``0 - update`` is the delta."""
    def init(params):
        return {"step": 0, "m": tm.tree_zeros_like(params),
                "v": tm.tree_zeros_like(params)}

    def update_fused(grads, state, params):
        spec = tm.pack_spec(params)
        pad = dispatch.PACK_ALIGN
        step = state["step"] + 1
        eta = lr_at(lr, step)
        gv = tm.tree_pack(grads, pad_to=pad)
        dneg, m_new, v_new = dispatch.fused_adam(
            torch.zeros_like(gv), tm.tree_pack(state["m"], pad_to=pad),
            tm.tree_pack(state["v"], pad_to=pad), gv, eta, b1, b2, eps, step)
        delta32 = tm.tree_unpack(dneg, spec, dtype=torch.float32)

        def delta_leaf(d, p):
            if weight_decay:
                d = d - eta * weight_decay * p
            return d.to(p.dtype)

        delta = tm.tree_map(delta_leaf, delta32, params)
        return delta, {"step": step, "m": tm.tree_unpack(m_new, spec),
                       "v": tm.tree_unpack(v_new, spec)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr_at(lr, step)
        _, _, _, _, omb1, omb2, bc1, bc2 = ref.adam_scalars(
            eta, b1, b2, eps, step)
        m = tm.tree_map(lambda mi, g: b1 * mi + omb1 * g, state["m"], grads)
        v = tm.tree_map(lambda vi, g: b2 * vi + omb2 * g * g, state["v"], grads)

        def delta_leaf(mi, vi, p):
            # JAX's bias corrections are fp32 arrays: the delta is fp32
            # math, cast once.
            d = -eta * (_f32(mi) / bc1) / (torch.sqrt(_f32(vi) / bc2) + eps)
            if weight_decay:
                d = d - eta * weight_decay * _f32(p)
            return d.to(p.dtype)

        delta = tm.tree_map(delta_leaf, m, v, params)
        return delta, {"step": step, "m": m, "v": v}

    return Optimizer(init, update_fused if kernel else update,
                     spec=dict(name="adam", lr=lr, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay))


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "adam": adam,
    "adagrad": adagrad,
    "rmsprop": rmsprop,
}


def get_optimizer(name: str, **kwargs) -> Optimizer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def paper_default(name: str, lr: Schedule = None) -> Optimizer:
    """Table 1 hyperparameters for the CNN/DNN/MLR experiments."""
    table1 = {
        "sgd": dict(lr=0.01),
        "momentum": dict(lr=0.01, beta=0.9),
        "adam": dict(lr=0.001, b1=0.9, b2=0.999),
        "adagrad": dict(lr=0.01),
        "rmsprop": dict(lr=0.01, decay=0.9, mom=0.0),
    }
    kw = dict(table1[name])
    if lr is not None:
        kw["lr"] = lr
    return _REGISTRY[name](**kw)


def value_and_grad(loss_fn, params: Pytree, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)``, both detached.

    The written-out form of ``jax.vmap(jax.value_and_grad(loss_fn))``: with
    worker-stacked ``[P, ...]`` params and batches the loss is the ``[P]``
    vector of per-worker losses, and the gradient of its sum is each
    worker's own gradient exactly, since workers share no parameter."""
    leaves, treedef = tm.tree_flatten(params)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        loss = loss_fn(tm.tree_unflatten(treedef, leaves), *args)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), tm.tree_unflatten(treedef, grads)


def make_sgd_update_fn(loss_fn, optimizer: Optimizer):
    """Adapt (loss_fn, optimizer) to the staleness engine's UpdateFn
    contract: (params, opt_state, batch, gen) -> (delta, new_opt_state,
    metrics)."""
    def update_fn(params, opt_state, batch, gen=None):
        loss, grads = value_and_grad(loss_fn, params, batch)
        delta, new_state = optimizer.update(grads, opt_state, params)
        return delta, new_state, {"loss": loss}

    return update_fn


def make_stochastic_update_fn(loss_fn, optimizer: Optimizer):
    """Same, for losses that consume randomness:
    ``loss_fn(params, batch, gen)`` with ``gen`` a ``torch.Generator``."""
    def update_fn(params, opt_state, batch, gen=None):
        loss, grads = value_and_grad(loss_fn, params, batch, gen)
        delta, new_state = optimizer.update(grads, opt_state, params)
        return delta, new_state, {"loss": loss}

    return update_fn
