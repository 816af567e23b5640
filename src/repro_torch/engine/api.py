"""Execution surface of the port, ``simulate`` mode (port of
``repro/engine/api.py``).

``build_engine(loss, optimizer, EngineConfig(mode="simulate", ...))`` returns
an :class:`Engine` with the JAX package's object surface:
``engine.init(seed, params=...) -> state``,
``engine.step(state, batch) -> (state, metrics)``, ``engine.params(state)``
and ``engine.with_staleness(state, s)``. Steps run eagerly (there is no
``jit``) on the engine's device, CUDA unless ``device="cpu"``.

Routing: ``kernels="off"`` keeps the tree layout in plain torch;
``"auto"`` and ``"on"`` run the packed ring through the CUDA kernels (one
device, so no placement veto). An Adam-spec optimizer on the packed path
runs the fused step (``stale_accum`` + one ``fused_adam`` per step) unless
``megakernel="off"``.

Not ported yet, and raising ``NotImplementedError``: the ``stale-psum``,
``ssp`` and ``sync`` modes (ROADMAP A.5), ``lr_scale`` / ``compress`` /
``ef_momentum`` (A.6), ``mesh=`` (A.12) and ``server_side`` (A.2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.core import staleness
from repro_torch.delays.models import DelaySpec, UniformDelay, as_spec
from repro_torch.kernels import dispatch
from repro_torch.optim import optimizers as optlib

Pytree = Any

MODES = ("simulate", "stale-psum", "ssp", "sync")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One config for every staleness regime (same fields and defaults as
    ``repro.engine.EngineConfig``; this slice runs ``simulate``).

    ``s`` parameterises ``UniformDelay(s)`` (delays r in [0, s-1]) unless
    ``delay`` overrides it.
    """
    mode: str = "sync"
    num_workers: int = 1
    s: int = 0
    delay: Optional[DelaySpec] = None
    kernels: str = "off"
    donate: bool = True
    lr_scale: str = "none"
    compress: str = "none"
    ef_momentum: float = 0.0
    megakernel: str = "auto"
    per_worker_delays: bool = True
    buffer_dtype: Any = torch.float32
    server_side: bool = False
    loss_takes_key: bool = False         # loss_fn(params, batch, gen) losses
    ssp_speeds: Optional[Any] = None
    ssp_steps: int = 512
    ssp_mean_dur: float = 1.0
    ssp_cv: float = 0.5
    ssp_seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; have {MODES}")
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.s < 0:
            raise ValueError(f"staleness bound s must be >= 0, got {self.s}")
        if self.kernels not in ("off", "auto", "on"):
            raise ValueError(f"kernels must be 'off'|'auto'|'on', "
                             f"got {self.kernels!r}")
        if self.megakernel not in ("off", "auto", "on"):
            raise ValueError(f"megakernel must be 'off'|'auto'|'on', "
                             f"got {self.megakernel!r}")
        object.__setattr__(self, "delay", as_spec(self.delay))


@dataclasses.dataclass
class EngineState:
    """Mode-specific state plus the dynamic staleness bound (an int: the
    inclusive max delay currently allowed). ``comp`` stays ``()``: the
    compensation layer is not ported yet."""
    inner: Pytree
    bound: int
    comp: Pytree = ()


def _to_device(batch: Pytree, device: torch.device) -> Pytree:
    def conv(x):
        if isinstance(x, np.ndarray) or torch.is_tensor(x):
            return torch.as_tensor(x).to(device, non_blocking=True)
        return x
    return tm.tree_map(conv, batch)


def _mean_over_workers(metrics: dict) -> dict:
    """simulate-mode metrics are per-worker rows [P, ...]; reduce them to
    scalars (kept as device tensors: no sync)."""
    return {k: v.float().mean(dim=0) if torch.is_tensor(v) and v.dim() >= 1
            else v for k, v in metrics.items()}


@dataclasses.dataclass
class Engine:
    """Uniform handle returned by ``build_engine``."""
    cfg: EngineConfig
    device: torch.device
    meta: dict = dataclasses.field(default_factory=dict)
    _init_inner: Callable = None   # (params, update_state, gen) -> inner
    _step_inner: Callable = None   # (inner, batch, bound) -> (inner, metrics)
    _params_of: Callable = None    # inner -> params eval view
    _max_bound: int = 0

    def init(self, seed=0, params: Pytree = None,
             update_state: Pytree = None) -> EngineState:
        """Initialise engine state from ``params`` (required: the engine is
        built from a bare loss function). ``seed`` (an int, or a
        ``torch.Generator`` on the engine's device) seeds the engine's
        delay stream; ``update_state`` overrides the per-worker optimizer
        state (defaults to ``optimizer.init(params)``)."""
        if params is None:
            raise ValueError("engine built from a bare loss function: pass "
                             "params=")
        params = tm.tree_map(lambda x: torch.as_tensor(x).to(self.device),
                             params)
        gen = (seed if isinstance(seed, torch.Generator)
               else device_lib.generator(seed, self.device))
        inner = self._init_inner(params, update_state, gen)
        return EngineState(inner=inner, bound=self._max_bound)

    def step(self, state: EngineState, batch) -> Tuple[EngineState, dict]:
        """One engine step: ``(state, batch) -> (state, metrics)``. Numpy
        batches are moved to the engine's device. The packed path updates
        the input state's ring in place (see ``core/staleness.py``)."""
        inner, metrics = self._step_inner(
            state.inner, _to_device(batch, self.device), state.bound)
        return EngineState(inner=inner, bound=state.bound,
                           comp=state.comp), metrics

    def params(self, state: EngineState) -> Pytree:
        """The evaluation view: worker 0's cache."""
        return self._params_of(state.inner)

    def step_count(self, state: EngineState) -> int:
        return state.inner.step

    @property
    def batches_per_step(self) -> int:
        """Worker batches consumed per engine step (the paper's accounting)."""
        return self.cfg.num_workers

    def dispatch_report(self) -> dict:
        """The engine's routing verdict plus the per-op backend decisions
        the dispatch layer recorded (process-wide, last call wins)."""
        info = dict(self.meta.get("kernels", {"config": self.cfg.kernels}))
        info["decisions"] = dispatch.report()
        return info

    def with_staleness(self, state: EngineState, s: int) -> EngineState:
        """Clamp the engine to an effective staleness bound ``s`` without
        rebuilding buffers: delays r <= s-1 (UniformDelay semantics)."""
        b = max(int(s) - 1, 0)
        return dataclasses.replace(state, bound=min(b, self._max_bound))


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def build_engine(loss_fn, optimizer: Optional[optlib.Optimizer],
                 cfg: EngineConfig, mesh=None, *, update_fn=None,
                 server_apply=None, device=None) -> Engine:
    """Build a ``simulate``-mode :class:`Engine` on ``device`` (CUDA unless
    ``device="cpu"``; raises without CUDA otherwise).

    ``loss_fn(params, batch)`` (or ``(params, batch, gen)`` with
    ``cfg.loss_takes_key``) must accept worker-stacked ``[P, ...]`` params
    and batches and return the ``[P]`` per-worker losses, as
    ``models.mlp.loss_fn`` does. ``update_fn`` bypasses the loss/optimizer
    adaptation (see ``core.staleness.UpdateFn``).
    """
    dev = device_lib.resolve(device)
    if cfg.mode != "simulate":
        raise _not_ported(f"mode={cfg.mode!r}", "A.5, gradient-ring modes")
    if mesh is not None:
        raise _not_ported("mesh=", "A.12, multi-GPU placement")
    if cfg.lr_scale != "none" or cfg.compress != "none" or cfg.ef_momentum:
        raise _not_ported("lr_scale/compress/ef_momentum", "A.6, compensate/")
    if cfg.server_side or server_apply is not None:
        raise _not_ported("server_side", "A.2, server_side ablation of "
                          "core/staleness.py")
    if loss_fn is not None and not callable(loss_fn):
        raise TypeError(f"loss_fn must be callable, got {type(loss_fn)!r}")

    kernel_delivery = cfg.kernels != "off"
    meta = {"mode": cfg.mode, "workers": cfg.num_workers, "s": cfg.s,
            "device": str(dev),
            "kernels": {"config": cfg.kernels,
                        "delivery": "packed" if kernel_delivery else "tree"}}
    if cfg.delay is not None:
        meta["delay_spec"] = repr(cfg.delay)

    def resolve_mega(supported: bool, why_not: str) -> bool:
        """Resolve the megakernel knob; records the verdict in meta."""
        if cfg.megakernel == "off":
            meta["kernels"]["megakernel"] = "off"
            return False
        sp = getattr(optimizer, "spec", None) if optimizer is not None else None
        if not (sp and sp.get("name") == "adam"):
            supported, why_not = False, "optimizer has no Adam spec"
        if not supported:
            if cfg.megakernel == "on":
                raise ValueError(
                    f"megakernel='on' is unsupported here: {why_not}; use "
                    "megakernel='auto'")
            meta["kernels"]["megakernel"] = "off"
            meta["kernels"]["megakernel_fallback"] = why_not
            return False
        meta["kernels"]["megakernel"] = "fused"
        return True

    custom_update = update_fn is not None
    if update_fn is None:
        if loss_fn is None or optimizer is None:
            raise ValueError("simulate mode needs (loss, optimizer) or an "
                             "explicit update_fn")
        make = (optlib.make_stochastic_update_fn if cfg.loss_takes_key
                else optlib.make_sgd_update_fn)
        update_fn = make(loss_fn, optimizer)
    if custom_update:
        mega = resolve_mega(False, "custom update_fn (opaque update math)")
    else:
        mega = resolve_mega(kernel_delivery, "tree delivery")
    sim_cfg = staleness.StalenessConfig(
        num_workers=cfg.num_workers, delay=cfg.delay or UniformDelay(cfg.s),
        kernels=kernel_delivery)
    fused_kw = None
    if mega:
        sp = optimizer.spec
        fused_kw = dict(loss=loss_fn, takes_key=cfg.loss_takes_key,
                        lr=sp["lr"], b1=sp["b1"], b2=sp["b2"], eps=sp["eps"],
                        weight_decay=sp["weight_decay"])
    raw = staleness.make_sim_step(update_fn, sim_cfg, fused=fused_kw)

    def init_inner(params, update_state, gen):
        if update_state is None:
            if mega:
                # Fused layout: per-worker Adam moments live packed ([P, D]
                # after the worker broadcast).
                width = staleness._packed_width(params)
                update_state = {"m": torch.zeros((width,), device=dev),
                                "v": torch.zeros((width,), device=dev)}
            else:
                update_state = optimizer.init(params)
        return staleness.init_sim_state(params, update_state, sim_cfg, gen)

    def step_inner(inner, batch, bound):
        inner, m = raw(inner, batch, bound=bound)
        return inner, _mean_over_workers(m)

    return Engine(cfg=cfg, device=dev, meta=meta, _init_inner=init_inner,
                  _step_inner=step_inner,
                  _params_of=lambda inner: tm.tree_map(lambda x: x[0],
                                                       inner.caches),
                  _max_bound=sim_cfg.delay.bound)
