"""Pluggable side concerns for :class:`repro_torch.engine.Trainer` (port of
``repro/engine/hooks.py``): coherence monitoring and coherence-gated
staleness control (``core/coherence.py``), checkpointing
(``checkpoint/checkpoint.py``), wall-time traces (``delays/trace.py``) and
metric sinks (stdout JSON lines, JSONL files).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import torch

from repro_torch import treemath as tm
from repro_torch.core import coherence as coh
from repro_torch.engine.trainer import Hook, StepContext, TrainResult

Pytree = Any


class TraceRecorderHook(Hook):
    """Record per-step wall-times to a ``repro_torch.delays`` trace file.

    Every engine step's host wall-clock duration (between consecutive
    ``on_step`` calls; steps are queued to the device asynchronously, as
    the reference's jitted steps are) is recorded for each worker: the
    single-process Trainer steps all workers in lockstep, so rows are
    uniform. The file is written on ``on_end`` and replays through
    ``delays.Trace(path, bound=s)``.
    """

    def __init__(self, path: str, num_workers: Optional[int] = None):
        self.path = path
        self.num_workers = num_workers
        self._rows: list = []
        self._t = None

    def on_start(self, ctx: StepContext) -> None:
        self._t = time.perf_counter()

    def on_step(self, ctx: StepContext) -> None:
        now = time.perf_counter()
        if self._t is not None:
            p = self.num_workers or ctx.engine.cfg.num_workers
            self._rows.append([now - self._t] * p)
        self._t = now

    def on_end(self, ctx: StepContext, result: TrainResult) -> None:
        from repro_torch.delays import record_trace
        if self._rows:
            record_trace(self.path, self._rows,
                         meta={"mode": ctx.engine.cfg.mode,
                               "steps": len(self._rows)})


class CoherenceHook(Hook):
    """Probe-gradient coherence monitor, optionally closing the loop.

    Every ``every`` steps: compute the probe gradient at the engine's eval
    params (torch autograd), push it through the coherence monitor
    (Definition 1), and record ``mu``/``grad_norm`` into emitted log rows.
    With a :class:`repro_torch.core.CoherenceController`, the measured mu
    drives ``engine.with_staleness``: staleness shrinks when coherence
    degrades and relaxes back when it recovers, with no engine rebuild.

    When the engine runs the theorem1 LR policy
    (``EngineConfig(lr_scale="theorem1")``), the same observation feeds the
    policy's live signals: the measured mu plus a secant Lipschitz estimate
    over consecutive (params, probe-grad) pairs go into the engine state via
    ``engine.with_lr_signals``.

    ``kernels=True`` runs the Definition-1 reduction as the one-pass CUDA
    kernel ``coherence_dots`` (for a ring on the card). The probe batch and
    the history ring live on the engine's device, set up at ``on_start``.
    Each probe reads mu (and grad_norm) on the host once, as the reference
    does.
    """

    def __init__(self, loss_fn, probe_batch, dim: int, window: int = 8,
                 every: int = 10, controller=None, kernels: bool = False):
        if kernels:
            # Block-pad the history ring as the reference does (observe
            # pads the probe gradient to match; the zero tail is inert).
            from repro_torch.kernels import dispatch
            dim = tm.padded_size(dim, dispatch.PACK_ALIGN)
        self.loss_fn = loss_fn
        self.probe_batch = probe_batch
        self.dim, self.window = dim, window
        self.kernels = kernels
        self.monitor: Optional[coh.CoherenceState] = None
        self.controller = controller
        self.ctl = controller.init() if controller is not None else None
        self.every = max(every, 1)
        self.last: dict = {}
        self.mu_trace: list = []
        self._secant = None   # lazy: sized from the first probe gradient

    def on_start(self, ctx: StepContext) -> None:
        dev = ctx.engine.device
        if self.monitor is None or self.monitor.history.device != dev:
            self.monitor = coh.init_coherence(self.dim, self.window,
                                              device=dev)
        self.probe_batch = tm.tree_map(
            lambda x: torch.as_tensor(x).to(dev), self.probe_batch)

    def on_step(self, ctx: StepContext) -> None:
        if (ctx.step + 1) % self.every:
            return
        params = ctx.engine.params(ctx.state)
        g = coh.probe_gradient(self.loss_fn, params, self.probe_batch)
        self.monitor, out = coh.observe(self.monitor, g,
                                        kernels=self.kernels)
        mu, grad_norm = torch.stack([out["mu"], out["grad_norm"]]).tolist()
        self.last = {"mu": mu, "grad_norm": grad_norm}
        if getattr(ctx.engine.cfg, "lr_scale", "none") == "theorem1":
            if self._secant is None:
                self._secant = coh.init_secant(g.shape[-1], device=g.device)
            x = tm.tree_flatten_to_vector(params)
            self._secant = coh.update_secant(self._secant, x, g)
            ctx.state = ctx.engine.with_lr_signals(
                ctx.state, out["mu"], self._secant.l_hat)
            self.last["lip"] = float(self._secant.l_hat)
        if self.controller is not None:
            self.ctl = self.controller.step(self.ctl, mu)
            allowed = int(self.ctl["allowed_s"])
            ctx.state = ctx.engine.with_staleness(ctx.state, allowed)
            self.last["allowed_s"] = allowed
        self.mu_trace.append((ctx.step + 1, self.last["mu"]))

    def on_log(self, ctx: StepContext) -> None:
        ctx.row.update(self.last)


class CheckpointHook(Hook):
    """Save the engine's eval params every ``every`` steps (npz + metadata,
    in the JAX package's format).

    Saves are atomic (see ``checkpoint.save``), so a reader may poll the
    directory while training runs. ``keep_last`` prunes older snapshots
    after each save.
    """

    def __init__(self, ckpt_dir: str, every: int, extra: Optional[dict] = None,
                 keep_last: Optional[int] = None):
        from repro_torch.checkpoint import checkpoint as ckpt
        self._ckpt = ckpt
        self.ckpt_dir = ckpt_dir
        self.every = max(every, 1)
        self.extra = extra or {}
        self.keep_last = keep_last

    def on_step(self, ctx: StepContext) -> None:
        if (ctx.step + 1) % self.every:
            return
        self._ckpt.save(self._ckpt.step_path(self.ckpt_dir, ctx.step + 1),
                        ctx.engine.params(ctx.state), step=ctx.step + 1,
                        extra=self.extra)
        if self.keep_last:
            self._ckpt.prune(self.ckpt_dir, self.keep_last)


class StdoutSink(Hook):
    """Print emitted log rows as JSON lines (the train driver's format)."""

    def on_log(self, ctx: StepContext) -> None:
        print(json.dumps(ctx.row), flush=True)


class JSONLinesSink(Hook):
    """Append emitted log rows to a .jsonl file; write a summary on end."""

    def __init__(self, path: str, header: Optional[dict] = None):
        self.path = path
        self.header = header
        self._file = None

    def _ensure(self):
        if self._file is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._file = open(self.path, "w")
            if self.header:
                self._file.write(json.dumps({"header": self.header}) + "\n")

    def on_log(self, ctx: StepContext) -> None:
        self._ensure()
        self._file.write(json.dumps(ctx.row) + "\n")
        self._file.flush()

    def on_end(self, ctx: StepContext, result: TrainResult) -> None:
        self._ensure()
        self._file.write(json.dumps({
            "summary": {"converged": result.converged,
                        "batches_to_target": result.batches_to_target,
                        "wall_s": round(result.wall_s, 2)}}) + "\n")
        self._file.close()
        self._file = None
