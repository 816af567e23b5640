"""The training loop (port of ``repro/engine/trainer.py``): step the engine
over a batch source, evaluate on a cadence, stop at a quality target, and
fan side concerns out to hooks."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.engine.api import Engine, EngineState

Pytree = Any


@dataclasses.dataclass
class StepContext:
    """What hooks see each step. Hooks may replace ``state`` and merge
    extra columns into ``row`` when one is being emitted."""
    engine: Engine
    state: EngineState
    step: int                      # 0-based index of the step just taken
    metrics: dict                  # engine metrics (device tensors)
    row: Optional[dict] = None     # log row being assembled, if any


class Hook:
    """Base class: override any subset."""

    def on_start(self, ctx: StepContext) -> None: ...

    def on_step(self, ctx: StepContext) -> None: ...

    def on_log(self, ctx: StepContext) -> None: ...

    def on_eval(self, ctx: StepContext, value: float) -> None: ...

    def on_end(self, ctx: StepContext, result: "TrainResult") -> None: ...


@dataclasses.dataclass
class TrainResult:
    state: EngineState
    history: list                  # emitted log rows
    curve: list                    # [(worker batches processed, eval value)]
    batches_to_target: Optional[int]
    converged: bool
    wall_s: float


@dataclasses.dataclass
class Trainer:
    """Mode-agnostic loop over a uniform :class:`Engine`."""
    engine: Engine
    hooks: Sequence[Hook] = ()

    def run(self, batches, steps: int, *,
            state: Optional[EngineState] = None,
            init_seed: int = 0,
            params: Pytree = None,
            eval_fn: Optional[Callable[[Pytree], Any]] = None,
            eval_every: int = 0,
            target: Optional[float] = None,
            higher_better: bool = True,
            log_every: int = 0) -> TrainResult:
        """Run up to ``steps`` engine steps.

        ``batches`` is an iterable of engine batches or a 0-arg callable.
        Without ``state`` the engine is initialised from ``params`` and
        ``init_seed``. ``eval_fn(params) -> scalar`` runs every
        ``eval_every`` steps under ``torch.no_grad``; with ``target`` set,
        the run stops once the metric crosses it and reports
        worker-batches-to-target, the paper's primary measurement. Device
        values are read on the host only for log rows and evaluations.
        """
        engine = self.engine
        if state is None:
            state = engine.init(init_seed, params=params)
        next_batch = batches if callable(batches) else iter(batches).__next__

        ctx = StepContext(engine=engine, state=state, step=-1, metrics={})
        for h in self.hooks:
            h.on_start(ctx)

        t0 = time.time()
        history: List[dict] = []
        curve: list = []
        batches_to_target, converged = None, False
        # Realized-delay running sum over EVERY step, kept on the device so
        # accumulating never forces a sync; read only when a row is logged.
        stale_sum, stale_n = 0.0, 0
        for t in range(steps):
            try:
                batch = next_batch()
            except StopIteration:  # finite source exhausted: end gracefully
                break
            state, metrics = engine.step(ctx.state, batch)
            ctx.state, ctx.step, ctx.metrics, ctx.row = state, t, metrics, None
            if "mean_staleness" in metrics:
                stale_sum = stale_sum + metrics["mean_staleness"]
                stale_n += 1
            for h in self.hooks:
                h.on_step(ctx)

            if log_every and (t + 1) % log_every == 0:
                ctx.row = {"step": t + 1,
                           "wall_s": round(time.time() - t0, 2)}
                if "loss" in metrics:
                    ctx.row["loss"] = float(metrics["loss"])
                if "mean_staleness" in metrics:
                    ctx.row["mean_staleness"] = float(
                        metrics["mean_staleness"])
                    # Realized mean TOTAL delay (1 + r) over all steps so
                    # far, to set beside a spec's nominal mean_total_delay.
                    ctx.row["mean_total_delay"] = round(
                        1.0 + float(stale_sum) / stale_n, 4)
                # Compensation diagnostics: realized sparsity and the
                # effective stepsize factor.
                if "sparsity" in metrics:
                    ctx.row["sparsity"] = round(float(metrics["sparsity"]), 4)
                if "lr_scale" in metrics:
                    ctx.row["lr_scale"] = round(
                        float(torch.as_tensor(metrics["lr_scale"]).mean()), 6)
                if engine._max_bound:
                    ctx.row["bound"] = int(ctx.state.bound)
                for h in self.hooks:
                    h.on_log(ctx)
                history.append(ctx.row)

            if eval_fn is not None and eval_every and (t + 1) % eval_every == 0:
                with torch.no_grad():
                    value = float(eval_fn(engine.params(ctx.state)))
                worker_batches = (t + 1) * engine.batches_per_step
                curve.append((worker_batches, value))
                for h in self.hooks:
                    h.on_eval(ctx, value)
                if target is not None:
                    hit = value >= target if higher_better else value <= target
                    if hit:
                        batches_to_target, converged = worker_batches, True
                        break

        result = TrainResult(
            state=ctx.state, history=history, curve=curve,
            batches_to_target=batches_to_target, converged=converged,
            wall_s=time.time() - t0)
        for h in self.hooks:
            h.on_end(ctx, result)
        return result
