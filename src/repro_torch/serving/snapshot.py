"""Trainer→server parameter flow: snapshot publisher + hot-swap refresher
(port of ``repro/serving/snapshot.py``).

This is the serving plane's staleness knob. A `Trainer` running anywhere
publishes parameter snapshots through :class:`SnapshotPublisherHook`
(atomic ``checkpoint`` writes in the JAX package's format — the meta side
file commits the step, so a concurrent reader never sees a torn snapshot,
and either package can read the other's). The server holds a
:class:`SnapshotRefresher` and, between decode steps, on its refresh
period, polls ``latest_step`` (``poll``), restores any newer snapshot onto
the devices of the served params (``load``; on a mesh, as this rank's
shards of the serve plan's placement) and hot-swaps the params the next
step uses (``swap``).

Every served token is then stamped with its **realized parameter
staleness** — how far behind the freshest published snapshot the serving
params were (in publisher steps) and how old they were (wall-clock seconds
since publish) when the token was sampled. That makes trainer→server lag
the same measured-not-assumed quantity the engine's gradient-staleness
modes report, per the paper's core claim.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.engine.trainer import Hook, StepContext

Pytree = Any


class SnapshotPublisherHook(Hook):
    """Publish the engine's eval params every ``every`` trainer steps.

    Each snapshot's metadata records ``published_at`` (wall-clock), which the
    refresher uses for the age half of the staleness stamp. ``keep_last``
    prunes old snapshots after each publish (the refresher tolerates a
    snapshot vanishing between poll and read).
    """

    def __init__(self, ckpt_dir: str, every: int = 1,
                 keep_last: Optional[int] = None,
                 extra: Optional[dict] = None):
        self.ckpt_dir = ckpt_dir
        self.every = max(every, 1)
        self.keep_last = keep_last
        self.extra = extra or {}
        self.published: list = []     # steps published, in order

    def on_step(self, ctx: StepContext) -> None:
        step = ctx.step + 1
        if step % self.every:
            return
        ckpt.save(ckpt.step_path(self.ckpt_dir, step),
                  ctx.engine.params(ctx.state), step=step,
                  extra={"published_at": time.time(), **self.extra})
        if self.keep_last:
            ckpt.prune(self.ckpt_dir, self.keep_last)
        self.published.append(step)


class SnapshotRefresher:
    """Server-side half: poll the snapshot dir, hot-swap params between steps.

    ``every_steps`` is the refresh period in decode steps (0 = never refresh
    — the params stay at whatever the server booted with, and measured
    staleness grows as the publisher advances). Restored leaves land on the
    devices of ``like``'s (the served params); ``shardings`` (the serve
    plan's params specs as ``sharding.rules.NamedSharding`` s) places each
    as this rank's shard, as ``checkpoint.restore`` does.

    The server calls ``poll`` between decode steps (on a mesh, rank 0
    alone), then ``load`` and ``swap`` on every rank for the step polled.
    A publish or a prune racing the read is tolerated. On a mesh ``load``
    reads only this rank's blocks; on the tensor-parallel serve those
    shards are what the server swaps in, with no gather.
    """

    def __init__(self, ckpt_dir: str, like: Pytree,
                 shardings: Optional[Pytree] = None,
                 every_steps: int = 1, base_step: int = 0):
        self.ckpt_dir = ckpt_dir
        self.like = like
        self.shardings = shardings
        self.every_steps = every_steps
        self.current_step = base_step     # publisher step of the served params
        self.published_at: Optional[float] = None
        self.refreshes = 0

    def poll(self, decode_step: int) -> Optional[int]:
        """The newer committed step to swap in at this decode step, or
        None (off period, nothing newer)."""
        if not self.every_steps or decode_step % self.every_steps:
            return None
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None or latest <= self.current_step:
            return None
        return latest

    def load(self, step: int) -> Optional[Tuple[Pytree, dict]]:
        """``(params, extra)`` of snapshot ``step``, or None where it was
        pruned between poll and read (the next period retries)."""
        try:
            params, _, extra = ckpt.restore(
                ckpt.step_path(self.ckpt_dir, step), like=self.like,
                shardings=self.shardings)
        except FileNotFoundError:
            return None
        return params, extra

    def swap(self, step: int, extra: dict) -> None:
        """Record that the server now serves snapshot ``step``."""
        self.current_step = step
        self.published_at = extra.get("published_at")
        self.refreshes += 1

    def staleness(self) -> Tuple[int, Optional[float]]:
        """(steps behind the freshest committed snapshot, seconds since the
        served params were published). Age is None until the first swap
        (boot params were never published)."""
        latest = ckpt.latest_step(self.ckpt_dir)
        behind = max((latest or 0) - self.current_step, 0)
        age = (time.time() - self.published_at
               if self.published_at is not None else None)
        return behind, age
