"""Deterministic per-step delay tables (port of ``repro/delays/schedule.py``).

A :class:`Schedule` holds an int delay table indexed by ``step mod T``:

* ``[T, P]``: one delay per (step, worker). The simulate engine broadcasts
  row ``t`` over destinations, ``r[src, dst] = table[t mod T, src]``: a
  worker's outgoing updates share its delay (the source-straggler semantics
  of Appendix A.3).
* ``[T]``: one delay per step, broadcast to every worker.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.delays.models import DelaySource, DelaySpec


class TableSource(DelaySource):
    """Realized schedule: indexes the table by ``step mod T``. The table
    moves to the generator's device on first use there."""

    def __init__(self, table: np.ndarray, bound: int):
        self._host = np.asarray(table, np.int64)
        self._on: dict = {}
        self._bound = int(bound)

    @property
    def bound(self) -> int:
        return self._bound

    def _table(self, device: torch.device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.from_numpy(self._host).to(device)
        return self._on[key]

    def delays(self, gen, step, shape):
        table = self._table(gen.device)
        row = table[int(step) % table.shape[0]]
        if len(shape) == 0:
            if table.ndim != 1:
                raise ValueError(
                    "aggregate (scalar) delays need a [T] schedule table; "
                    f"got shape {tuple(table.shape)}")
            return row
        if table.ndim == 1:
            row = row.expand(shape[:1])
        elif row.shape[0] != shape[0]:
            raise ValueError(
                f"schedule table has {row.shape[0]} workers, engine asked "
                f"for {shape[0]}")
        if len(shape) == 1:
            return row
        if len(shape) == 2:
            # simulate-mode [src, dst] matrix: source rows broadcast over
            # destinations.
            return row[:, None].expand(tuple(shape))
        raise ValueError(f"unsupported delay shape {shape}")


@dataclasses.dataclass(frozen=True)
class Schedule(DelaySpec):
    """Deterministic delay schedule over a numpy/list ``table``."""

    table: Any

    def __post_init__(self):
        t = np.asarray(self.table, np.int32)
        if t.ndim not in (1, 2) or t.size == 0:
            raise ValueError(
                f"Schedule table must be a non-empty [T] or [T, P] array, "
                f"got shape {t.shape}")
        if t.min() < 0:
            raise ValueError("Schedule table has negative delays")
        object.__setattr__(self, "table", t)
        object.__setattr__(self, "_bound", int(t.max()))
        object.__setattr__(self, "_mean", float(t.mean()))

    @property
    def bound(self) -> int:
        return self._bound

    @property
    def mean_total_delay(self) -> float:
        return 1.0 + self._mean

    @property
    def num_workers(self) -> Optional[int]:
        return self.table.shape[1] if self.table.ndim == 2 else None

    def realize(self, key=None, t_steps=None, num_workers=None) -> TableSource:
        if (num_workers is not None and self.num_workers is not None
                and self.num_workers != num_workers):
            raise ValueError(
                f"Schedule table is for {self.num_workers} workers, engine "
                f"has {num_workers}")
        return TableSource(self.table, self.bound)
