"""Trace-driven delays: replay *measured* per-step wall-times through the
SSP clock discipline (port of ``repro/delays/trace.py``).

Trace file format (JSONL, one object per line), shared with the JAX
package:

    {"header": {"trace_version": 1, "num_workers": P, ...}}
    {"step": 0, "durations": [d_0, ..., d_{P-1}]}
    {"step": 1, "durations": [...]}

``durations`` are positive wall-clock seconds of each worker's step-``t``
work. Recorders: :class:`repro_torch.engine.TraceRecorderHook` (live
training runs) or :func:`record_trace` on any ``[T, P]`` array. JSON floats
round-trip exactly, so two reads of the same file give identical schedules.

:class:`Trace` converts the measured durations into a per-step delay table
through ``repro_torch.core.ssp.ssp_delay_schedule`` (float32 clocks), the
same clock discipline the engine's ``ssp`` mode runs on sampled speeds.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.delays.models import DelaySource, DelaySpec
from repro_torch.delays.schedule import Schedule

TRACE_VERSION = 1


def record_trace(path: str, durations, meta: Optional[dict] = None) -> str:
    """Write per-(step, worker) wall-times ``[T, P]`` (or ``[T]`` for one
    worker) to a JSONL trace file. Returns ``path``."""
    arr = np.asarray(durations, np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2 or arr.size == 0:
        raise ValueError(f"durations must be a non-empty [T, P] array, "
                         f"got shape {arr.shape}")
    if (arr <= 0).any():
        raise ValueError("durations must be positive wall-times")
    header = {"trace_version": TRACE_VERSION, "num_workers": int(arr.shape[1])}
    if meta:
        header.update(meta)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"header": header}) + "\n")
        for t, row in enumerate(arr):
            f.write(json.dumps({"step": t,
                                "durations": [float(x) for x in row]}) + "\n")
    return path


def read_trace(path: str) -> Tuple[np.ndarray, dict]:
    """Read a trace file back to (``[T, P]`` float64 durations, header)."""
    header: dict = {}
    rows = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "header" in rec:
                header = rec["header"]
            else:
                rows[int(rec["step"])] = rec["durations"]
    if not rows:
        raise ValueError(f"trace {path!r} has no duration rows")
    steps = sorted(rows)
    if steps != list(range(len(steps))):
        raise ValueError(f"trace {path!r} has non-contiguous steps")
    arr = np.asarray([rows[t] for t in steps], np.float64)
    if arr.ndim != 2:
        raise ValueError(f"trace {path!r} rows have ragged worker counts")
    return arr, header


@dataclasses.dataclass(frozen=True)
class Trace(DelaySpec):
    """Replay a recorded wall-time trace as a delay schedule.

    ``bound`` is the SSP clock-drift bound applied to the measured speeds
    (it also sizes the ring: delays stay in ``[0, bound]``). It may be left
    ``None`` only in ``mode="ssp"``, where the engine supplies its own ``s``.
    A single-worker trace is broadcast to the engine's ``P`` workers.
    """

    path: str
    bound: Optional[int] = None

    def speeds(self) -> np.ndarray:
        arr, _ = read_trace(self.path)
        return arr

    def schedule(self, num_workers: Optional[int] = None,
                 bound: Optional[int] = None) -> Schedule:
        """The ``[T, P]`` delay table the trace realizes to: measured
        durations pushed through the SSP clock discipline."""
        b = bound if bound is not None else self.bound
        if b is None:
            raise ValueError(
                "Trace needs an explicit bound= outside mode='ssp' "
                "(it sizes the delivery ring)")
        sp = self.speeds()
        if num_workers is not None and sp.shape[1] != num_workers:
            if sp.shape[1] == 1:
                sp = np.repeat(sp, num_workers, axis=1)
            else:
                raise ValueError(
                    f"trace {self.path!r} has {sp.shape[1]} workers, engine "
                    f"has {num_workers}")
        from repro_torch.core import ssp as ssp_lib  # core imports delays
        table = ssp_lib.ssp_delay_schedule(
            ssp_lib.SSPConfig(num_workers=sp.shape[1], bound=int(b)),
            torch.as_tensor(sp, dtype=torch.float32))
        return Schedule(table.cpu().numpy())

    @property
    def mean_total_delay(self) -> float:
        return self.schedule().mean_total_delay

    def realize(self, key=None, t_steps=None, num_workers=None) -> DelaySource:
        return self.schedule(num_workers=num_workers).realize(
            key, t_steps, num_workers)
