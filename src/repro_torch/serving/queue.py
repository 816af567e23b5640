"""Admission queue: requests, arrival-process generators, deadlines, clock
(a copy of ``repro/serving/queue.py``, which is pure numpy).

Everything here is host-side and model-free. Requests carry integer prompt
tokens (padded/truncated to the server's prefill length at admission) plus
optional extra batch features (enc-dec ``frames``, VLM ``cross_feats``).
Deadlines are absolute clock times; a request whose deadline passes while
still queued is rejected, and one that exceeds it mid-decode is evicted with
whatever tokens it has (the continuous batcher reuses the slot immediately).

The :class:`Clock` makes the whole serving loop schedulable under test: real
mode reads ``time.monotonic``; virtual mode advances a fixed ``dt`` per
decode step so arrival/deadline behaviour is deterministic.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request."""
    rid: int
    prompt: np.ndarray                       # [n] int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0                   # absolute clock time
    deadline_s: Optional[float] = None       # absolute; None = no deadline
    features: Optional[Dict[str, np.ndarray]] = None  # extra batch inputs


class Clock:
    """Monotonic clock, real (wall) or virtual (fixed dt per decode step)."""

    def __init__(self, virtual_dt: Optional[float] = None):
        self.virtual_dt = virtual_dt
        self._vnow = 0.0
        self._t0 = time.monotonic()

    @property
    def virtual(self) -> bool:
        return self.virtual_dt is not None

    def now(self) -> float:
        return self._vnow if self.virtual else time.monotonic() - self._t0

    def tick(self) -> None:
        """One decode step elapsed."""
        if self.virtual:
            self._vnow += self.virtual_dt

    def idle(self) -> None:
        """Nothing admitted and nothing decoding: let time pass."""
        if self.virtual:
            self._vnow += self.virtual_dt
        else:
            time.sleep(0.001)


# -- arrival processes -------------------------------------------------------

def uniform_arrivals(n: int, period_s: float, start_s: float = 0.0) -> List[float]:
    return [start_s + i * period_s for i in range(n)]


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0,
                     start_s: float = 0.0) -> List[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return list(start_s + np.cumsum(gaps))


def burst_arrivals(n: int, burst: int, gap_s: float,
                   start_s: float = 0.0) -> List[float]:
    """``burst`` simultaneous requests every ``gap_s`` seconds."""
    return [start_s + (i // burst) * gap_s for i in range(n)]


def synthetic_requests(n: int, prompt_len: int, max_new_tokens: int,
                       vocab: int, arrivals: Optional[Sequence[float]] = None,
                       deadline_slack_s: Optional[float] = None,
                       seed: int = 0) -> List[Request]:
    """Random-token requests for benches/smokes. ``deadline_slack_s`` sets
    each deadline to arrival + slack (None = no deadlines)."""
    rng = np.random.default_rng(seed)
    arrivals = list(arrivals) if arrivals is not None else [0.0] * n
    return [
        Request(
            rid=i,
            prompt=rng.integers(0, vocab, size=(prompt_len,)).astype(np.int32),
            max_new_tokens=max_new_tokens,
            arrival_s=arrivals[i],
            deadline_s=(arrivals[i] + deadline_slack_s
                        if deadline_slack_s is not None else None),
        )
        for i in range(n)
    ]


class AdmissionQueue:
    """Arrival-ordered FIFO with deadline rejection.

    ``pop_ready(now)`` hands out the next request whose arrival time has
    passed; the server pushes it back (front) if no slot or pages are free.
    """

    def __init__(self, requests: Sequence[Request]):
        self._q = deque(sorted(requests, key=lambda r: r.arrival_s))

    def __len__(self) -> int:
        return len(self._q)

    @property
    def pending(self) -> bool:
        return bool(self._q)

    def next_arrival(self) -> Optional[float]:
        return self._q[0].arrival_s if self._q else None

    def pop_ready(self, now: float) -> Optional[Request]:
        if self._q and self._q[0].arrival_s <= now:
            return self._q.popleft()
        return None

    def push_front(self, r: Request) -> None:
        self._q.appendleft(r)

    def expire(self, now: float) -> List[Request]:
        """Remove (and return) queued requests whose deadline already passed."""
        dead = [r for r in self._q
                if r.deadline_s is not None and r.deadline_s <= now]
        if dead:
            gone = {id(r) for r in dead}
            self._q = deque(r for r in self._q if id(r) not in gone)
        return dead
