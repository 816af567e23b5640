"""Continuous batching: requests join and leave between decode steps (a
copy of ``repro/serving/batcher.py``, which is pure numpy).

The decode step always runs at the server's fixed ``slots`` width — there is
no padding/re-stacking on membership change. A slot is just an index: the
batcher tracks which request (if any) owns each index and materialises the
three per-step arrays the serve step consumes — current token [S],
position [S], active mask [S]. Joining writes the slot's cache pages and
flips its mask bit; evicting flips the bit back and returns the pages, so a
new request can occupy the index on the very next step while the remaining
slots decode uninterrupted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.queue import Request


@dataclasses.dataclass
class SlotState:
    """Decode-time state of one occupied slot."""
    request: Request
    next_token: int                 # fed to the next decode step
    pos: int                        # position next_token occupies
    remaining: int                  # tokens still to generate
    join_s: float
    ttft_s: float                   # join -> first token (prefill) latency
    tokens: List[int] = dataclasses.field(default_factory=list)
    staleness: List[Tuple[Optional[int], Optional[float]]] = \
        dataclasses.field(default_factory=list)  # per-token (steps, age_s)


class ContinuousBatcher:
    """Slot bookkeeping for the fixed-width continuous batch."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.slots: List[Optional[SlotState]] = [None] * num_slots
        self.joins = 0
        self.evicts = 0

    # -- membership ---------------------------------------------------------

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def any_active(self) -> bool:
        return any(s is not None for s in self.slots)

    def join(self, slot: int, state: SlotState) -> None:
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is occupied (rid "
                             f"{self.slots[slot].request.rid})")
        self.slots[slot] = state
        self.joins += 1

    def evict(self, slot: int) -> SlotState:
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is empty")
        self.slots[slot] = None
        self.evicts += 1
        return state

    # -- per-step arrays ----------------------------------------------------

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tokens [S] int32, pos [S] int32, mask [S] bool) for the serve
        step. Empty slots carry token 0 / pos 0 under a False mask — the
        step's null-page routing makes their lanes inert."""
        tokens = np.zeros((self.num_slots,), np.int32)
        pos = np.zeros((self.num_slots,), np.int32)
        mask = np.zeros((self.num_slots,), bool)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i], pos[i], mask[i] = s.next_token, s.pos, True
        return tokens, pos, mask
