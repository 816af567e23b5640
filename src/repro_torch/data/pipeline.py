"""Host-side data pipeline: deterministic sharded batch iterators.

(A copy of ``repro/data/pipeline.py``: pure numpy, so both packages see the
same batches for a seed.)

The staleness engine consumes batches with a leading worker axis ``[P, ...]``;
the distributed step consumes a flat global batch that pjit shards over
``("pod", "data")``. Both come from the same ``ShardedBatches`` iterator so
simulation and distributed runs see identical data order for a given seed —
that is what makes the sim-vs-distributed equivalence test meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class ShardedBatches:
    """Cycles through arrays with per-epoch reshuffling.

    arrays: tuple of np.ndarrays sharing the leading (sample) axis.
    Yields tuples shaped [num_workers, per_worker_batch, ...].
    """
    arrays: Sequence[np.ndarray]
    num_workers: int
    batch_per_worker: int
    seed: int = 0
    drop_remainder: bool = True

    def __post_init__(self):
        n = self.arrays[0].shape[0]
        for a in self.arrays:
            assert a.shape[0] == n, "all arrays must share the sample axis"
        self._n = n
        self._global = self.num_workers * self.batch_per_worker
        if self._global > n:
            raise ValueError(f"global batch {self._global} exceeds dataset size {n}")

    def __iter__(self) -> Iterator[tuple]:
        rng = np.random.default_rng(self.seed)
        while True:
            order = rng.permutation(self._n)
            for start in range(0, self._n - self._global + 1, self._global):
                idx = order[start:start + self._global]
                yield tuple(
                    a[idx].reshape(self.num_workers, self.batch_per_worker, *a.shape[1:])
                    for a in self.arrays
                )

    def flat_iter(self) -> Iterator[tuple]:
        """Same order, but flat [global_batch, ...] (distributed mode)."""
        for batch in self:
            yield tuple(a.reshape(-1, *a.shape[2:]) for a in batch)


def partitioned_static(arrays: Sequence[np.ndarray], num_workers: int, seed: int = 0):
    """Static partition of the dataset across workers (the paper partitions
    MF observations and the LDA corpus, not just the batches). Returns a list
    of per-worker array tuples."""
    n = arrays[0].shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    per = n // num_workers
    out = []
    for w in range(num_workers):
        idx = order[w * per:(w + 1) * per]
        out.append(tuple(a[idx] for a in arrays))
    return out


def epoch_batches(arrays: Sequence[np.ndarray], batch: int, seed: int = 0):
    """Single-pass minibatches over one epoch (for eval loops)."""
    n = arrays[0].shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    for start in range(0, n - batch + 1, batch):
        idx = order[start:start + batch]
        yield tuple(a[idx] for a in arrays)
