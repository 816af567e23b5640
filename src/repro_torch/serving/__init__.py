"""repro_torch.serving — request serving with live trainer-snapshot refresh
(port of ``repro.serving``).

A continuous-batching server (``server.Server``) drains an admission queue
(``queue``) through a packed paged decode-cache (``cache``), hot-swapping
parameters from a concurrently training ``Trainer``'s published snapshots
(``snapshot``) and stamping every served token with its realized parameter
staleness. On the GPU the decode step's attention reads the page pool in
place through the CUDA ``paged_attention`` kernel.

Smoke: ``PYTHONPATH=src python -m repro_torch.serving [--cpu]``.
"""
from repro_torch.serving.batcher import ContinuousBatcher, SlotState
from repro_torch.serving.cache import (PagedDecodeCache, PagedKV, PageLayout,
                                       build_layout)
from repro_torch.serving.queue import (AdmissionQueue, Clock, Request,
                                       burst_arrivals, poisson_arrivals,
                                       synthetic_requests, uniform_arrivals)
from repro_torch.serving.server import (Server, ServeReport, ServedRequest,
                                        ServingConfig)
from repro_torch.serving.snapshot import (SnapshotPublisherHook,
                                          SnapshotRefresher)

__all__ = [
    "AdmissionQueue", "Clock", "ContinuousBatcher", "PagedDecodeCache",
    "PagedKV", "PageLayout", "Request", "ServeReport", "ServedRequest", "Server",
    "ServingConfig", "SlotState", "SnapshotPublisherHook",
    "SnapshotRefresher", "build_layout", "burst_arrivals",
    "poisson_arrivals", "synthetic_requests", "uniform_arrivals",
]
