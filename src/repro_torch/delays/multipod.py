"""Hierarchical multi-pod delay composition (port of
``repro/delays/multipod.py``).

Real multi-pod systems see two delay regimes: cheap intra-pod links and an
expensive inter-pod interconnect. :class:`MultiPod` composes two sub-specs
over a worker -> pod map:

* same-pod pairs pay the intra-pod delay alone;
* cross-pod pairs pay intra **plus** inter (the update traverses both
  hops), so ``bound = intra.bound + inter.bound``.

In the per-worker gradient form (``(P,)`` delays, stale-psum), "cross-pod"
means "not in the pod hosting the aggregation" (``server_pod``); in the
simulate-mode ``(P, P)`` matrix it is pairwise per (src, dst). There is no
aggregate (scalar) form: a single global delay cannot express topology.

The reference splits one ``jax.random`` key into an intra and an inter key.
The port's sources draw from one ``torch.Generator``, so a step draws the
intra delays first and the inter delays second from the same generator;
sampled draws therefore differ from the reference's, while deterministic
sub-specs (``Schedule``, ``Constant``, ``Zero``) give the same tables.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.delays.models import DelaySource, DelaySpec


def pods_of(num_workers: int, num_pods: int) -> Tuple[int, ...]:
    """Contiguous-block worker -> pod map (the mesh's natural layout)."""
    if num_pods < 1 or num_workers % num_pods:
        raise ValueError(
            f"num_workers={num_workers} must split evenly over "
            f"num_pods={num_pods}")
    per = num_workers // num_pods
    return tuple(w // per for w in range(num_workers))


class _MultiPodSource(DelaySource):
    def __init__(self, pod_of, server_pod, intra: DelaySource,
                 inter: DelaySource):
        self.pod_of = pod_of
        self.server_pod = server_pod
        self.intra = intra
        self.inter = inter
        self._pods: dict = {}

    @property
    def bound(self) -> int:
        return self.intra.bound + self.inter.bound

    def _cross(self, device: torch.device, ndim: int) -> torch.Tensor:
        """The cross-pod mask for the ``(P,)`` or ``(P, P)`` form, built
        once per device."""
        key = (str(device), ndim)
        if key not in self._pods:
            pods = np.asarray(self.pod_of)
            cross = (pods[:, None] != pods[None, :] if ndim == 2
                     else pods != self.server_pod)
            self._pods[key] = torch.from_numpy(cross).to(device)
        return self._pods[key]

    def delays(self, gen, step, shape):
        if len(shape) == 0:
            raise ValueError(
                "MultiPod has no aggregate (scalar) form: a single global "
                "delay cannot express topology; use per_worker_delays=True")
        base = self.intra.delays(gen, step, shape)
        extra = self.inter.delays(gen, step, shape)
        cross = self._cross(gen.device, len(shape))
        return base + torch.where(cross, extra, torch.zeros_like(extra))


@dataclasses.dataclass(frozen=True)
class MultiPod(DelaySpec):
    """Intra-pod/inter-pod delay composition over ``pod_of`` (worker -> pod).

    ``intra`` and ``inter`` are any DelaySpecs (samplers, schedules, even a
    nested MultiPod); cross-pod delays are ``intra + inter``. ``server_pod``
    anchors the per-worker gradient form.
    """

    pod_of: Tuple[int, ...]
    intra: DelaySpec
    inter: DelaySpec
    server_pod: int = 0

    def __post_init__(self):
        object.__setattr__(self, "pod_of", tuple(int(p) for p in self.pod_of))
        if not self.pod_of:
            raise ValueError("pod_of must map at least one worker")

    @property
    def num_workers(self) -> int:
        return len(self.pod_of)

    @property
    def num_pods(self) -> int:
        return len(set(self.pod_of))

    @property
    def bound(self) -> int:
        return self.intra.bound + self.inter.bound

    @property
    def mean_total_delay(self) -> float:
        # Pairwise (simulate-matrix) semantics: mean over ordered pairs.
        pods = np.asarray(self.pod_of)
        cross = float((pods[:, None] != pods[None, :]).mean())
        return (self.intra.mean_total_delay
                + cross * (self.inter.mean_total_delay - 1.0))

    def realize(self, key=None, t_steps=None, num_workers=None) -> DelaySource:
        if num_workers is not None and num_workers != len(self.pod_of):
            raise ValueError(
                f"MultiPod maps {len(self.pod_of)} workers, engine has "
                f"{num_workers}")
        return _MultiPodSource(
            self.pod_of, self.server_pod,
            self.intra.realize(key, t_steps, num_workers),
            self.inter.realize(key, t_steps, num_workers))
