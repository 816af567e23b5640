"""Delay models from the paper (Section 3, Appendix A.3) and the DelaySpec
protocol the engine consumes (port of ``repro/delays/models.py``).

An update generated by worker ``p`` at iteration ``t`` arrives at worker
``p'`` at the start of iteration ``t + 1 + r``, with

  * uniform:   ``r ~ Categorical(0, 1, ..., s-1)`` with equal weights;
  * geometric: one randomly chosen straggler source per iteration draws from
               Geometric(p_straggler), everyone else from Geometric(p_normal)
               (Appendix A.3);
  * constant:  every delay equals a fixed value;
  * zero:      updates always arrive at the next iteration.

``spec.realize(...)`` yields a :class:`DelaySource` whose
``delays(gen, step, shape)`` returns the int64 delays one engine step
consumes, on the device of ``gen`` (a ``torch.Generator``). ``step`` is a
Python int, so no source forces a device sync. Every spec declares an
inclusive ``bound``: it sizes the delivery ring (``bound + 1`` slots).
Sampled draws differ from ``jax.random``'s; samplers are compared by
property (bound, mean), deterministic specs element for element.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


class DelaySource:
    """A realized per-step delay source: ``bound`` (inclusive max delay)
    and ``delays(gen, step, shape)`` with ``shape`` one of ``(P,)``,
    ``(P, P)`` (the simulate-mode ``r[src, dst]`` matrix) or ``()``."""

    @property
    def bound(self) -> int:
        raise NotImplementedError

    def delays(self, gen: torch.Generator, step: int,
               shape: Tuple[int, ...]) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DelaySpec:
    """Base protocol: one description of a delay regime."""

    def realize(self, key=None, t_steps: Optional[int] = None,
                num_workers: Optional[int] = None) -> DelaySource:
        raise NotImplementedError


class _SamplerSource(DelaySource):
    def __init__(self, model: "DelayModel"):
        self.model = model

    @property
    def bound(self) -> int:
        return self.model.bound

    def delays(self, gen, step, shape):
        return self.model.sample(gen, shape)


@dataclasses.dataclass(frozen=True)
class DelayModel(DelaySpec):
    """Base class for the stateless samplers: ``sample(gen, shape)`` draws
    on ``gen.device``."""

    def sample(self, gen: torch.Generator, shape) -> torch.Tensor:
        raise NotImplementedError

    @property
    def bound(self) -> int:
        raise NotImplementedError

    @property
    def mean_total_delay(self) -> float:
        """Mean of (1 + r): iterations until delivery."""
        raise NotImplementedError

    def realize(self, key=None, t_steps=None, num_workers=None) -> DelaySource:
        return _SamplerSource(self)


def _full(gen: torch.Generator, shape, value: int) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=torch.int64, device=gen.device)


@dataclasses.dataclass(frozen=True)
class UniformDelay(DelayModel):
    """r ~ Categorical(0..s-1), the paper's primary model. s <= 1 => 0."""

    s: int

    def sample(self, gen, shape):
        if self.s <= 1:
            return _full(gen, shape, 0)
        return torch.randint(0, self.s, tuple(shape), generator=gen,
                             device=gen.device, dtype=torch.int64)

    @property
    def bound(self) -> int:
        return max(self.s - 1, 0)

    @property
    def mean_total_delay(self) -> float:
        return 1.0 + (max(self.s, 1) - 1) / 2.0


@dataclasses.dataclass(frozen=True)
class ConstantDelay(DelayModel):
    value: int

    def sample(self, gen, shape):
        return _full(gen, shape, self.value)

    @property
    def bound(self) -> int:
        return self.value

    @property
    def mean_total_delay(self) -> float:
        return 1.0 + self.value


@dataclasses.dataclass(frozen=True)
class Zero(DelayModel):
    """Always-zero delays: the s = 0 synchronous limit as an explicit spec."""

    def sample(self, gen, shape):
        return _full(gen, shape, 0)

    @property
    def bound(self) -> int:
        return 0

    @property
    def mean_total_delay(self) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class GeometricDelay(DelayModel):
    """Appendix A.3: per iteration one uniformly chosen straggler SOURCE
    draws from Geometric(p_straggler), everyone else from
    Geometric(p_normal); draws are clamped at ``trunc`` (tail mass clamped,
    not dropped). The leading axis of ``shape`` is the source axis."""

    p_normal: float
    p_straggler: float = 0.1
    trunc: int = 63

    def sample(self, gen, shape):
        shape = tuple(shape)
        dev = gen.device
        u = torch.rand(shape, generator=gen, device=dev) * (1.0 - 1e-7) + 1e-7
        p_workers = shape[0] if shape else 1
        straggler = torch.randint(0, max(p_workers, 1), (), generator=gen,
                                  device=dev)
        if shape:
            src = torch.arange(shape[0], device=dev).reshape(
                (-1,) + (1,) * (len(shape) - 1))
        else:
            src = torch.zeros((), dtype=torch.int64, device=dev)
        p = torch.where(src == straggler,
                        torch.tensor(self.p_straggler, device=dev),
                        torch.tensor(self.p_normal, device=dev))
        draws = torch.floor(torch.log(u) / torch.log1p(-p)).to(torch.int64)
        return torch.clamp(draws, 0, self.trunc)

    @property
    def bound(self) -> int:
        return self.trunc

    @property
    def mean_total_delay(self) -> float:
        # Ignoring truncation and straggler mixing (diagnostic only).
        return 1.0 + (1.0 - self.p_normal) / self.p_normal


def matched_geometric(s: int, p_workers: int, p_straggler: float = 0.1,
                      trunc: int = 63) -> GeometricDelay:
    """Geometric model whose mean delay (straggler included) matches
    UniformDelay(s), per Appendix A.3."""
    target = (max(s, 1) - 1) / 2.0
    frac_strag = 1.0 / max(p_workers, 1)
    strag_mean = (1.0 - p_straggler) / p_straggler
    rest = (target - frac_strag * strag_mean) / max(1.0 - frac_strag, 1e-9)
    rest = max(rest, 1e-3)
    pn = 1.0 / (1.0 + rest)
    return GeometricDelay(p_normal=float(pn), p_straggler=p_straggler,
                          trunc=trunc)


def as_spec(x) -> Optional[DelaySpec]:
    """Coerce an engine ``delay=`` argument: specs pass through; raw
    ``[T, P]`` / ``[T]`` arrays become a :class:`Schedule`."""
    if x is None or isinstance(x, DelaySpec):
        return x
    from repro_torch.delays.schedule import Schedule  # schedule imports us
    return Schedule(x)
