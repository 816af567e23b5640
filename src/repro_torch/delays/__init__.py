"""repro_torch.delays: one delay subsystem for every engine mode (port of
``repro.delays``).

A :class:`DelaySpec` realizes to a per-step :class:`DelaySource`
(``delays(gen, step, shape)``) with an explicit ``bound`` that sizes the
delivery ring. ``EngineConfig(delay=spec)`` is honoured by all four engine
modes.

    delays.Uniform(s)                 # the paper's Categorical(0..s-1)
    delays.Geometric(...)             # Appendix-A.3 straggler mix
    delays.Constant(d), delays.Zero()
    delays.Schedule(table)            # deterministic [T, P] / [T] tables
    delays.Trace(path, bound=s)       # measured wall-times -> SSP clocks
    delays.MultiPod(pod_of, intra=..., inter=...)   # topology composition
    delays.parse_spec("multipod:2:8", s=8, num_workers=4)   # CLI grammar
"""
from repro_torch.delays.models import (
    ConstantDelay,
    DelayModel,
    DelaySource,
    DelaySpec,
    GeometricDelay,
    UniformDelay,
    Zero,
    as_spec,
    matched_geometric,
)
from repro_torch.delays.multipod import MultiPod, pods_of
from repro_torch.delays.parse import parse_spec
from repro_torch.delays.schedule import Schedule, TableSource
from repro_torch.delays.trace import Trace, read_trace, record_trace

Uniform = UniformDelay
Constant = ConstantDelay
Geometric = GeometricDelay

__all__ = [
    "ConstantDelay", "Constant", "DelayModel", "DelaySource", "DelaySpec",
    "GeometricDelay", "Geometric", "MultiPod", "Schedule", "TableSource",
    "Trace", "Uniform", "UniformDelay", "Zero", "as_spec",
    "matched_geometric", "parse_spec", "pods_of", "read_trace",
    "record_trace",
]
