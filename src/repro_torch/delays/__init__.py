"""repro_torch.delays: the DelaySpec protocol, the paper's samplers and
deterministic schedules (port of the parts of ``repro.delays`` the simulate
engine uses; trace, multipod and the CLI grammar are ROADMAP A.8)."""
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
from repro_torch.delays.schedule import Schedule, TableSource

Uniform = UniformDelay
Constant = ConstantDelay
Geometric = GeometricDelay

__all__ = [
    "ConstantDelay", "Constant", "DelayModel", "DelaySource", "DelaySpec",
    "GeometricDelay", "Geometric", "Schedule", "TableSource", "Uniform",
    "UniformDelay", "Zero", "as_spec", "matched_geometric",
]
