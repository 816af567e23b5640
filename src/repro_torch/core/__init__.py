"""Core: the paper's staleness simulation model (``staleness``). Coherence,
SSP and the gradient-ring modes follow in ROADMAP A.5 and A.7."""
from repro_torch.core.staleness import (
    SimState,
    StalenessConfig,
    drain,
    init_sim_state,
    make_sim_step,
    sequential_reference,
)
