"""Core: the paper's staleness simulation model (``staleness``), the
gradient-ring data-parallel steps (``stale_sync``), SSP clock semantics
(``ssp``) and coherence theory (``coherence``: the Definition-1 monitor,
the Theorem-1 stepsize and the coherence-gated controller). The delay
samplers of ``repro_torch.delays`` are re-exported here too, as the JAX
package's ``repro.core`` re-exports them."""
from repro_torch.delays.models import (
    ConstantDelay,
    DelayModel,
    GeometricDelay,
    UniformDelay,
    Zero,
    matched_geometric,
)
from repro_torch.core.staleness import (
    SimState,
    StalenessConfig,
    drain,
    draw_delay_matrix,
    init_sim_state,
    make_sim_step,
    sequential_reference,
)
from repro_torch.core.coherence import (
    CoherenceController,
    CoherenceState,
    init_coherence,
    observe,
    probe_gradient,
    theorem1_stepsize,
)
from repro_torch.core.stale_sync import (
    StaleSyncConfig,
    StaleTrainState,
    SyncTrainState,
    init_state,
    init_sync_state,
    make_stale_train_step,
    make_sync_train_step,
    make_sync_train_step_lean,
)
from repro_torch.core.ssp import (
    SSPConfig,
    sample_worker_durations,
    simulate_ssp_clocks,
    ssp_delay_schedule,
    ssp_throughput_model,
)
