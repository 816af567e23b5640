"""Port parity: the ``ssp`` and ``sync`` modes of repro_torch.engine
against repro.engine, over every ``kernels`` x ``megakernel`` route and
compensation knob, with the runners and tolerances of
test_torch_stale_sync.py (see there).

``ssp`` derives both packages' delay tables from the same worker speeds;
``sync`` runs at the narrow width where the JAX package's packed sync tail
fuses (4 * D_pad <= 2^18), so its megakernel route is held against the
JAX megakernel.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import stale_sync as jss
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.core import stale_sync as tss
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt
from test_torch_stale_sync import (BATCHES, COMPS, JP, P, ROUTES, S, TOL,
                                   assert_parity, run_jax, run_torch)

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)


@pytest.mark.parametrize("comp", list(COMPS))
@pytest.mark.parametrize("kernels,mega", ROUTES)
@pytest.mark.parametrize("mode", ["ssp", "sync"])
def test_ssp_and_sync_trajectories_match_jax(mode, kernels, mega, comp):
    got = run_torch(mode, kernels, mega, comp)
    assert_parity(got, run_jax(mode, kernels, mega, comp))
    if mode == "sync" and COMPS[comp].get("compress"):
        assert got[2]["resid"].ndim == 1     # one aggregate stream


def test_sync_factor_is_the_schedule_factor():
    """Staleness is 0 in sync: inverse leaves the stepsize as it is, so the
    inverse run is the dense run."""
    dense = run_torch("sync", "on", "auto", "dense")
    inv = run_torch("sync", "on", "auto", "inverse")
    np.testing.assert_array_equal(dense[0], inv[0])


@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_sync_step_over_stale_state_matches_jax(algo):
    """``make_sync_train_step``: the synchronous step over a
    :class:`StaleTrainState` (the dry-run baseline) trains as JAX's does and
    carries the ring along untouched. Tolerance: TOL (fp32 roundoff)."""
    jopt_, topt_ = jopt.paper_default(algo), topt.paper_default(algo)
    jstate = jss.init_state(JP, jopt_, jss.StaleSyncConfig(num_workers=P,
                                                           s=S),
                            jax.random.PRNGKey(0))
    tstate = tss.init_state(
        params_from_jax(jax.tree.map(np.asarray, JP), "cpu"), topt_,
        tss.StaleSyncConfig(num_workers=P, s=S), 0)
    jstep = jax.jit(jss.make_sync_train_step(jmlp.loss_fn, jopt_))
    tstep = tss.make_sync_train_step(tmlp.loss_fn, topt_)
    for x, y in BATCHES[:3]:
        jstate, jm = jstep(jstate, (x, y))
        tstate, tm_ = tstep(tstate, (torch.from_numpy(x),
                                     torch.from_numpy(y).long()))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm[key]), **TOL)
    assert tstate.step == int(jstate.step) == 3
    for a, b in zip(tm.tree_leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert all(not buf.any() for buf in tm.tree_leaves(tstate.gbuf))
