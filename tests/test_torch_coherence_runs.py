"""Port parity: the coherence monitor in training runs.

Both packages train the same narrow MLP from the same weights, batches and
Schedule delays through ``build_engine`` + ``Trainer`` with a
``CoherenceHook``: in ``simulate`` mode with the coherence-gated controller
(``engine.with_staleness``), and in ``stale-psum`` mode feeding the
Theorem-1 LR policy (``engine.with_lr_signals``). Then the experiment
twins against the benchmark harnesses at a tiny size, with delays that are
zero (``UniformDelay(s)`` for s <= 1), so the JAX harness is deterministic.

Losses agree to fp32 roundoff carried through training (rtol 1e-5 for SGD,
1e-4 for Adam, as in test_torch_engine); mu is a ratio of sums over the
probe gradient and agrees to 1e-4 (Adam: 1e-3); the controller's
allowed_s is equal, which the test guards by checking that no mu lies
within that tolerance of a threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import delays as jdel
from repro.core import coherence as jcoh
from repro.engine import CoherenceHook as JCoherenceHook
from repro.engine import EngineConfig as JConfig
from repro.engine import Hook as JHook
from repro.engine import Trainer as JTrainer
from repro.engine import build_engine as jbuild
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch import experiments
from repro_torch.convert import params_from_jax
from repro_torch.core import coherence as tcoh
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.engine import (CoherenceHook, EngineConfig, Hook, Trainer,
                                build_engine)
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt

P, STEPS, EVERY = 4, 24, 2
# Probed every 2 steps, this run's mu stays near 1 (0.96-1.19); thresholds
# inside that range make the controller both shrink and relax.
LO, HI = 1.01, 1.06


@pytest.fixture(scope="module")
def setup():
    data = synthetic.teacher_classification(seed=0, dim=32, n_train=2048,
                                            n_test=512)
    jp = jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(32, 16, 2))
    table = np.random.default_rng(8).integers(0, 8, (40, P))
    return data, jp, table


def _recorders(hook_cls):
    """A hook class that keeps each step's loss and, at each probe, the
    coherence hook's last reading."""
    class Rec(hook_cls):
        def __init__(self, coh_hook):
            self.coh, self.losses, self.probes = coh_hook, [], []

        def on_step(self, ctx):
            self.losses.append(float(ctx.metrics["loss"]))
            if (ctx.step + 1) % EVERY == 0:
                self.probes.append(dict(self.coh.last))
    return Rec


def _run_both(setup, mode, algo, make_ctl, lr_scale="none", kernels=False,
              flat=False):
    data, jp, table = setup
    probe = (data.x_train[:256], data.y_train[:256])
    dim = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    s = 8
    jeng = jbuild(jmlp.loss_fn, jopt.paper_default(algo),
                  JConfig(mode=mode, num_workers=P, s=s, lr_scale=lr_scale,
                          delay=jdel.Schedule(table)))
    jhook = JCoherenceHook(jmlp.loss_fn, tuple(map(jnp.asarray, probe)),
                           dim=dim, window=4, every=EVERY,
                           controller=make_ctl(jcoh))
    jrec = _recorders(JHook)(jhook)
    batches = ShardedBatches([data.x_train, data.y_train], P, 8, seed=0)
    JTrainer(jeng, hooks=[jhook, jrec]).run(
        batches.flat_iter() if flat else iter(batches), STEPS,
        state=jeng.init(jax.random.PRNGKey(0), params=jp))

    teng = build_engine(tmlp.loss_fn, topt.paper_default(algo),
                        EngineConfig(mode=mode, num_workers=P, s=s,
                                     lr_scale=lr_scale,
                                     delay=tdel.Schedule(table)),
                        device="cpu")
    thook = CoherenceHook(tmlp.loss_fn, probe, dim=dim, window=4,
                          every=EVERY, controller=make_ctl(tcoh),
                          kernels=kernels)
    trec = _recorders(Hook)(thook)
    batches = ShardedBatches([data.x_train, data.y_train], P, 8, seed=0)
    res = Trainer(teng, hooks=[thook, trec]).run(
        batches.flat_iter() if flat else iter(batches), STEPS,
        params=params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return jrec, trec, jhook, thook, res


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_gated_simulate_run_matches_jax(setup, algo, kernels):
    """CoherenceHook + CoherenceController on simulate: the same mu trace,
    the same allowed_s at every probe, the same losses."""
    ctl = lambda lib: lib.CoherenceController(s_max=8, lo=LO, hi=HI,
                                              patience=2)
    jrec, trec, jhook, thook, res = _run_both(setup, "simulate", algo, ctl,
                                              kernels=kernels)
    rtol, mu_tol = (1e-5, 1e-4) if algo == "sgd" else (1e-4, 1e-3)
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=rtol)
    jmu = np.array([p["mu"] for p in jrec.probes])
    np.testing.assert_allclose([p["mu"] for p in trec.probes], jmu,
                               rtol=mu_tol, atol=mu_tol)
    assert np.abs(jmu[:, None] - np.array([LO, HI])).min() > mu_tol
    assert ([p["allowed_s"] for p in trec.probes]
            == [p["allowed_s"] for p in jrec.probes])
    # The controller acted both ways and the engine saw its last verdict.
    allowed = [p["allowed_s"] for p in trec.probes]
    assert min(allowed) < 8 and any(b > a for a, b in zip(allowed,
                                                          allowed[1:]))
    assert res.state.bound == max(allowed[-1] - 1, 0)
    assert thook.mu_trace == [(EVERY * (i + 1), p["mu"])
                              for i, p in enumerate(trec.probes)]
    # D = 970; kernels=True pads the ring to the 2048 pack width.
    assert thook.monitor.history.shape == (4, 2048 if kernels else 970)


def test_theorem1_hook_on_stale_psum_matches_jax(setup):
    """With lr_scale="theorem1" the hook pushes mu and the secant L into
    the engine state; the LR factor, and so the losses, follow them."""
    jrec, trec, jhook, thook, res = _run_both(
        setup, "stale-psum", "sgd", lambda lib: None, lr_scale="theorem1",
        flat=True)
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    for key in ("mu", "lip", "grad_norm"):
        np.testing.assert_allclose([p[key] for p in trec.probes],
                                   [p[key] for p in jrec.probes], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    comp = res.state.comp
    assert float(comp["mu"]) == pytest.approx(thook.last["mu"])
    assert float(comp["lip"]) == pytest.approx(thook.last["lip"])
    assert thook.last["lip"] != 1.0    # the secant estimate moved


def test_coherence_trace_twin_matches_fig4_harness():
    from benchmarks import fig4_coherence
    want = fig4_coherence.coherence_trace(depth=1, algo="sgd", s=0,
                                          workers=2, steps=20, probe_every=5)
    jp = jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(depth=1))
    got = experiments.coherence_trace(
        1, "sgd", 0, workers=2, steps=20, probe_every=5,
        params=params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
        device="cpu")
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    np.testing.assert_allclose([m for _, m, _ in got],
                               [m for _, m, _ in want], rtol=1e-4)
    # Cosines are rounded to 4 places on both sides: equal up to one
    # rounding step.
    np.testing.assert_allclose([c for _, _, c in got],
                               [c for _, _, c in want], atol=1.5e-4)


def test_coherence_by_depth_twin_matches_fig5_rows(monkeypatch):
    """fig5_coherence_depth.main's rows, with its coherence_trace cut to a
    tiny deterministic run, against the port's twin on the same weights."""
    from benchmarks import fig4_coherence, fig5_coherence_depth
    kw = dict(workers=2, steps=16, probe_every=4)
    monkeypatch.setattr(
        fig5_coherence_depth, "coherence_trace",
        lambda depth, algo, s, steps: fig4_coherence.coherence_trace(
            depth=depth, algo=algo, s=0, **kw))
    want = fig5_coherence_depth.main(quick=True)
    params = {d: params_from_jax(jax.tree.map(np.asarray, jmlp.init(
        jax.random.PRNGKey(0), jmlp.MLPConfig(depth=d))), "cpu")
        for d in (0, 2)}
    got = experiments.coherence_by_depth(depths=(0, 2), s=0, params=params,
                                         device="cpu", **kw)
    assert [r[:2] for r in got] == [tuple(r[:2]) for r in want]
    np.testing.assert_allclose([r[2:] for r in got], [r[2:] for r in want],
                               atol=2e-4)


def test_grad_norm_trace_twin_matches_theorem1_harness():
    from benchmarks import theorem1_validation
    want = theorem1_validation.grad_norm_trace(1, steps=100)
    jp = jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(depth=1))
    got = experiments.grad_norm_trace(
        1, steps=100, params=params_from_jax(jax.tree.map(np.asarray, jp),
                                             "cpu"), device="cpu")
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got]),
                               np.array([r[1:] for r in want]), rtol=1e-5)
