"""Port parity: the ``stale-psum`` mode of repro_torch.engine against
repro.engine, plus the SSP clock schedule, the simulate engine under
compensation and the trainer's log columns (``ssp`` and ``sync`` are in
test_torch_ssp_sync.py, which shares this file's runners).

Both packages train the same narrow MLP (in 32, hidden 16, depth 2) with
P = 4 workers and s = 3 from the same weights and batches, for 6 steps,
through ``build_engine``; delays come from a ``[T, P]`` Schedule
(stale-psum) or from the SSP clock discipline over shared worker speeds
(ssp). Every ``kernels`` x ``megakernel`` route runs with each
compensation knob. The JAX side's packed steps reach its Pallas kernels in
interpret mode, as its own tests run them on the CPU.

Tolerances: losses and params are fp32-roundoff close (rtol 1e-5, atol
2e-5): Adam normalises each gradient element, so roundoff in an element
near zero moves its update by up to 2 * lr, and six steps at lr = 1e-3
stay inside atol 2e-5 here. Top-k thresholds are exact k-th magnitudes of
fp32-close accumulators, so the kept sets agree and the residuals compare
at the same tolerance. EF conservation (sent + resid == acc) and the
replay of the port against itself are bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro.core import ssp as jssp
from repro.engine import EngineConfig as JConfig
from repro.engine import build_engine as jbuild
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.core import ssp as tssp
from repro_torch.data import ShardedBatches
from repro_torch.engine import EngineConfig, Hook, Trainer, build_engine
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

P, S, STEPS = 4, 3, 6
TOL = dict(rtol=1e-5, atol=2e-5)
COMPS = {
    "dense": {},
    "topk": dict(compress="topk:0.25"),
    "topk_mom": dict(compress="topk:0.25", ef_momentum=0.5),
    "thresh": dict(compress="thresh:0.0005"),
    "inverse": dict(lr_scale="inverse"),
    "theorem1": dict(lr_scale="theorem1"),
}
ROUTES = [("off", "off"), ("off", "auto"), ("on", "off"), ("on", "auto")]


def _inputs():
    rng = np.random.default_rng(0)
    cfg = jmlp.MLPConfig(in_dim=32, hidden=16, depth=2)
    jp = jmlp.init(jax.random.PRNGKey(0), cfg)
    x = rng.standard_normal((STEPS, P * 8, 32)).astype(np.float32)
    y = rng.integers(0, 10, (STEPS, P * 8)).astype(np.int32)
    table = rng.integers(0, S, (8, P))
    table[0, 0] = S - 1
    speeds = rng.lognormal(0.0, 0.5, (16, P)).astype(np.float32)
    return jp, list(zip(x, y)), table, speeds


JP, BATCHES, TABLE, SPEEDS = _inputs()


def mode_kw(mode, table=TABLE, speeds=SPEEDS):
    """Delay config of each mode, as the same kwargs for both packages
    (the Schedule class differs)."""
    if mode == "stale-psum":
        return lambda delays: dict(s=S, delay=delays.Schedule(table))
    if mode == "ssp":
        return lambda delays: dict(s=S, ssp_speeds=speeds)
    return lambda delays: {}


def _np_tree(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _comp_np(comp):
    return {k: np.asarray(v) for k, v in comp.items()} if comp else {}


_JAX_CACHE = {}


def run_jax(mode, kernels, mega, comp, algo="adam", batches=None,
            extra=None):
    """Losses, final params and comp state of the JAX engine. Routes that
    resolve to the same JAX path (meta) share one run."""
    extra = extra or {}
    cfg = JConfig(mode=mode, num_workers=P, kernels=kernels, megakernel=mega,
                  **mode_kw(mode)(jdel), **COMPS[comp], **extra)
    eng = jbuild(jmlp.loss_fn, jopt.paper_default(algo), cfg)
    meta = eng.meta["kernels"]
    key = (mode, comp, algo, repr(sorted(extra.items())), meta["delivery"],
           meta.get("megakernel"))
    if batches is None and key in _JAX_CACHE:
        return _JAX_CACHE[key]
    state = eng.init(jax.random.PRNGKey(0), params=JP)
    losses = []
    for b in batches or BATCHES:
        state, m = eng.step(state, b)
        losses.append(float(m["loss"]))
    out = (np.array(losses), _np_tree(eng.params(state)),
           _comp_np(state.comp), eng.meta["kernels"])
    if batches is None:
        _JAX_CACHE[key] = out
    return out


def run_torch(mode, kernels, mega, comp, algo="adam", batches=None,
              extra=None, metrics_log=None):
    cfg = EngineConfig(mode=mode, num_workers=P, kernels=kernels,
                       megakernel=mega, **mode_kw(mode)(tdel),
                       **COMPS[comp], **(extra or {}))
    eng = build_engine(tmlp.loss_fn, topt.paper_default(algo), cfg,
                       device="cpu")
    state = eng.init(0, params=params_from_jax(jax.tree.map(np.asarray, JP),
                                               "cpu"))
    losses = []
    for b in batches or BATCHES:
        state, m = eng.step(state, b)
        losses.append(float(m["loss"]))
        if metrics_log is not None:
            metrics_log.append(m)
    comp_np = ({k: v.numpy() for k, v in state.comp.items()}
               if state.comp else {})
    return (np.array(losses), [x.numpy() for x in tm.tree_leaves(
        eng.params(state))], comp_np, eng.meta["kernels"])


def assert_parity(got, want, tol=TOL):
    losses, params, comp, meta = got
    jlosses, jparams, jcomp, jmeta = want
    assert meta.get("megakernel") == jmeta.get("megakernel")
    assert meta["delivery"] == jmeta["delivery"]
    np.testing.assert_allclose(losses, jlosses, **tol)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a, b, **tol)
    assert sorted(comp) == sorted(jcomp)
    for k in comp:
        np.testing.assert_allclose(comp[k], jcomp[k], **tol)


@pytest.mark.parametrize("comp", list(COMPS))
@pytest.mark.parametrize("kernels,mega", ROUTES)
def test_stale_psum_trajectories_match_jax(kernels, mega, comp):
    assert_parity(run_torch("stale-psum", kernels, mega, comp),
                  run_jax("stale-psum", kernels, mega, comp))


@pytest.mark.parametrize("comp", ["dense", "topk", "inverse"])
@pytest.mark.parametrize("kernels", ["off", "on"])
def test_ring_mode_sgd_matches_jax(kernels, comp):
    """SGD never takes the megakernel: the packed route is the
    three-dispatch one (sparsify_topk, stale_accum)."""
    assert_parity(run_torch("stale-psum", kernels, "auto", comp, algo="sgd"),
                  run_jax("stale-psum", kernels, "auto", comp, algo="sgd"))


@pytest.mark.parametrize("comp", ["dense", "topk", "topk_mom"])
@pytest.mark.parametrize("kernels,mega", [("off", "off"), ("on", "off"),
                                          ("on", "auto")])
def test_aggregate_form_matches_jax(kernels, mega, comp):
    """Theorem 1's aggregate form: one delayed aggregate per step from a
    ConstantDelay, with a [D] residual."""
    def extra(delays):
        return dict(per_worker_delays=False, delay=delays.ConstantDelay(2))
    cfg_kw = dict(mode="stale-psum", num_workers=P, s=S, kernels=kernels,
                  megakernel=mega, **COMPS[comp])
    jeng = jbuild(jmlp.loss_fn, jopt.paper_default("adam"),
                  JConfig(**cfg_kw, **extra(jdel)))
    teng = build_engine(tmlp.loss_fn, topt.paper_default("adam"),
                        EngineConfig(**cfg_kw, **extra(tdel)), device="cpu")
    jstate = jeng.init(jax.random.PRNGKey(0), params=JP)
    tstate = teng.init(0, params=params_from_jax(
        jax.tree.map(np.asarray, JP), "cpu"))
    for b in BATCHES:
        jstate, jm = jeng.step(jstate, b)
        tstate, tm_ = teng.step(tstate, b)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm["loss"]),
                                   **TOL)
        assert float(tm_["mean_staleness"]) == float(jm["mean_staleness"])
    for a, b in zip(tm.tree_leaves(teng.params(tstate)),
                    jax.tree.leaves(jeng.params(jstate))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if COMPS[comp]:
        assert tstate.comp["resid"].shape == jstate.comp["resid"].shape
        assert tstate.comp["resid"].dim() == 1
        np.testing.assert_allclose(tstate.comp["resid"].numpy(),
                                   np.asarray(jstate.comp["resid"]), **TOL)


@pytest.mark.parametrize("bound", [0, 1, 3, 6])
def test_ssp_delay_schedule_equals_jax(bound):
    rng = np.random.default_rng(bound)
    speeds = rng.lognormal(0.0, 0.6, (64, 5)).astype(np.float32)
    speeds[10:20] = speeds[10:20].round(1) + 0.5   # many exact ties
    want = np.asarray(jssp.ssp_delay_schedule(
        jssp.SSPConfig(num_workers=5, bound=bound), jax.numpy.asarray(speeds)))
    got = tssp.ssp_delay_schedule(tssp.SSPConfig(num_workers=5, bound=bound),
                                  speeds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jsim = jssp.simulate_ssp_clocks(jssp.SSPConfig(5, bound),
                                    jax.numpy.asarray(speeds))
    tsim = tssp.simulate_ssp_clocks(tssp.SSPConfig(5, bound), speeds)
    for k in ("finish_times", "start_times", "stalls"):
        np.testing.assert_array_equal(tsim[k].numpy(), np.asarray(jsim[k]))


def test_ssp_sampled_speeds_and_throughput_model():
    gen = torch.Generator().manual_seed(0)
    durs = tssp.sample_worker_durations(gen, 4000, 4, mean_dur=2.0, cv=0.5)
    assert durs.dtype == torch.float32 and durs.shape == (4000, 4)
    assert float(durs.mean()) == pytest.approx(2.0, rel=0.05)
    assert float(durs.std() / durs.mean()) == pytest.approx(0.5, rel=0.1)
    out = tssp.ssp_throughput_model(tssp.SSPConfig(4, 3), 1.0, 0.5,
                                    torch.Generator().manual_seed(1), 100)
    assert float(out["throughput_gain"]) >= 1.0
    eng = build_engine(tmlp.loss_fn, topt.sgd(0.1),
                       EngineConfig(mode="ssp", num_workers=4, s=2,
                                    ssp_steps=32), device="cpu")
    table = eng.meta["ssp_schedule"]
    assert table.shape == (32, 4) and int(table.max()) <= 2


def test_replay_is_bitwise():
    """Two runs of the port from the same inputs agree bit for bit, on the
    megakernel and on the three-dispatch route, with momentum EF."""
    for kernels, mega in (("on", "auto"), ("on", "off"), ("off", "off")):
        a = run_torch("stale-psum", kernels, mega, "topk_mom")
        b = run_torch("stale-psum", kernels, mega, "topk_mom")
        np.testing.assert_array_equal(a[0], b[0])
        for x, y in zip(a[1], b[1]):
            np.testing.assert_array_equal(x, y)
        for k in a[2]:
            np.testing.assert_array_equal(a[2][k], b[2][k])


def test_uncompensated_engine_carries_no_comp_state():
    eng = build_engine(tmlp.loss_fn, topt.paper_default("adam"),
                       EngineConfig(mode="stale-psum", num_workers=P, s=S,
                                    kernels="on"), device="cpu")
    state = eng.init(0, params=params_from_jax(jax.tree.map(np.asarray, JP),
                                               "cpu"))
    state, m = eng.step(state, BATCHES[0])
    assert state.comp == () and "sparsity" not in m and "lr_scale" not in m
    assert eng.meta["kernels"] == {"config": "on", "delivery": "packed",
                                   "megakernel": "fused"}


@pytest.mark.parametrize("algo,comp", [
    ("sgd", "topk"), ("sgd", "topk_mom"), ("adam", "thresh"),
    ("adam", "inverse"), ("adam", "theorem1")])
@pytest.mark.parametrize("kernels", ["off", "on"])
def test_simulate_compensation_matches_jax(kernels, algo, comp):
    """simulate with compress / lr_scale: per-source scaling and EF before
    the delivery ring, against the JAX engine (with Adam, kernels="on" is
    the fused step). Top-k runs with SGD: Adam's first deltas are all
    about +-lr, so their k-th magnitude is a tie that fp32 roundoff
    breaks."""
    batches = [b for _, b in zip(range(STEPS), ShardedBatches(
        [BATCHES[0][0].repeat(4, 0), BATCHES[0][1].repeat(4, 0)], P, 8,
        seed=0))]

    def cfg_kw(delays):
        return dict(mode="simulate", num_workers=P, kernels=kernels,
                    delay=delays.Schedule(TABLE), **COMPS[comp])
    jeng = jbuild(jmlp.loss_fn, jopt.paper_default(algo),
                  JConfig(**cfg_kw(jdel)))
    teng = build_engine(tmlp.loss_fn, topt.paper_default(algo),
                        EngineConfig(**cfg_kw(tdel)), device="cpu")
    jstate = jeng.init(jax.random.PRNGKey(0), params=JP)
    tstate = teng.init(0, params=params_from_jax(
        jax.tree.map(np.asarray, JP), "cpu"))
    for b in batches:
        jstate, jm = jeng.step(jstate, b)
        tstate, tm_ = teng.step(tstate, b)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm["loss"]),
                                   **TOL)
        for k in ("sparsity", "lr_scale"):
            if k in jm:
                np.testing.assert_allclose(float(tm_[k]), float(jm[k]),
                                           rtol=1e-6)
    for a, b in zip(tm.tree_leaves(teng.params(tstate)),
                    jax.tree.leaves(jeng.params(jstate))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for k, v in jstate.comp.items():
        np.testing.assert_allclose(tstate.comp[k].numpy(), np.asarray(v),
                                   **TOL)


def test_trainer_logs_staleness_and_compensation_columns():
    class Seen(Hook):
        def __init__(self):
            self.stale = []

        def on_step(self, ctx):
            self.stale.append(float(ctx.metrics["mean_staleness"]))

    eng = build_engine(tmlp.loss_fn, topt.paper_default("adam"),
                       EngineConfig(mode="stale-psum", num_workers=P, s=S,
                                    delay=tdel.Schedule(TABLE), kernels="on",
                                    compress="topk:0.25",
                                    lr_scale="inverse"), device="cpu")
    seen = Seen()
    res = Trainer(eng, hooks=[seen]).run(
        BATCHES, STEPS, params=params_from_jax(jax.tree.map(np.asarray, JP),
                                               "cpu"), log_every=3)
    assert [r["step"] for r in res.history] == [3, 6]
    row = res.history[-1]
    assert row["mean_staleness"] == pytest.approx(seen.stale[-1])
    assert row["mean_total_delay"] == round(1.0 + np.mean(seen.stale), 4)
    assert 0.7 < row["sparsity"] < 0.8          # topk:0.25 keeps ~25%
    assert row["lr_scale"] == round(1.0 / (1.0 + seen.stale[-1]), 6)
    assert row["bound"] == S - 1
    sync = build_engine(tmlp.loss_fn, topt.sgd(0.1),
                        EngineConfig(mode="sync", num_workers=P),
                        device="cpu")
    res = Trainer(sync).run(BATCHES, 2, params=params_from_jax(
        jax.tree.map(np.asarray, JP), "cpu"), log_every=1)
    assert set(res.history[0]) == {"step", "wall_s", "loss"}
