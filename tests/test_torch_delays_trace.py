"""Port parity: the trace, multi-pod and CLI-grammar delay specs of
repro_torch.delays against repro.delays, and the engines that take them.

Trace tables go through each package's SSP clock simulation in fp32 and
compare element for element. MultiPod is compared on deterministic
sub-specs (``Schedule``, ``Constant``); its samplers draw from a
``torch.Generator`` and are checked by property. Engine losses agree to
fp32 roundoff (rtol 1e-5, SGD).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro.engine import EngineConfig as JConfig
from repro.engine import Trainer as JTrainer
from repro.engine import TraceRecorderHook as JTraceRecorderHook
from repro.engine import build_engine as jbuild
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch.convert import params_from_jax
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.engine import (EngineConfig, TraceRecorderHook, Trainer,
                                build_engine)
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
P = 4


def _durations(t, p, seed):
    return np.random.default_rng(seed).lognormal(0.0, 0.6, size=(t, p))


# -- Trace -------------------------------------------------------------------

@pytest.mark.parametrize("p,bound", [(1, 2), (3, 4), (4, 1)])
def test_trace_roundtrip_and_table_match_jax(tmp_path, p, bound):
    """record -> read recovers the durations exactly, the files are the
    same format in both packages, and the port's table equals JAX's."""
    path = str(tmp_path / "t.jsonl")
    durations = _durations(16, p, seed=p)
    tdel.record_trace(path, durations, meta={"src": "test"})
    back, header = jdel.read_trace(path)            # JAX reads the port's
    np.testing.assert_array_equal(back, durations)
    assert header == {"trace_version": 1, "num_workers": p, "src": "test"}
    jpath = str(tmp_path / "j.jsonl")
    jdel.record_trace(jpath, durations, meta={"src": "test"})
    assert Path(jpath).read_text() == Path(path).read_text()
    got = tdel.Trace(path, bound=bound).schedule().table
    want = np.asarray(jdel.Trace(path, bound=bound).schedule().table)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tdel.Trace(path, bound=bound).schedule().table)
    assert tdel.Trace(path, bound=bound).mean_total_delay == pytest.approx(
        jdel.Trace(path, bound=bound).mean_total_delay)


def test_trace_broadcast_bound_and_errors(tmp_path):
    path = str(tmp_path / "t1.jsonl")
    tdel.record_trace(path, _durations(10, 1, seed=1)[:, 0])   # 1 worker
    src = tdel.Trace(path, bound=3).realize(num_workers=4)     # broadcast
    d = src.delays(torch.Generator(), 5, (4,))
    assert d.shape == (4,) and 0 <= int(d.min()) and int(d.max()) <= 3
    with pytest.raises(ValueError, match="bound"):
        tdel.Trace(path).schedule()
    multi = str(tmp_path / "t3.jsonl")
    tdel.record_trace(multi, _durations(5, 3, seed=2))
    with pytest.raises(ValueError, match="workers"):
        tdel.Trace(multi, bound=2).schedule(num_workers=4)
    for bad in ([[1.0, -1.0]], np.zeros((0, 2))):
        with pytest.raises(ValueError):
            tdel.record_trace(str(tmp_path / "bad.jsonl"), bad)
    gap = tmp_path / "gap.jsonl"
    gap.write_text('{"step": 0, "durations": [1.0]}\n'
                   '{"step": 2, "durations": [1.0]}\n')
    with pytest.raises(ValueError, match="non-contiguous"):
        tdel.read_trace(str(gap))


def test_trace_recorder_hook_matches_jax_format(tmp_path):
    """A live Trainer run records a trace both packages replay; the header
    and shape are the JAX hook's."""
    def loss(params, batch):
        x, y = batch
        pred = torch.einsum("...bd,...d->...b", x, params["w"])
        return ((pred - y) ** 2).mean(dim=-1)

    x = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)
    batch = (x, x @ np.ones(4, np.float32))
    path = str(tmp_path / "run.jsonl")
    eng = build_engine(loss, topt.sgd(0.05),
                       EngineConfig(mode="sync", num_workers=2), device="cpu")
    Trainer(eng, hooks=[TraceRecorderHook(path)]).run(
        iter([batch] * 4), 4, params={"w": torch.zeros(4)})
    jpath = str(tmp_path / "jrun.jsonl")
    jeng = jbuild(lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2),
                  jopt.sgd(0.05), JConfig(mode="sync", num_workers=2))
    JTrainer(jeng, hooks=[JTraceRecorderHook(jpath)]).run(
        iter([batch] * 4), 4,
        state=jeng.init(jax.random.PRNGKey(0), params={"w": jnp.zeros(4)}))
    durations, header = tdel.read_trace(path)
    jdur, jheader = jdel.read_trace(jpath)
    assert durations.shape == jdur.shape == (4, 2)
    assert (durations > 0).all() and header == jheader
    sched = tdel.Trace(path, bound=2).schedule(num_workers=2)
    assert sched.bound <= 2
    np.testing.assert_array_equal(
        sched.table,
        np.asarray(jdel.Trace(path, bound=2).schedule(num_workers=2).table))


# -- MultiPod ----------------------------------------------------------------

@pytest.mark.parametrize("form", ["per_worker", "matrix"])
@pytest.mark.parametrize("server_pod", [0, 1])
def test_multipod_schedule_subspecs_match_jax(form, server_pod):
    """With deterministic sub-specs the port's delays equal JAX's at every
    step, in the (P,) stale-psum form and the (P, P) simulate form."""
    rng = np.random.default_rng(server_pod)
    intra = rng.integers(0, 3, (6, P))
    inter = rng.integers(0, 5, (6, P))
    kw = dict(pod_of=(0, 0, 1, 1), server_pod=server_pod)
    tsrc = tdel.MultiPod(intra=tdel.Schedule(intra),
                         inter=tdel.Schedule(inter), **kw).realize(
                             num_workers=P)
    jsrc = jdel.MultiPod(intra=jdel.Schedule(intra),
                         inter=jdel.Schedule(inter), **kw).realize(
                             num_workers=P)
    shape = (P,) if form == "per_worker" else (P, P)
    gen, key = torch.Generator(), jax.random.PRNGKey(0)
    assert tsrc.bound == jsrc.bound
    for step in range(8):
        np.testing.assert_array_equal(
            tsrc.delays(gen, step, shape).numpy(),
            np.asarray(jsrc.delays(key, step, shape)))


def test_multipod_constant_composition_and_mean():
    spec = tdel.MultiPod(pod_of=(0, 0, 1, 1), intra=tdel.Constant(1),
                         inter=tdel.Constant(3))
    assert spec.bound == 4 and spec.num_pods == 2 and spec.num_workers == 4
    src = spec.realize(num_workers=4)
    pods = np.array([0, 0, 1, 1])
    cross = pods[:, None] != pods[None, :]
    np.testing.assert_array_equal(
        src.delays(torch.Generator(), 0, (4, 4)).numpy(),
        np.where(cross, 4, 1))
    np.testing.assert_array_equal(
        src.delays(torch.Generator(), 0, (4,)).numpy(),
        np.where(pods != 0, 4, 1))
    jspec = jdel.MultiPod(pod_of=(0, 0, 1, 1), intra=jdel.Uniform(3),
                          inter=jdel.Uniform(5))
    tspec = tdel.MultiPod(pod_of=(0, 0, 1, 1), intra=tdel.Uniform(3),
                          inter=tdel.Uniform(5))
    assert tspec.mean_total_delay == pytest.approx(jspec.mean_total_delay)


def test_multipod_sampler_properties():
    """Sampled sub-specs: delays stay in [0, intra + inter], same-pod pairs
    pay no inter-pod delay, and the cross-pod mean adds inter's mean."""
    spec = tdel.MultiPod(pod_of=tdel.pods_of(8, 2), intra=tdel.Zero(),
                         inter=tdel.Uniform(5))
    src = spec.realize(num_workers=8)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([src.delays(gen, t, (8, 8)) for t in range(400)])
    pods = torch.tensor(spec.pod_of)
    same = pods[:, None] == pods[None, :]
    assert int(draws[:, same].abs().max()) == 0
    cross = draws[:, ~same]
    assert int(cross.min()) >= 0 and int(cross.max()) <= spec.bound == 4
    assert float(cross.float().mean()) == pytest.approx(2.0, abs=0.1)


def test_multipod_errors():
    spec = tdel.MultiPod(pod_of=(0, 1), intra=tdel.Zero(),
                         inter=tdel.Uniform(2))
    with pytest.raises(ValueError, match="aggregate"):
        spec.realize(num_workers=2).delays(torch.Generator(), 0, ())
    with pytest.raises(ValueError, match="workers"):
        spec.realize(num_workers=3)
    with pytest.raises(ValueError, match="evenly"):
        tdel.pods_of(5, 2)
    with pytest.raises(ValueError, match="at least one"):
        tdel.MultiPod(pod_of=(), intra=tdel.Zero(), inter=tdel.Zero())
    with pytest.raises(ValueError, match="per_worker_delays"):
        build_engine(tmlp.loss_fn, topt.sgd(0.1),
                     EngineConfig(mode="stale-psum", num_workers=2, s=3,
                                  delay=spec, per_worker_delays=False),
                     device="cpu")


# -- CLI grammar -------------------------------------------------------------

def _described(spec):
    """(class name, fields) with nested specs described the same way."""
    fields = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        fields[f.name] = (_described(v) if dataclasses.is_dataclass(v)
                          else v)
    return type(spec).__name__, fields


_GRAMMAR = [
    ("uniform", dict(s=6)), ("uniform:3", dict(s=0)), ("uniform:0", dict(s=6)),
    ("uniform", dict(s=0)), ("zero", dict(s=9)), ("constant:0", {}),
    ("constant:7", {}), ("geometric", dict(s=8, num_workers=4)),
    ("geometric:5", dict(s=8, num_workers=4)),
    ("geometric", dict(s=0, num_workers=4)),
    ("geometric:5", dict(s=0, num_workers=4)),
    ("multipod:2", dict(s=8, num_workers=4)),
    ("multipod:2:0:0", dict(num_workers=4)),
    ("multipod:2:4", dict(num_workers=4)),
    ("multipod:2:4:2", dict(num_workers=4)),
    ("multipod:2", dict(s=0, num_workers=4)),
    ("multipod:4:3:1", dict(s=2, num_workers=8)),
    ("trace:/tmp/x.jsonl:5", {}), ("trace:/tmp/x.jsonl", {}),
    ("trace:/tmp/x.jsonl", dict(s=3)), (r"trace:C:\runs\t.jsonl:8", {}),
    (r"trace:C:\runs\t.jsonl", dict(s=4)),
    ("trace:http://host:8080/t.jsonl", dict(s=2)), (" uniform:2 ", {}),
]


@pytest.mark.parametrize("text,kw", _GRAMMAR)
def test_parse_spec_matches_jax(text, kw):
    assert (_described(tdel.parse_spec(text, **kw))
            == _described(jdel.parse_spec(text, **kw)))


@pytest.mark.parametrize("text,kw,match", [
    ("nonsense", {}, "grammar"), ("constant:notanint", {}, "bad delay spec"),
    ("constant", {}, "bad delay spec"), ("multipod", {}, "bad delay spec"),
    ("multipod:3", dict(num_workers=4), "bad delay spec"),
    ("trace:", {}, "path"), ("trace::5", {}, "path")])
def test_parse_spec_errors_match_jax(text, kw, match):
    with pytest.raises(ValueError, match=match):
        tdel.parse_spec(text, **kw)
    with pytest.raises(ValueError, match=match):
        jdel.parse_spec(text, **kw)


# -- engines on the new specs -------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    data = synthetic.teacher_classification(seed=0, dim=32, n_train=2048,
                                            n_test=512)
    jp = jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(32, 16, 2))
    return data, jp


def _losses_both(setup, mode, jdelay, tdelay, s, steps=12):
    data, jp = setup
    jeng = jbuild(jmlp.loss_fn, jopt.sgd(0.05),
                  JConfig(mode=mode, num_workers=P, s=s, delay=jdelay))
    teng = build_engine(tmlp.loss_fn, topt.sgd(0.05),
                        EngineConfig(mode=mode, num_workers=P, s=s,
                                     delay=tdelay), device="cpu")
    jst = jeng.init(jax.random.PRNGKey(0), params=jp)
    tst = teng.init(0, params=params_from_jax(jax.tree.map(np.asarray, jp),
                                              "cpu"))
    batches = ShardedBatches([data.x_train, data.y_train], P, 8, seed=0)
    it = iter(batches) if mode == "simulate" else batches.flat_iter()
    jl, tl = [], []
    for _ in range(steps):
        b = next(it)
        jst, jm = jeng.step(jst, b)
        tst, tm_ = teng.step(tst, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm_["loss"]))
    return jeng, teng, jl, tl


@pytest.mark.parametrize("mode,bound,s", [("ssp", None, 3), ("ssp", 2, 3),
                                          ("stale-psum", 3, 4),
                                          ("simulate", 3, 4)])
def test_engine_on_trace_matches_jax(setup, tmp_path, mode, bound, s):
    path = str(tmp_path / "t.jsonl")
    tdel.record_trace(path, _durations(20, P, seed=5))
    jeng, teng, jl, tl = _losses_both(setup, mode, jdel.Trace(path, bound),
                                      tdel.Trace(path, bound), s)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    if mode == "ssp":
        np.testing.assert_array_equal(
            np.asarray(teng.meta["ssp_schedule"]),
            np.asarray(jeng.meta["ssp_schedule"]))


def test_trace_needs_a_bound_outside_ssp(tmp_path):
    for mode in ("simulate", "stale-psum"):
        with pytest.raises(ValueError, match="bound"):
            EngineConfig(mode=mode, num_workers=P, s=3,
                         delay=tdel.Trace("x.jsonl"))
    assert EngineConfig(mode="ssp", s=3,
                        delay=tdel.Trace("x.jsonl")).delay.bound is None


@pytest.mark.parametrize("mode", ["stale-psum", "simulate"])
def test_engine_on_multipod_matches_jax(setup, mode):
    """MultiPod through the sampled-delay path: (P,) in stale-psum, (P, P)
    in simulate, with Schedule sub-specs."""
    rng = np.random.default_rng(11)
    intra, inter = rng.integers(0, 2, (7, P)), rng.integers(0, 3, (7, P))
    mk = lambda lib: lib.MultiPod(pod_of=(0, 0, 1, 1),
                                  intra=lib.Schedule(intra),
                                  inter=lib.Schedule(inter))
    jeng, teng, jl, tl = _losses_both(setup, mode, mk(jdel), mk(tdel), s=4)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_delays_smoke_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.delays", "--cpu"],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "DELAYS_SMOKE_OK"
