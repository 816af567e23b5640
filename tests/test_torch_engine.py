"""Port parity and guards: repro_torch.engine (+ the experiment twin)
against repro.engine, and the port's two standing rules: it imports
nothing of JAX or ``repro``, and its entry points default to CUDA and raise
without it.

Curves: both packages train the same narrow MLP from the same weights,
batches and Schedule delays through ``build_engine`` + ``Trainer``. Losses
agree to fp32 roundoff (rtol 1e-5; Adam rtol 1e-4, see
test_torch_staleness); test accuracy is a count over 512 samples, where a
logit tie broken differently moves it by 1/512, so curves may differ by
2/512.
"""
import ast
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro.engine import EngineConfig as JConfig
from repro.engine import Hook as JHook
from repro.engine import Trainer as JTrainer
from repro.engine import build_engine as jbuild
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch import experiments
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.engine import EngineConfig, Hook, Trainer, build_engine
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
P = 4


@contextlib.contextmanager
def _one_rank_mesh():
    """A 1x1 DeviceMesh over a one-rank gloo group, torn down after."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup():
    data = synthetic.teacher_classification(seed=0, dim=32, n_train=2048,
                                            n_test=512)
    cfg = jmlp.MLPConfig(in_dim=32, hidden=16, depth=2)
    jp = jmlp.init(jax.random.PRNGKey(0), cfg)
    return data, jp, _table(8)


def _table(s):
    """A [T, P] Schedule over the UniformDelay(s) range r in [0, s-1]."""
    return np.random.default_rng(s).integers(0, max(s, 1), (40, P))


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_step(self, ctx):
        self.losses.append(float(ctx.metrics["loss"]))


def _jax_run(data, jp, table, algo, kernels, steps, target=None):
    eng = jbuild(jmlp.loss_fn, jopt.paper_default(algo),
                 JConfig(mode="simulate", num_workers=P,
                         delay=jdel.Schedule(table), kernels=kernels))
    state = eng.init(jax.random.PRNGKey(0), params=jp)
    xt, yt = data.x_test, data.y_test
    losses = []

    class Log(JHook):
        def on_step(self, ctx):
            losses.append(float(ctx.metrics["loss"]))

    res = JTrainer(eng, hooks=[Log()]).run(
        iter(ShardedBatches([data.x_train, data.y_train], P, 8, seed=0)),
        steps, state=state, eval_fn=lambda p: jmlp.accuracy(p, xt, yt),
        eval_every=5, target=target)
    return res, losses


@pytest.mark.parametrize("s", [0, 8, 16])
@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_engine_trainer_curves_match_jax(setup, algo, kernels, s):
    data, jp, _ = setup
    table = _table(s)
    jres, jlosses = _jax_run(data, jp, table, algo, kernels, 20)
    eng = build_engine(tmlp.loss_fn, topt.paper_default(algo),
                       EngineConfig(mode="simulate", num_workers=P,
                                    delay=tdel.Schedule(table),
                                    kernels=kernels), device="cpu")
    log = _Losses()
    xt, yt = torch.from_numpy(data.x_test), torch.from_numpy(data.y_test)
    res = Trainer(eng, hooks=[log]).run(
        iter(ShardedBatches([data.x_train, data.y_train], P, 8, seed=0)),
        20, params=params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
        eval_fn=lambda p: tmlp.accuracy(p, xt, yt), eval_every=5)
    rtol = 1e-5 if algo == "sgd" else 1e-4
    np.testing.assert_allclose(log.losses, jlosses, rtol=rtol)
    assert [b for b, _ in res.curve] == [b for b, _ in jres.curve]
    np.testing.assert_allclose([v for _, v in res.curve],
                               [v for _, v in jres.curve], atol=2 / 512)
    assert eng.meta["kernels"]["delivery"] == (
        "tree" if kernels == "off" else "packed")


def test_experiment_twin_batches_to_target_match_jax(setup):
    """experiments.dnn_experiment reaches the target after the same number
    of worker batches as the JAX engine + Trainer it twins."""
    data, jp, table = setup
    jres, _ = _jax_run(data, jp, table, "sgd", "off", 60, target=0.22)
    assert jres.converged
    res = experiments.dnn_experiment(
        depth=2, algo="sgd", s=8, workers=P, target_acc=0.22, batch=8,
        max_steps=60, eval_every=5, delay=tdel.Schedule(table),
        params=params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
        cfg=tmlp.MLPConfig(in_dim=32, hidden=16, depth=2), data=data,
        kernels="on", device="cpu")
    assert res.converged and res.row() == res.batches_to_target
    assert res.batches_to_target == jres.batches_to_target
    assert res.batches_to_target % P == 0


def test_trainer_logging_target_and_exhaustion(setup):
    data, jp, table = setup
    eng = build_engine(tmlp.loss_fn, topt.sgd(0.05),
                       EngineConfig(mode="simulate", num_workers=P, s=3),
                       device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batches = [b for _, b in zip(range(7), ShardedBatches(
        [data.x_train, data.y_train], P, 8))]
    res = Trainer(eng).run(batches, 100, params=params, log_every=2)
    assert [r["step"] for r in res.history] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) and r["bound"] == 2
               for r in res.history)
    assert eng.step_count(res.state) == 7 and not res.converged
    res = Trainer(eng).run(batches, 7, params=params, eval_every=1,
                           eval_fn=lambda p: -1.0, target=-2.0,
                           higher_better=False)
    assert res.batches_to_target is None
    res = Trainer(eng).run(batches, 7, params=params, eval_every=3,
                           eval_fn=lambda p: 1.0, target=0.5)
    assert res.converged and res.batches_to_target == 3 * P


def test_engine_surface(setup):
    _, jp, _ = setup
    eng = build_engine(tmlp.loss_fn, topt.paper_default("adam"),
                       EngineConfig(mode="simulate", num_workers=P, s=6,
                                    kernels="auto"), device="cpu")
    assert eng.meta["kernels"] == {"config": "auto", "delivery": "packed",
                                   "megakernel": "fused"}
    state = eng.init(0, params=params_from_jax(jax.tree.map(np.asarray, jp),
                                               "cpu"))
    assert state.bound == 5 and eng.batches_per_step == P
    assert state.inner.update_state["m"].shape == state.inner.pending[
        "arrived"].shape
    assert eng.with_staleness(state, 3).bound == 2
    assert eng.with_staleness(state, 0).bound == 0
    assert eng.with_staleness(state, 99).bound == 5
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((P, 8, 32)).astype(np.float32),
             rng.integers(0, 10, (P, 8)).astype(np.int32))
    state, metrics = eng.step(state, batch)
    assert metrics["loss"].dim() == 0
    rep = eng.dispatch_report()
    assert rep["decisions"]["stale_accum"] == "ref (cpu tensor)"
    assert rep["decisions"]["fused_adam"] == "ref (cpu tensor)"
    view = eng.params(state)
    assert [tuple(x.shape) for x in tm.tree_leaves(view)] == [
        tuple(x.shape) for x in jax.tree.leaves(jp)]
    mega_off = build_engine(tmlp.loss_fn, topt.paper_default("adam"),
                            EngineConfig(mode="simulate", num_workers=P, s=6,
                                         kernels="on", megakernel="off"),
                            device="cpu")
    assert mega_off.meta["kernels"]["megakernel"] == "off"
    with pytest.raises(ValueError, match="megakernel='on'"):
        build_engine(tmlp.loss_fn, topt.sgd(0.1),
                     EngineConfig(mode="simulate", num_workers=P, s=6,
                                  kernels="on", megakernel="on"),
                     device="cpu")
    with pytest.raises(ValueError, match="params="):
        eng.init(0)


@pytest.mark.parametrize("kw,mesh,item", [
    (dict(mode="stale-psum", s=2), "1x1", "A.12"),
    (dict(mode="ssp", s=2), "1x1", "A.12"),
    (dict(mode="sync"), "1x1", "A.12"),
    (dict(mode="stale-psum", s=2, server_side=True), None, "A.2"),
    (dict(mode="simulate", compress="topk:0.1", server_side=True), None,
     "A.2"),
    (dict(mode="simulate", server_side=True), None, "A.2")])
def test_unported_modes_and_options_raise(kw, mesh, item):
    """Every mode and compensation knob is ported. mesh= (A.12) is ported
    too: each A.12 case now steps on a 1x1 ``DeviceMesh`` over a one-rank
    gloo group, bitwise as the mesh-less engine (the many-rank runs are in
    ``test_torch_mesh_engine.py``). The server_side ablation (A.2) is
    ported: each A.2 case now builds as the JAX engine does. In simulate it
    needs a server_apply (both raise ValueError without one) and takes tree
    delivery; stale-psum accepts the flag and ignores it."""
    cfg = EngineConfig(num_workers=2, **kw)
    if item == "A.12":
        with _one_rank_mesh() as host_mesh:
            meshed = build_engine(tmlp.loss_fn, topt.sgd(0.1), cfg,
                                  mesh=host_mesh, device="cpu")
            plain = build_engine(tmlp.loss_fn, topt.sgd(0.1), cfg,
                                 device="cpu")
            params = tmlp.init(0, tmlp.MLPConfig(in_dim=8, hidden=4),
                               device="cpu")
            gen = torch.Generator().manual_seed(0)
            batch = (torch.randn(8, 8, generator=gen),
                     torch.randint(0, 10, (8,), generator=gen))
            a, b = meshed.init(0, params=params), plain.init(0, params=params)
            for _ in range(3):
                (a, ma), (b, mb) = meshed.step(a, batch), plain.step(b, batch)
                assert torch.equal(ma["loss"], mb["loss"])
            assert meshed.meta["mesh"] == {"data": 1, "model": 1}
            assert all(torch.equal(x, y) for x, y in zip(
                tm.tree_leaves(meshed.params(a)),
                tm.tree_leaves(plain.params(b))))
        return
    jcfg = JConfig(num_workers=2, **kw)
    apply_kw = {}
    if kw["mode"] == "simulate":
        with pytest.raises(ValueError, match="server_apply"):
            build_engine(tmlp.loss_fn, topt.sgd(0.1), cfg, device="cpu")
        with pytest.raises(ValueError, match="server_apply"):
            jbuild(jmlp.loss_fn, jopt.sgd(0.1), jcfg)
        apply_kw = dict(server_apply=lambda c, st, arrived: (c, st))
    eng = build_engine(tmlp.loss_fn, topt.sgd(0.1), cfg, device="cpu",
                       **apply_kw)
    jeng = jbuild(jmlp.loss_fn, jopt.sgd(0.1), jcfg, **apply_kw)
    assert eng.meta["kernels"] == jeng.meta["kernels"]
    assert eng.meta["kernels"]["delivery"] == "tree"


def test_server_side_engine_routes_and_run_engine_matches_jax(setup):
    """build_engine(simulate, server_side=True, server_apply=...) takes tree
    delivery under kernels="auto" (fallback "server_side transform") and
    refuses "on"; experiments.run_engine with a server_apply reaches the
    target after the same worker batches as benchmarks/common.py's."""
    sys.path.insert(0, str(REPO))
    from benchmarks import common
    from repro import treemath as jtm
    from repro.core import StalenessConfig as JStal
    from repro.optim import make_sgd_update_fn as jmake
    from repro_torch.core import StalenessConfig as TStal
    from repro_torch.optim import make_sgd_update_fn as tmake

    data, jp, table = setup
    tapply = lambda c, st, arrived: (tm.tree_axpy(0.05, arrived, c), st)
    japply = lambda c, st, arrived: (jtm.tree_axpy(0.05, arrived, c), st)
    tupd = tmake(tmlp.loss_fn, topt.sgd(1.0))    # ships -grad
    cfg = EngineConfig(mode="simulate", num_workers=P, s=8,
                       server_side=True, kernels="auto")
    eng = build_engine(None, None, cfg, update_fn=tupd, server_apply=tapply,
                       device="cpu")
    assert eng.meta["kernels"] == {
        "config": "auto", "delivery": "tree",
        "fallback": "server_side transform", "megakernel": "off",
        "megakernel_fallback": "optimizer has no Adam spec"}
    with pytest.raises(ValueError, match="server_side"):
        build_engine(tmlp.loss_fn, topt.sgd(1.0),
                     EngineConfig(mode="simulate", num_workers=P, s=8,
                                  server_side=True, kernels="on"),
                     server_apply=tapply, device="cpu")
    with pytest.raises(ValueError, match="server_side"):
        jbuild(jmlp.loss_fn, jopt.sgd(1.0),
               JConfig(mode="simulate", num_workers=P, s=8,
                       server_side=True, kernels="on"), server_apply=japply)

    xt, yt = data.x_test, data.y_test
    batches = lambda: iter(ShardedBatches([data.x_train, data.y_train], P, 8,
                                          seed=0))
    jres = common.run_engine(
        jmake(jmlp.loss_fn, jopt.sgd(1.0)), jp, jopt.sgd(1.0).init(jp),
        JStal(num_workers=P, delay=jdel.Schedule(table), server_side=True),
        batches(), lambda p: jmlp.accuracy(p, xt, yt), 0.22, True, 60, 5,
        server_apply=japply)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    txt, tyt = torch.from_numpy(xt), torch.from_numpy(yt)
    res = experiments.run_engine(
        tupd, tp, topt.sgd(1.0).init(tp),
        TStal(num_workers=P, delay=tdel.Schedule(table), server_side=True),
        batches(), lambda p: tmlp.accuracy(p, txt, tyt), 0.22, True, 60, 5,
        server_apply=tapply, device="cpu")
    assert jres.converged and res.converged
    assert res.batches_to_target == jres.batches_to_target
    np.testing.assert_allclose([v for _, v in res.curve],
                               [v for _, v in jres.curve], atol=2 / 512)


def test_config_validation_and_mesh():
    for bad in (dict(mode="async"), dict(num_workers=0), dict(s=-1),
                dict(kernels="yes"), dict(megakernel="maybe")):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    assert isinstance(EngineConfig(mode="simulate", delay=[[0, 1]]).delay,
                      tdel.Schedule)
    # As in the reference: sync is delay-free, ssp takes a Schedule or a
    # Trace.
    with pytest.raises(ValueError, match="delay-free"):
        EngineConfig(mode="sync", delay=[[0, 1]])
    assert EngineConfig(mode="sync", delay=tdel.Zero()).delay == tdel.Zero()
    with pytest.raises(ValueError, match="Schedule"):
        EngineConfig(mode="ssp", s=2, delay=tdel.UniformDelay(2))
    # An abstract mesh plans placements (A.12) and runs nothing.
    from repro_torch.sharding.rules import AbstractMesh
    planned = build_engine(tmlp.loss_fn, topt.sgd(0.1),
                           EngineConfig(mode="simulate"),
                           mesh=AbstractMesh(("data", "model"), (2, 1)),
                           device="cpu")
    with pytest.raises(ValueError, match="abstract mesh"):
        planned.init(0, params=tmlp.init(0, tmlp.MLPConfig(in_dim=8),
                                         device="cpu"))


# -- guards ---------------------------------------------------------------------

def test_port_sources_import_neither_jax_nor_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax"):
                    offenders.append(f"{path.name}: {name}")
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "for m in ('repro_torch.core.stale_sync', 'repro_torch.core.ssp', "
            "'repro_torch.core.coherence', 'repro_torch.compensate', "
            "'repro_torch.compensate.lr', 'repro_torch.compensate.sparsify', "
            "'repro_torch.compensate.__main__', "
            "'repro_torch.kernels.fused_update', "
            "'repro_torch.kernels.sparsify', 'repro_torch.kernels.coherence', "
            "'repro_torch.engine.hooks', 'repro_torch.checkpoint.checkpoint', "
            "'repro_torch.delays.trace', 'repro_torch.delays.multipod', "
            "'repro_torch.delays.parse', 'repro_torch.delays.__main__', "
            "'repro_torch.models.ssm', 'repro_torch.models.hybrid', "
            "'repro_torch.configs.mamba2_1p3b', "
            "'repro_torch.configs.zamba2_7b'):\n"
            "    assert m in sys.modules, m\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(mode="simulate", num_workers=2, s=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(tmlp.loss_fn, topt.sgd(0.1), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmlp.init(0, tmlp.MLPConfig(in_dim=4, hidden=4, depth=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        experiments.dnn_experiment(depth=1, algo="sgd", s=0, workers=1)
    # device="cpu" is the explicit way onto the CPU.
    eng = build_engine(tmlp.loss_fn, topt.sgd(0.1), cfg, device="cpu")
    assert eng.device == torch.device("cpu")
    state = eng.init(0, params=tmlp.init(0, tmlp.MLPConfig(4, 4, 1),
                                         device="cpu"))
    assert tm.tree_leaves(state.inner.caches)[0].device.type == "cpu"
