"""The paper's experiments on the port.

* ``dnn_experiment`` (twin of ``benchmarks/common.py::_run_sim`` and
  ``dnn_experiment``): a simulate-mode engine and a Trainer, stepped until
  the target accuracy (or the budget), reporting batches-to-target, the
  paper's primary measurement (Fig. 1(e)(f); with ``matched_geometric``
  delays, Fig. 4(c)).
* ``coherence_trace`` and ``coherence_by_depth`` (twins of
  ``benchmarks/fig4_coherence.py::coherence_trace`` and the rows of
  ``benchmarks/fig5_coherence_depth.py::main``): gradient coherence over
  training (Fig. 4(a)(b)) and against depth (Fig. 5).
* ``grad_norm_trace`` (twin of ``benchmarks/theorem1_validation.py``): the
  probe gradient norm under the Theorem-1 stepsize.

Every harness takes ``params``/``data`` overrides (pass
``convert.params_from_jax`` of ``repro``'s init for identical weights) and a
``delay`` override (a deterministic spec, where runs are compared).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import numpy as np

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.core import coherence as coh
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.delays.models import DelayModel, UniformDelay
from repro_torch.engine import EngineConfig, Trainer, build_engine
from repro_torch.models import mlp
from repro_torch.optim import optimizers as optlib
from repro_torch.optim.schedules import theorem1


@dataclasses.dataclass
class ExperimentResult:
    batches_to_target: Optional[int]   # None = did not converge in budget
    curve: list                        # [(batches_processed, metric), ...]
    converged: bool
    wall_s: float

    def row(self):
        return self.batches_to_target if self.converged else -1


def _run_sim(loss_fn, opt, params, workers, delay, batches, eval_fn, target,
             higher_better, max_steps, eval_every, seed,
             loss_takes_key=False, kernels="auto",
             device=None) -> ExperimentResult:
    """A simulate-mode engine + Trainer, as every figure experiment runs."""
    ecfg = EngineConfig(mode="simulate", num_workers=workers, delay=delay,
                        loss_takes_key=loss_takes_key, kernels=kernels)
    engine = build_engine(loss_fn, opt, ecfg, device=device)
    state = engine.init(seed, params=params)
    res = Trainer(engine).run(batches, max_steps, state=state,
                              eval_fn=eval_fn, eval_every=eval_every,
                              target=target, higher_better=higher_better)
    return ExperimentResult(res.batches_to_target, res.curve, res.converged,
                            res.wall_s)


def dnn_experiment(depth: int, algo: str, s: int, workers: int,
                   target_acc: float = 0.88, batch: int = 32,
                   max_steps: int = 6000, seed: int = 0,
                   delay: Optional[DelayModel] = None, lr=None,
                   eval_every: int = 25, kernels: str = "auto",
                   params=None, cfg: Optional[mlp.MLPConfig] = None,
                   data=None, device=None) -> ExperimentResult:
    """DNN/MLR on the synthetic-MNIST stand-in (paper Fig. 1(e)(f), Fig. 2).

    Same data, batches and hyperparameters as the JAX harness. ``params``
    overrides the port's own initialiser (pass ``convert.params_from_jax``
    of ``repro``'s init for identical weights); ``cfg`` and ``data``
    override the model width and dataset (tests use narrow ones).
    ``kernels`` defaults to the packed kernel path."""
    dev = device_lib.resolve(device)
    data = data if data is not None else synthetic.teacher_classification(seed=0)
    cfg_m = cfg or mlp.MLPConfig(depth=depth)
    if params is None:
        params = mlp.init(seed, cfg_m, device=dev)
    opt = optlib.paper_default(algo, lr=lr)
    batches = ShardedBatches([data.x_train, data.y_train], workers, batch,
                             seed=seed)
    xt = torch.as_tensor(data.x_test, device=dev)
    yt = torch.as_tensor(data.y_test, device=dev)
    eval_fn = lambda p: mlp.accuracy(p, xt, yt)
    return _run_sim(mlp.loss_fn, opt, params, workers,
                    delay or UniformDelay(s), iter(batches), eval_fn,
                    target_acc, True, max_steps, eval_every, seed,
                    kernels=kernels, device=dev)


def _probe(data, dev):
    """Fig. 4's probe set: the first 1000 training samples, on ``dev``."""
    return (torch.as_tensor(data.x_train[:1000], device=dev),
            torch.as_tensor(data.y_train[:1000], device=dev))


def coherence_trace(depth: int, algo: str, s: int, workers: int = 8,
                    steps: int = 1500, probe_every: int = 10,
                    window: int = 8, seed: int = 0, *, params=None,
                    data=None, delay: Optional[DelayModel] = None,
                    kernels: str = "off", device=None) -> list:
    """Train a DNN under the simulate engine while recording
    cos(g_k, g_{k-m}): a list of ``(step, mu, cos_by_lag)`` every
    ``probe_every`` steps. ``kernels`` routes the engine, and with "on" or
    "auto" the Definition-1 reduction also runs through
    ``dispatch.coherence_dots``."""
    dev = device_lib.resolve(device)
    data = data if data is not None else synthetic.teacher_classification(seed=0)
    if params is None:
        params = mlp.init(seed, mlp.MLPConfig(depth=depth), device=dev)
    engine = build_engine(mlp.loss_fn, optlib.paper_default(algo),
                          EngineConfig(mode="simulate", num_workers=workers,
                                       delay=delay or UniformDelay(s),
                                       kernels=kernels), device=dev)
    state = engine.init(seed, params=params)
    probe = _probe(data, dev)
    monitor = coh.init_coherence(tm.tree_size(params), window, device=dev)
    batches = iter(ShardedBatches([data.x_train, data.y_train], workers, 32,
                                  seed=seed))
    trace = []
    for t in range(steps):
        state, _ = engine.step(state, next(batches))
        if (t + 1) % probe_every == 0:
            g = coh.probe_gradient(mlp.loss_fn, engine.params(state), probe)
            monitor, out = coh.observe(monitor, g, kernels=kernels != "off")
            trace.append((t + 1, float(out["mu"]),
                          [round(float(c), 4) for c in out["cos_by_lag"]]))
    return trace


def coherence_by_depth(depths=(0, 1, 2, 4), steps: int = 1200, s: int = 4,
                       params: Optional[dict] = None, **trace_kw) -> list:
    """Fig. 5's rows: for each depth, ``("coherence_by_depth", depth,
    mean mu, mean cos at lag 1..window)`` over the second half of a
    ``coherence_trace`` (SGD). ``params`` maps a depth to its initial
    weights; ``trace_kw`` goes to ``coherence_trace``."""
    rows = []
    for depth in depths:
        trace = coherence_trace(depth=depth, algo="sgd", s=s, steps=steps,
                                params=(params or {}).get(depth), **trace_kw)
        half = trace[len(trace) // 2:]
        lags = np.mean(np.array([t[2] for t in half]), axis=0)
        mu = float(np.mean([t[1] for t in half]))
        rows.append(("coherence_by_depth", depth, round(mu, 4),
                     *[round(float(x), 4) for x in lags]))
    return rows


def grad_norm_trace(s: int, steps: int = 2000, workers: int = 4,
                    mu: float = 0.3, lipschitz: float = 10.0, seed: int = 0,
                    *, params=None, data=None,
                    delay: Optional[DelayModel] = None, kernels: str = "off",
                    device=None) -> list:
    """Async SGD on the depth-1 DNN with the Theorem-1 stepsize
    ``mu / (s L sqrt(k))``; every 50 steps the probe gradient's squared
    norm and its running minimum: a list of ``(step, gsq, running_min)``."""
    dev = device_lib.resolve(device)
    data = data if data is not None else synthetic.teacher_classification(seed=0)
    if params is None:
        params = mlp.init(seed, mlp.MLPConfig(depth=1), device=dev)
    opt = optlib.sgd(theorem1(mu=mu, s=max(s, 1), lipschitz=lipschitz))
    engine = build_engine(mlp.loss_fn, opt,
                          EngineConfig(mode="simulate", num_workers=workers,
                                       delay=delay or UniformDelay(s),
                                       kernels=kernels), device=dev)
    state = engine.init(seed, params=params)
    probe = _probe(data, dev)
    batches = iter(ShardedBatches([data.x_train, data.y_train], workers, 32,
                                  seed=seed))
    trace, running_min = [], float("inf")
    for t in range(steps):
        state, _ = engine.step(state, next(batches))
        if (t + 1) % 50 == 0:
            g = coh.probe_gradient(mlp.loss_fn, engine.params(state), probe)
            v = float(torch.sum(g * g))
            running_min = min(running_min, v)
            trace.append((t + 1, v, running_min))
    return trace
