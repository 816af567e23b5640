"""The paper's DNN experiment on the port (twin of
``benchmarks/common.py::_run_sim`` and ``dnn_experiment``).

Builds a simulate-mode engine and a Trainer, steps until the target
accuracy (or the budget), and reports batches-to-target, the paper's
primary measurement (Fig. 1(e)(f)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.delays.models import DelayModel, UniformDelay
from repro_torch.engine import EngineConfig, Trainer, build_engine
from repro_torch.models import mlp
from repro_torch.optim import optimizers as optlib


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
