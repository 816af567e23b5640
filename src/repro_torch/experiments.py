"""The paper's experiments on the port.

* ``dnn_experiment``, ``cnn_experiment``, ``mf_experiment`` and
  ``vae_experiment`` (twins of ``benchmarks/common.py::_run_sim`` and the
  functions of the same names): a simulate-mode engine and a Trainer,
  stepped until the target quality (or the budget), reporting
  batches-to-target, the paper's primary measurement (Figs. 1-3; with
  ``matched_geometric`` delays, Fig. 4(c)). ``lda_experiment`` returns
  the log-likelihood against documents processed (Fig. 3(c)(d)), and
  ``run_engine`` runs a custom ``update_fn`` (and the ``server_side``
  ablation). ``normalized`` and ``print_csv`` are the figures' helpers.
* ``coherence_trace`` and ``coherence_by_depth`` (twins of
  ``benchmarks/fig4_coherence.py::coherence_trace`` and the rows of
  ``benchmarks/fig5_coherence_depth.py::main``): gradient coherence over
  training (Fig. 4(a)(b)) and against depth (Fig. 5).
* ``grad_norm_trace`` (twin of ``benchmarks/theorem1_validation.py``): the
  probe gradient norm under the Theorem-1 stepsize.

Every harness takes ``params``/``data`` overrides (pass
``convert.params_from_jax`` of ``repro``'s init for identical weights; for
LDA, ``z0``, the initial assignments) and a ``delay`` override (a
deterministic spec, where runs are compared). They run on CUDA unless
``device="cpu"``, with ``kernels="auto"`` (the packed kernel path) unless
told otherwise; the JAX harness's engines default to ``"off"``, whose
trajectories the packed route matches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import numpy as np

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.core import coherence as coh
from repro_torch.core.staleness import StalenessConfig
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.delays.models import DelayModel, UniformDelay
from repro_torch.engine import EngineConfig, Trainer, build_engine
from repro_torch.models import lda, mf, mlp, resnet, vae
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


def run_engine(update_fn, params, ustate, cfg: StalenessConfig, batches_iter,
               eval_fn, target, higher_better, max_steps, eval_every,
               seed=0, server_apply=None, kernels: str = "auto",
               device=None) -> ExperimentResult:
    """A simulate-mode engine over a custom ``update_fn`` (twin of
    ``benchmarks/common.py::run_engine``), with the paper's batch
    accounting (P worker batches per engine step). ``cfg`` gives the
    workers, the delay spec and ``server_side`` (with ``server_apply``,
    the ablation; it runs on tree delivery). ``eval_fn(params) -> float``;
    ``target`` is the quality threshold."""
    ecfg = EngineConfig(mode="simulate", num_workers=cfg.num_workers,
                        delay=cfg.delay, server_side=cfg.server_side,
                        kernels=kernels)
    engine = build_engine(None, None, ecfg, update_fn=update_fn,
                          server_apply=server_apply, device=device)
    state = engine.init(seed, params=params, update_state=ustate)
    res = Trainer(engine).run(batches_iter, max_steps, state=state,
                              eval_fn=eval_fn, eval_every=eval_every,
                              target=target, higher_better=higher_better)
    return ExperimentResult(res.batches_to_target, res.curve, res.converged,
                            res.wall_s)


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


def cnn_experiment(n_blocks: int, algo: str, s: int, workers: int,
                   target_acc: float = 0.75, batch: int = 32,
                   max_steps: int = 1500, seed: int = 0,
                   widths=(8, 16, 32), eval_every: int = 25,
                   delay: Optional[DelayModel] = None, kernels: str = "auto",
                   params=None, cfg: Optional[resnet.ResNetConfig] = None,
                   data=None, device=None) -> ExperimentResult:
    """ResNet-(6n+2) on synthetic CIFAR at 16 x 16 (paper Figs. 1(a-d), 2),
    at the JAX harness's reduced widths (8, 16, 32). Accuracy on the first
    512 test images."""
    dev = device_lib.resolve(device)
    data = data if data is not None else synthetic.synthetic_images(seed=0,
                                                                    hw=16)
    cfg_r = cfg or resnet.ResNetConfig(n=n_blocks, widths=widths)
    strides = resnet.block_strides(cfg_r)
    if params is None:
        params, _ = resnet.init(seed, cfg_r, device=dev)
    acc_fn = resnet.make_accuracy_fn(cfg_r, strides)
    batches = ShardedBatches([data.x_train, data.y_train], workers, batch,
                             seed=seed)
    xt = torch.as_tensor(data.x_test[:512], device=dev)
    yt = torch.as_tensor(data.y_test[:512], device=dev)
    return _run_sim(resnet.make_loss_fn(cfg_r, strides),
                    optlib.paper_default(algo), params, workers,
                    delay or UniformDelay(s), iter(batches),
                    lambda p: acc_fn(p, xt, yt), target_acc, True, max_steps,
                    eval_every, seed, kernels=kernels, device=dev)


def mf_experiment(s: int, workers: int, target_loss: float = 0.15,
                  batch: int = 500, max_steps: int = 4000, seed: int = 0,
                  eval_every: int = 20, delay: Optional[DelayModel] = None,
                  kernels: str = "auto", params=None,
                  cfg: Optional[mf.MFConfig] = None, data=None,
                  device=None) -> ExperimentResult:
    """MF-SGD (lr 1.0, rank 5, lambda 1e-4) on the low-rank ratings
    stand-in (paper Fig. 3(a)(b)); the target is the full objective."""
    dev = device_lib.resolve(device)
    data = data if data is not None else synthetic.low_rank_ratings(seed=0)
    cfg_m = cfg or mf.MFConfig(num_users=data.num_users,
                               num_items=data.num_items, rank=5, lam=1e-4)
    if params is None:
        params = mf.init(seed, cfg_m, device=dev)
    batches = ShardedBatches([data.rows, data.cols, data.vals], workers,
                             batch, seed=seed)
    rows, cols, vals = (torch.as_tensor(a, device=dev)
                        for a in (data.rows, data.cols, data.vals))
    # lr 1.0: the JAX harness's calibration (0.15 is hit mid-descent).
    return _run_sim(mf.make_loss_fn(cfg_m), optlib.sgd(1.0), params, workers,
                    delay or UniformDelay(s), iter(batches),
                    lambda p: mf.full_objective(p, rows, cols, vals, cfg_m),
                    target_loss, False, max_steps, eval_every, seed,
                    kernels=kernels, device=dev)


def vae_experiment(depth: int, algo: str, s: int, workers: int = 1,
                   target_loss: float = 135.0, batch: int = 32,
                   max_steps: int = 4000, seed: int = 0,
                   eval_every: int = 50, delay: Optional[DelayModel] = None,
                   kernels: str = "auto", params=None,
                   cfg: Optional[vae.VAEConfig] = None, data=None,
                   device=None) -> ExperimentResult:
    """VAE blackbox VI (paper Fig. 3(e)(f)) at in_dim 256, latent 16,
    obs_scale 0.5; the target is the negative ELBO on 512 test points
    (4 draws of epsilon from a generator seeded 99 at every evaluation)."""
    dev = device_lib.resolve(device)
    data = data if data is not None else synthetic.vae_data(seed=0, dim=256)
    cfg_v = cfg or vae.VAEConfig(in_dim=256, depth=depth, latent=16,
                                 obs_scale=0.5)
    if params is None:
        params = vae.init(seed, cfg_v, device=dev)
    batches = ShardedBatches([data.x_train], workers, batch, seed=seed)
    xt = torch.as_tensor(data.x_test[:512], device=dev)
    eval_fn = lambda p: vae.test_loss(p, xt, device_lib.generator(99, dev),
                                      cfg_v)
    return _run_sim(vae.make_loss_fn(cfg_v), optlib.paper_default(algo),
                    params, workers, delay or UniformDelay(s),
                    ((b[0],) for b in batches), eval_fn, target_loss, False,
                    max_steps, eval_every, seed, loss_takes_key=True,
                    kernels=kernels, device=dev)


def lda_run(s: int, workers: int, k_topics: int = 10, sweeps: int = 60,
            seed: int = 0, n_docs: int = 240, doc_len: int = 48,
            vocab: int = 300, *, delay: Optional[DelayModel] = None,
            kernels: str = "auto", z0=None, data=None, device=None):
    """``lda_experiment``'s run: ``(curve, engine, state, cfg, tokens)``,
    the last three being the final engine state, the ``LDAConfig`` and the
    partitioned corpus ``[workers * per, doc_len]``."""
    dev = device_lib.resolve(device)
    corp = data if data is not None else synthetic.lda_corpus(
        seed=0, n_docs=n_docs, doc_len=doc_len, vocab=vocab,
        k_true=k_topics)
    n_docs, doc_len = corp.tokens.shape
    cfg_l = lda.LDAConfig(vocab=corp.vocab, num_topics=k_topics,
                          batch_docs=max(n_docs // (10 * workers), 1))
    toks = torch.as_tensor(corp.tokens, device=dev)
    if z0 is None:
        z0 = lda.init_assignments(device_lib.generator(seed, dev), toks,
                                  cfg_l)
    z0 = torch.as_tensor(z0, dtype=torch.int32, device=dev)
    counts = lda.init_counts(toks, z0, cfg_l)

    # Static partition: worker w owns docs [w * per, (w + 1) * per).
    per = n_docs // workers
    wtoks = toks[: per * workers].reshape(workers, per, doc_len)
    wz = z0[: per * workers].reshape(workers, per, doc_len)

    engine = build_engine(None, None,
                          EngineConfig(mode="simulate", num_workers=workers,
                                       delay=delay or UniformDelay(s),
                                       kernels=kernels),
                          update_fn=lda.make_update_fn(cfg_l), device=dev)
    state = engine.init(seed, params=counts,
                        update_state=lda.init_worker_state(wtoks[0], wz[0]))
    # Per-worker partitions differ: replace the broadcast update_state.
    state = dataclasses.replace(state, inner=dataclasses.replace(
        state.inner, update_state={
            "tokens": wtoks, "z": wz.clone(),
            "cursor": torch.zeros((workers,), dtype=torch.int32,
                                  device=dev)}))
    flat = toks[: per * workers].reshape(-1, doc_len)
    placeholder = torch.zeros((workers, 1), device=dev)

    curve = []
    docs_per_step = cfg_l.batch_docs * workers
    steps = sweeps * max(per // cfg_l.batch_docs, 1)
    for t in range(steps):
        state, _ = engine.step(state, placeholder)
        if (t + 1) % 5 == 0:
            z = state.inner.update_state["z"].reshape(-1, doc_len)
            ll = float(lda.log_likelihood(engine.params(state), flat, z,
                                          cfg_l))
            curve.append(((t + 1) * docs_per_step, ll))
    return curve, engine, state, cfg_l, flat


def lda_experiment(s: int, workers: int, k_topics: int = 10,
                   sweeps: int = 60, seed: int = 0, n_docs: int = 240,
                   doc_len: int = 48, vocab: int = 300, **overrides) -> list:
    """LDA collapsed Gibbs under staleness (paper Fig. 3(c)(d)): the
    log-likelihood trajectory ``[(documents processed, ll)]``, read every 5
    steps. The corpus is partitioned statically across workers; each engine
    step sweeps ``D/(10P)`` documents a worker (paper Section 4).
    ``overrides``: ``delay``, ``kernels``, ``z0``, ``data``, ``device``
    (see ``lda_run``)."""
    return lda_run(s, workers, k_topics, sweeps, seed, n_docs, doc_len,
                   vocab, **overrides)[0]


def normalized(results: dict) -> dict:
    """batches-to-target normalized by the s=0 entry (paper's Fig 1(b)(d))."""
    base = results.get(0)
    out = {}
    for s, r in results.items():
        if base and base.converged and r.converged:
            out[s] = r.batches_to_target / base.batches_to_target
        else:
            out[s] = float("nan") if not r.converged else float("inf")
    return out


def print_csv(name: str, rows: list, header: str):
    print(f"# {name}")
    print(header)
    for row in rows:
        print(",".join(str(x) for x in row))


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
