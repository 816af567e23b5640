"""Training driver (twin of ``python -m repro.launch.train``):
staleness-aware data-parallel training of a registered architecture through
the ``repro_torch.engine`` surface, on one GPU or over a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --steps 200 --stale 4 --batch 16 --seq 128 --coherence \\
      [--cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch deepseek-7b --reduced --mesh 2x1 --workers 2 [--cpu]

Runs on CUDA unless ``--cpu`` is given (then the kernels' plain versions
run). ``--mode`` selects the staleness regime (sync / stale-psum / ssp /
simulate); the default ``auto`` picks sync when ``--stale 0`` and
stale-psum otherwise. Every flag of the JAX driver is taken with the same
meaning and the same errors. ``--mesh DATAxMODEL`` other than ``1x1``
runs under ``torchrun`` with DATA x MODEL ranks (``gloo`` with ``--cpu``,
``nccl`` on the cards): every rank builds the same engine and draws the
same batches, and rank 0 prints the rows the one-process run prints. On a
model axis > 1 (``--mesh 1x2``, ``2x2``) a decoder-only transformer whose
every model-sharded dim the extent divides (reduced ``deepseek-7b``, for
one) trains tensor-parallel on its shards, its rows within fp32 roundoff
of the one-process rows; it prints which route it took. The
coherence monitor, checkpoints and trace recording stay on the one-process
run. The JAX package's deprecated ``launch/steps.py`` shim has no
counterpart.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch import delays as delays_lib
from repro_torch import treemath as tm
from repro_torch.configs.base import InputShape
from repro_torch.core import coherence as coh
from repro_torch.data.synthetic import token_lm_stream
from repro_torch.engine import (CheckpointHook, CoherenceHook, EngineConfig,
                                StdoutSink, TraceRecorderHook, Trainer,
                                build_engine)
from repro_torch.engine.api import kernel_placement_ok
from repro_torch.launch import mesh as meshlib
from repro_torch.optim import optimizers as optlib


def make_batch_fn(api, batch: int, seq: int, seed: int, workers: int = 0):
    """Fresh synthetic batch every call, as numpy arrays (the engine moves
    them to its device). Each auxiliary field gets its own per-field-seeded
    generator and is re-drawn per batch. With ``workers`` > 0 every leaf is
    reshaped to [P, batch/P, ...] for the simulate engine's per-worker batch
    contract."""
    stream = token_lm_stream(seed, api.vocab_real, seq, batch)
    cfg = api.cfg
    gens = {}
    if getattr(cfg, "num_cross_layers", 0):
        gens["cross_feats"] = (np.random.default_rng([seed, 1]),
                               (batch, cfg.cross_tokens, cfg.cross_dim))
    if api.family == "encdec":
        gens["frames"] = (np.random.default_rng([seed, 2]),
                          (batch, cfg.num_frames, cfg.d_model))

    def next_batch():
        out = {"tokens": next(stream)}
        for name, (rng, shape) in gens.items():
            out[name] = rng.standard_normal(shape).astype(np.float32)
        if workers:
            out = {k: v.reshape((workers, v.shape[0] // workers)
                                + v.shape[1:]) for k, v in out.items()}
        return out

    return next_batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--stale", type=int, default=0)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "sync", "stale-psum", "ssp", "simulate"],
                    help="staleness regime (auto: sync iff --stale 0)")
    ap.add_argument("--delay", default=None,
                    help="delay spec (repro_torch.delays): uniform[:S] | "
                         "zero | constant:D | geometric[:TRUNC] | "
                         "multipod:PODS[:INTER_S[:INTRA_S]] | "
                         "trace:PATH[:BOUND]")
    ap.add_argument("--trace", default=None,
                    help="replay measured per-step wall-times from a delays "
                         "trace file (shorthand for --delay trace:PATH)")
    ap.add_argument("--trace-out", default=None,
                    help="record this run's per-step wall-times to a trace "
                         "file for later --trace replay")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--kernels", default="off",
                    choices=["off", "auto", "on"],
                    help="route the engine hot spots (stale delivery, "
                         "coherence probe, Adam) through the CUDA kernels "
                         "(off = plain torch tree math)")
    ap.add_argument("--compress", default="none",
                    help="EF gradient sparsification (repro_torch."
                         "compensate): none | topk:K (keep fraction 0<K<1 "
                         "or K elements) | thresh:V")
    ap.add_argument("--lr-scale", default="none",
                    choices=["none", "inverse", "theorem1"],
                    help="staleness-aware stepsize: inverse = Zhang 1/tau "
                         "on the realized delay; theorem1 = mu/(s L sqrt(k)) "
                         "on live mu/L signals (needs --coherence)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--coherence", action="store_true",
                    help="enable the gradient-coherence monitor + controller")
    ap.add_argument("--mesh", default="1x1",
                    help="host mesh 'DATAxMODEL'; other than 1x1, run under "
                         "torchrun with DATA x MODEL ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap


def main(argv=None) -> dict:
    """Run the driver; returns ``{"engine", "result", "params_m"}`` for a
    caller that drives it in-process."""
    args = parser().parse_args(argv)

    if args.delay and args.trace:
        raise SystemExit("--delay and --trace are mutually exclusive "
                         "(--trace is shorthand for --delay trace:PATH)")
    mode = args.mode
    if mode == "auto":
        mode = "sync" if args.stale == 0 else "stale-psum"
    delay_spec = None
    if args.trace:
        # bound == --stale even at 0 (a BSP replay), so the spec is always
        # fully resolved: the end-of-run nominal print needs it.
        delay_spec = delays_lib.Trace(args.trace, bound=args.stale)
    elif args.delay:
        delay_spec = delays_lib.parse_spec(args.delay, s=args.stale,
                                           num_workers=args.workers)
    if delay_spec is not None and mode == "sync":
        raise SystemExit(f"--delay/--trace need a non-sync mode: pass "
                         f"--stale > 0 or --mode (got mode={mode})")
    arch = cfglib.get(args.arch)
    api = arch.api(reduced=args.reduced)
    device = "cpu" if args.cpu else None
    mesh = meshlib.parse_host_mesh(args.mesh, device=device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None and (args.coherence or args.ckpt_dir
                             or args.trace_out):
        raise SystemExit("--coherence, --ckpt-dir and --trace-out run on "
                         "the one-process run only (no --mesh)")
    say(f"arch={args.arch} reduced={args.reduced} family={api.family} "
        f"mode={mode} stale_s={args.stale} workers={args.workers}")

    if mode != "sync" and args.batch % args.workers:
        raise SystemExit(f"mode={mode} needs --batch divisible by --workers")
    opt_name = args.optimizer or arch.train_optimizer
    opt_kwargs = {"lr": args.lr} if args.lr else {}
    if opt_name == "adam" and kernel_placement_ok(args.kernels, arch,
                                                  mesh)[0]:
        opt_kwargs["kernel"] = True   # fused-Adam hot spot (opt-in)
    opt = optlib.get_optimizer(opt_name, **opt_kwargs)
    shape = InputShape(f"train_cli_{args.seq}", args.seq, args.batch, "train")
    if args.lr_scale == "theorem1" and not args.coherence:
        raise SystemExit("--lr-scale theorem1 takes its live mu/L signals "
                         "from the coherence probe: pass --coherence")
    ecfg = EngineConfig(mode=mode, num_workers=args.workers, s=args.stale,
                        delay=delay_spec, kernels=args.kernels,
                        compress=args.compress, lr_scale=args.lr_scale,
                        ssp_steps=max(args.steps, 1), ssp_seed=args.seed)
    engine = build_engine(api, opt, ecfg, mesh=mesh, arch=arch, shape=shape,
                          device=device)
    if "model_compute" in engine.meta:
        why = engine.meta.get("model_compute_fallback")
        say(f"model axis: {engine.meta['model_compute']}"
            + (f" ({why})" if why else ""))
    # The driver keeps no reference to the initial state once training
    # starts, so a full-width run holds one copy of its params, moments
    # and ring at a time.
    states = [engine.init(args.seed)]
    n_params = tm.tree_size(engine.params(states[0]))
    say(f"params: {n_params/1e6:.1f}M")

    next_batch = make_batch_fn(
        api, args.batch, args.seq, args.seed,
        workers=args.workers if mode == "simulate" else 0)

    hooks = []
    if args.coherence:
        controller = (coh.CoherenceController(s_max=args.stale)
                      if args.stale else None)
        probe = make_batch_fn(api, args.batch, args.seq, args.seed + 1)()
        hooks.append(CoherenceHook(
            api.loss, probe, dim=n_params,
            window=max(args.stale, 4), every=args.log_every,
            controller=controller, kernels=args.kernels != "off"))
    if args.ckpt_every and args.ckpt_dir:
        hooks.append(CheckpointHook(args.ckpt_dir, args.ckpt_every,
                                    extra={"arch": args.arch}))
    if args.trace_out:
        hooks.append(TraceRecorderHook(args.trace_out,
                                       num_workers=args.workers))
    if lead:
        hooks.append(StdoutSink())  # sinks last: they see hook-merged rows

    result = Trainer(engine, hooks=hooks).run(
        next_batch, args.steps, state=states.pop(), log_every=args.log_every)

    if delay_spec is not None and result.history:
        realized = result.history[-1].get("mean_total_delay")
        if realized is not None:
            say(f"delay: realized mean total delay {realized:.3f} "
                f"(nominal {delay_spec.mean_total_delay:.3f})")

    if (args.compress != "none" or args.lr_scale != "none") and result.history:
        last = result.history[-1]
        bits = [f"compress={args.compress}", f"lr_scale={args.lr_scale}"]
        if "sparsity" in last:
            bits.append(f"realized sparsity {last['sparsity']:.3f}")
        if "lr_scale" in last:
            bits.append(f"effective factor {last['lr_scale']:.4f}")
        say("compensate: " + " ".join(bits))

    if args.kernels != "off":
        rep = engine.dispatch_report()
        say(f"kernel dispatch: config={rep['config']} "
            f"delivery={rep['delivery']}")
        for op, backend in rep["decisions"].items():
            say(f"  {op:<16} -> {backend}")

    if args.out and lead:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "history": result.history,
                       "params_m": n_params / 1e6}, f, indent=1)
    if result.history:
        say(f"done: {args.steps} steps in {result.wall_s:.1f}s "
            f"(final loss {result.history[-1]['loss']:.4f})")
    else:
        say("done")
    return {"engine": engine, "result": result, "params_m": n_params / 1e6}


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
