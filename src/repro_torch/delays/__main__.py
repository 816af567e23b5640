"""Delays smoke (twin of ``python -m repro.delays``): record a short
wall-time trace from a live Trainer run (into a temporary directory),
replay it deterministically through the SSP clock discipline, and run one
multi-pod engine step.

  PYTHONPATH=src python -m repro_torch.delays          # on CUDA
  PYTHONPATH=src python -m repro_torch.delays --cpu
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch import delays
from repro_torch.engine import (EngineConfig, Trainer, TraceRecorderHook,
                                build_engine)
from repro_torch.optim import sgd

W_TRUE = torch.tensor([1.0, -2.0, 3.0, 0.5])


def quad_loss(params, batch):
    """Mean squared error of a linear model; ``[P]`` losses for
    worker-stacked ``w [P, 4]`` and ``x [P, b, 4]``."""
    x, y = batch
    pred = torch.einsum("...bd,...d->...b", x, params["w"])
    return ((pred - y) ** 2).mean(dim=-1)


def make_batches(gen, p, per, n):
    out = []
    for _ in range(n):
        x = torch.randn((p * per, 4), generator=gen)
        out.append((x, x @ W_TRUE))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    p, steps = 2, 3
    params = {"w": torch.zeros((4,))}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace_smoke.jsonl")

        # 1. record: a tiny sync run writes its per-step wall-times.
        eng = build_engine(quad_loss, sgd(0.05),
                           EngineConfig(mode="sync", num_workers=p),
                           device=device)
        st = eng.init(0, params=params)
        Trainer(eng, hooks=[TraceRecorderHook(path)]).run(
            iter(make_batches(torch.Generator().manual_seed(1), p, 8,
                              steps)), steps, state=st)
        durations, header = delays.read_trace(path)
        assert durations.shape == (steps, p), durations.shape
        print(f"recorded {path}: {durations.shape[0]} steps x "
              f"{durations.shape[1]} workers (header {header}) "
              f"({eng.device})")

        # 2. replay: two reads of the same trace realize identical tables.
        t1 = delays.Trace(path, bound=2).schedule(num_workers=p).table
        t2 = delays.Trace(path, bound=2).schedule(num_workers=p).table
        np.testing.assert_array_equal(t1, t2)
        print(f"replayed schedule (bound=2): shape {t1.shape}, "
              f"mean delay {t1.mean():.3f}")

    # 3. one multi-pod engine step: hierarchical intra/inter-pod delays.
    mp = delays.MultiPod(pod_of=(0, 1), intra=delays.Zero(),
                         inter=delays.Uniform(4))
    eng = build_engine(quad_loss, sgd(0.05),
                       EngineConfig(mode="stale-psum", num_workers=p, s=4,
                                    delay=mp), device=device)
    st = eng.init(0, params=params)
    st, metrics = eng.step(
        st, make_batches(torch.Generator().manual_seed(2), p, 8, 1)[0])
    loss = float(metrics["loss"])
    assert math.isfinite(loss), loss
    print(f"multi-pod step: nominal mean total delay "
          f"{mp.mean_total_delay:.2f}, loss {loss:.4f} ({eng.device})")
    print("DELAYS_SMOKE_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
