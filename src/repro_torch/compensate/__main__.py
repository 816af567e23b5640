"""Compensation smoke (twin of ``python -m repro.compensate``): one
EF-sparsified and one LR-scaled engine per staleness mode, asserting the
knobs bite (realized sparsity on the sparsified leg; a stepsize factor
below 1 on the scaled leg whenever the mode realizes a delay).

  PYTHONPATH=src python -m repro_torch.compensate          # on CUDA
  PYTHONPATH=src python -m repro_torch.compensate --cpu
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

from repro_torch.engine import EngineConfig, build_engine
from repro_torch.optim import sgd

W_TRUE = torch.arange(6.0)


def quad_loss(params, batch):
    """Mean squared error of a linear model; ``[P]`` losses for
    worker-stacked ``w [P, 6]`` and ``x [P, b, 6]``."""
    x, y = batch
    pred = torch.einsum("...bd,...d->...b", x, params["w"])
    return ((pred - y) ** 2).mean(dim=-1)


def make_batch(gen, p, per, workers=0):
    x = torch.randn((p * per, 6), generator=gen)
    y = x @ W_TRUE
    if workers:
        return (x.reshape(workers, per, 6), y.reshape(workers, per))
    return (x, y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    p, steps = 4, 3
    for mode in ("simulate", "stale-psum", "ssp", "sync"):
        for kw, label in ((dict(compress="topk:0.25"), "sparsified"),
                          (dict(lr_scale="inverse"), "lr-scaled")):
            eng = build_engine(quad_loss, sgd(0.05), EngineConfig(
                mode=mode, num_workers=p, s=3, ssp_steps=8, kernels="auto",
                **kw), device=device)
            st = eng.init(0, params={"w": torch.zeros((6,))})
            gen = torch.Generator().manual_seed(1)
            for _ in range(steps):
                batch = make_batch(gen, p, 8,
                                   workers=p if mode == "simulate" else 0)
                st, m = eng.step(st, batch)
            loss = float(m["loss"])
            assert math.isfinite(loss), (mode, label, loss)
            if "sparsity" in m:
                sp = float(m["sparsity"])
                assert 0.0 <= sp < 1.0, (mode, sp)
                extra = f"sparsity {sp:.2f}"
            else:
                scale = float(torch.as_tensor(m["lr_scale"]).mean())
                assert 0.0 < scale <= 1.0, (mode, scale)
                if mode != "sync" and float(m.get("mean_staleness", 0.0)) > 0:
                    assert scale < 1.0, (mode, scale)
                extra = f"lr_scale {scale:.3f}"
            print(f"{mode:<10} {label:<10} loss {loss:9.3f}  {extra}  "
                  f"({eng.device})")
    print("COMPENSATE_SMOKE_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
