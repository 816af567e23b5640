#!/usr/bin/env python3
"""How far the compressed Adam ring legs part when nothing is wrong, and
how far they part when the fused kernel's tail is wrong.

    python3 tools/ring_drift.py                  # one NVIDIA GPU
    python3 tools/ring_drift.py --cpu --dim 32   # rehearsal: narrow, plain

``chip_smoke.py`` holds each compressed Adam leg (``compress="topk:0.1"``,
with and without ``ef_momentum``, stale-psum and sync) with kernels on
against kernels off. The two routes sum the delayed rows in another order,
so they part at roundoff, and top-k threshold flips amplify that over 50
steps. This script measures, for each such leg, at ``chip_smoke.py``'s
shapes and seeds:

* ``on_vs_off``: the pair ``chip_smoke.py`` holds;
* sound witnesses, runs that differ only by roundoff: ``off`` against
  ``off`` started from params nudged up by one ulp (``off_nudged``), and
  ``on`` against ``on`` nudged (``on_nudged``);
* planted faults, each a plausible bug in the fused tail injected around
  ``dispatch.fused_update`` with kernels on, held against kernels off:
  ``fresh_as_stale`` (a fresh row delivers its ring row instead of this
  step's sent; ring legs only), ``resid_lost`` (the EF residual comes back
  zero), ``thr_1pct`` (the threshold 1% high), ``row_dropped`` (the last
  row gets weight 0; R > 1 only) and ``mom_kept`` (momentum not cleared
  where kept; ef_momentum only).

Each comparison prints ``chip_smoke.run_distance``'s keys (max abs loss
difference over the first 5 steps and over all 50, max abs param
difference, params' relative L2 distance); the whole table goes to
``chiprun_out/ring_drift.json``. The last line is the card line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

LEGS = [leg for leg in cs.RING_LEGS if leg[4].startswith("adam_compress")]


def nudged(params):
    """Every param moved up by one ulp: a roundoff-sized perturbation."""
    import torch
    from repro_torch import treemath as tm
    return tm.tree_map(
        lambda x: torch.nextafter(x, torch.full_like(x, float("inf"))),
        params)


def faults(leg) -> dict:
    """The planted faults that apply to ``leg``: name -> a function that
    maps the fused_update call's (args, kwargs) to the faulty call's, and
    the faulty outputs."""
    import torch
    knobs, ring = leg[3], leg[1] != "sync"

    def fresh_as_stale(args, kw):
        kw["fresh"] = torch.zeros_like(kw["fresh"])
        return args, kw, None

    def resid_lost(args, kw):
        def after(outs):
            return outs[:5] + (torch.zeros_like(outs[5]),) + outs[6:]
        return args, kw, after

    def thr_1pct(args, kw):
        kw["thr"] = kw["thr"] * 1.01
        return args, kw, None

    def row_dropped(args, kw):
        w = args[4].clone()
        w[-1] = 0.0
        return args[:4] + (w,) + args[5:], kw, None

    def mom_kept(args, kw):
        mom = kw["mom"]
        return args, kw, lambda outs: outs[:6] + (mom.clone(),)

    out = {"resid_lost": resid_lost, "thr_1pct": thr_1pct}
    if ring:
        out.update(fresh_as_stale=fresh_as_stale, row_dropped=row_dropped)
    if knobs.get("ef_momentum"):
        out["mom_kept"] = mom_kept
    return out


def with_fault(fault):
    """Context: dispatch.fused_update runs with ``fault`` planted."""
    import contextlib

    from repro_torch.kernels import dispatch

    @contextlib.contextmanager
    def ctx():
        clean = dispatch.fused_update

        def faulty(*args, **kw):
            args, kw, after = fault(args, dict(kw))
            outs = clean(*args, **kw)
            return after(outs) if after else outs

        dispatch.fused_update = faulty
        try:
            yield
        finally:
            dispatch.fused_update = clean
    return ctx()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions): a rehearsal")
    ap.add_argument("--dim", type=int, default=784,
                    help="input width (784: the Fig. 1 DNN)")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--steps", type=int, default=cs.STEPS)
    args = ap.parse_args()

    import numpy as np
    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import mlp

    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        print("ring_drift: CUDA is not available (--cpu rehearses)",
              file=sys.stderr)
        return 2
    card = cs.card_line() if dev.type == "cuda" else "cpu (no card)"

    data = synthetic.teacher_classification(seed=0, dim=args.dim)
    params0 = mlp.init(0, mlp.MLPConfig(in_dim=args.dim, hidden=args.hidden,
                                        depth=cs.DEPTH), device=dev)
    table = np.random.default_rng(0).integers(0, cs.STALENESS,
                                              (args.steps, cs.WORKERS))
    table[0, 0] = cs.STALENESS - 1
    speeds = np.random.default_rng(0).lognormal(
        0.0, 0.5, (64, cs.WORKERS)).astype(np.float32)

    def run(leg, kernels, params=params0):
        return cs.ring_run(dev, leg, kernels, params, data, table, speeds,
                           steps=args.steps, timed_steps=0)

    table_out = {}
    for leg in LEGS:
        name = leg[0]
        on, off = run(leg, "on"), run(leg, "off")
        rows = {"on_vs_off": cs.run_distance(on, off),
                "off_nudged": cs.run_distance(run(leg, "off", nudged(params0)),
                                              off),
                "on_nudged": cs.run_distance(run(leg, "on", nudged(params0)),
                                             on)}
        for fname, fault in faults(leg).items():
            with with_fault(fault):
                bad = run(leg, "on")
            rows[f"fault {fname}"] = cs.run_distance(bad, off)
        table_out[name] = rows
        for key, dist in rows.items():
            print(f"{name} | {key}: {json.dumps(dist)}")

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ring_drift.json"), "w") as f:
        json.dump({"device": card, "steps": args.steps, "dim": args.dim,
                   "legs": table_out}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
