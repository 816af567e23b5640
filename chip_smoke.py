#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at a ragged D;
4. the main path: the simulate engine training the full-width Fig. 1(e)(f)
   DNN (784 -> 256 x 3 -> 10, P = 8 workers, s = 16, batch 32 per worker)
   through ``build_engine`` + ``Trainer`` with ``kernels="on"``, for Adam
   (fused step: ``stale_accum`` + ``fused_adam``) and SGD (packed step:
   ``stale_accum``), each held against the ``kernels="off"`` tree layout in
   plain torch on the card, with launch counters checked; and the s = 0,
   P = 1 packed engine against the sequential reference on a small input;
5. timings with CUDA events: ms per engine step, and each kernel's time
   beside its bound, its plain version and one PyTorch library call.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet) at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# The main path's shapes: depth-3 DNN, P = 8 workers, s = 16.
DEPTH, WORKERS, STALENESS, BATCH, STEPS = 3, 8, 16, 32, 50
TIMED_STEPS = 20

# Tolerances, each with its reason.
# stale_accum with one slot of weight 1 adds the same two fp32 numbers as
# the plain version: equal bit for bit.
TOL_ACCUM_S1 = 0.0
# More slots, or random weights: the kernel sums the slots with fused
# multiply-adds in slot order, the plain version through a matmul; values
# are O(1) sums of <= 4 terms, so a few ulps of 4.
TOL_ACCUM = dict(rtol=1e-6, atol=1e-5)
# fused_adam: the same operations in the same order, each rounded once; the
# plain version divides by a scalar as a multiply by its reciprocal, so
# elements may differ by about one ulp of the update.
TOL_ADAM = dict(rtol=1e-5, atol=1e-7)
# Engine, kernels on vs off, SGD: the two layouts sum the arrivals that
# share a slot in different orders (index_add per source vs a one-hot
# matmul); those roundoff differences stay at fp32 roundoff of the params.
TOL_ENGINE_SGD = dict(loss=1e-5, param=1e-5)
# Adam normalises each gradient element: where an element is within fp32
# noise of zero, one layout's roundoff can flip its update by up to 2 * lr
# (lr = 1e-3), and later steps carry that on; the loss stays close.
TOL_ENGINE_ADAM = dict(loss=1e-3, param=2e-2, rel=1e-3)
# s = 0, P = 1 engine vs the sequential reference: the same SGD updates,
# delivered one step later through stale_accum (exact adds).
TOL_SEQUENTIAL = dict(rtol=1e-6, atol=1e-7)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    import torch
    err = max_abs(got, want)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=name)
    return err


# -- phase 3: kernels against their plain versions ------------------------------

def kernel_checks(dev, n: int) -> dict:
    """Each kernel's wrapper vs its plain version on ``dev``. Returns the
    max abs error at the main path's shapes, per kernel."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.stale_accum import stale_accum

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    errs = {}

    params, buf = rnd(n), rnd(1, n)
    ones = torch.ones(1, device=dev)
    got, want = stale_accum(params, buf, ones), ref.stale_accum(params, buf, ones)
    err = max_abs(got, want)
    print(f"stale_accum S=1 N={n}: max_abs_err={err!r} (tol {TOL_ACCUM_S1})")
    if err > TOL_ACCUM_S1:
        raise AssertionError("stale_accum S=1 is not bitwise equal to its "
                             "plain version")
    errs["stale_accum"] = err

    buf4, w4 = rnd(4, n), torch.rand(4, generator=gen, device=dev)
    err = check_close("stale_accum S=4", stale_accum(params, buf4, w4),
                      ref.stale_accum(params, buf4, w4), **TOL_ACCUM)
    print(f"stale_accum S=4 N={n}: max_abs_err={err!r} (tol {TOL_ACCUM})")

    odd = 1_000_003                      # not a multiple of 4: scalar path
    p_odd, b_odd, w_odd = rnd(odd), rnd(3, odd), torch.rand(3, generator=gen,
                                                            device=dev)
    err = check_close("stale_accum odd D", stale_accum(p_odd, b_odd, w_odd),
                      ref.stale_accum(p_odd, b_odd, w_odd), **TOL_ACCUM)
    print(f"stale_accum S=3 D={odd}: max_abs_err={err!r} (tol {TOL_ACCUM})")

    errs["fused_adam"] = 0.0
    for step, d in ((1, n), (100, n), (7, odd)):
        p, m, g = rnd(d), 0.1 * rnd(d), rnd(d)
        v = 0.01 * torch.rand(d, generator=gen, device=dev)
        got = fused_adam(p, m, v, g, 1e-3, 0.9, 0.999, 1e-8, step)
        want = ref.fused_adam(p, m, v, g, 1e-3, 0.9, 0.999, 1e-8, step)
        err = max(check_close(f"fused_adam step {step} {k}", a, b, **TOL_ADAM)
                  for k, a, b in zip("pmv", got, want))
        print(f"fused_adam step={step} D={d}: max_abs_err={err!r} "
              f"(tol {TOL_ADAM})")
        if d == n:
            errs["fused_adam"] = max(errs["fused_adam"], err)
    torch.cuda.synchronize(dev)
    return errs


# -- phase 4: the main path --------------------------------------------------------

def profile_steps(engine, state, batches, k: int) -> dict:
    """Device busy time per engine step and the top ops by device time,
    from ``torch.profiler`` over ``k`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(k):
            state, _ = engine.step(state, next(batches))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / k
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / k
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / k,
                     e.count / k) for e in top]}


def run_engine(algo, kernels, params0, data, table, dev, *, workers, batch,
               steps, timed_steps, profile=0):
    """One main-path run: build_engine + Trainer for ``steps`` steps with
    the launch counters zeroed just before and read just after, then
    ``timed_steps`` more steps timed on the host clock between syncs, then
    ``profile`` steps under the profiler."""
    import torch
    from repro_torch import delays
    from repro_torch import treemath as tm
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import EngineConfig, Hook, Trainer, build_engine
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.stale_accum import stale_accum
    from repro_torch.models import mlp
    from repro_torch.optim import paper_default

    class LossLog(Hook):
        """Keeps each step's loss as a device tensor (no sync in the
        loop)."""

        def __init__(self):
            self.losses = []

        def on_step(self, ctx):
            self.losses.append(ctx.metrics["loss"])

    cfg = EngineConfig(mode="simulate", num_workers=workers, s=STALENESS,
                       delay=delays.Schedule(table), kernels=kernels)
    engine = build_engine(mlp.loss_fn, paper_default(algo), cfg, device=dev)
    batches = iter(ShardedBatches([data.x_train, data.y_train], workers,
                                  batch, seed=0))
    xt = torch.as_tensor(data.x_test, device=dev)
    yt = torch.as_tensor(data.y_test, device=dev)
    state = engine.init(0, params=tm.tree_map(torch.clone, params0))
    log = LossLog()

    stale_accum.launches = 0
    fused_adam.launches = 0
    res = Trainer(engine, hooks=[log]).run(
        batches, steps, state=state,
        eval_fn=lambda p: mlp.accuracy(p, xt, yt), eval_every=steps)
    launches = {"stale_accum": stale_accum.launches,
                "fused_adam": fused_adam.launches}

    state = res.state
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, _ = engine.step(state, next(batches))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(timed_steps, 1)
    prof = profile_steps(engine, state, batches, profile) if profile else None
    return {"profile": prof, "losses": torch.stack(log.losses).cpu(),
            "params": tm.tree_map(lambda x: x.cpu(),
                                  engine.params(res.state)),
            "accuracy": res.curve[-1][1], "launches": launches,
            "ms_per_step": ms, "meta": engine.meta["kernels"]}


def compare_runs(name, on, off, tol) -> None:
    import torch
    from repro_torch import treemath as tm
    loss_err = max_abs(on["losses"], off["losses"])
    pairs = list(zip(tm.tree_leaves(on["params"]),
                     tm.tree_leaves(off["params"])))
    param_err = max(max_abs(a, b) for a, b in pairs)
    diff = sum(float(((a - b).double() ** 2).sum()) for a, b in pairs) ** 0.5
    norm = sum(float((b.double() ** 2).sum()) for _, b in pairs) ** 0.5
    rel = diff / norm
    print(f"{name}: on vs off loss max_abs_err={loss_err!r} "
          f"param max_abs_err={param_err!r} rel_l2={rel!r} "
          f"(tol {tol}); accuracy on={on['accuracy']!r} "
          f"off={off['accuracy']!r}")
    for run in (on, off):
        if not torch.isfinite(run["losses"]).all():
            raise AssertionError(f"{name}: non-finite loss")
        for leaf in tm.tree_leaves(run["params"]):
            if not torch.isfinite(leaf).all():
                raise AssertionError(f"{name}: non-finite params")
    if loss_err > tol["loss"] or param_err > tol["param"]:
        raise AssertionError(f"{name}: kernels on and off disagree")
    if "rel" in tol and rel > tol["rel"]:
        raise AssertionError(f"{name}: kernels on and off disagree (rel)")


def check_launches(name, run, expect) -> None:
    print(f"{name}: launches {run['launches']} (expected {expect}); "
          f"routing {run['meta']}")
    if run["launches"] != expect:
        raise AssertionError(f"{name}: launch counts {run['launches']} != "
                             f"{expect}")


def sequential_check(dev, steps: int = 6) -> float:
    """s = 0, P = 1 packed engine == plain sequential SGD on a small input."""
    import numpy as np
    import torch
    from repro_torch import delays
    from repro_torch import treemath as tm
    from repro_torch.core import drain, sequential_reference
    from repro_torch.engine import EngineConfig, build_engine
    from repro_torch.models import mlp
    from repro_torch.optim import make_sgd_update_fn, sgd

    rng = np.random.default_rng(1)
    cfg = mlp.MLPConfig(in_dim=32, hidden=16, depth=2)
    params = mlp.init(3, cfg, device=dev)
    batches = [(torch.as_tensor(rng.standard_normal((1, 8, 32)), dtype=torch.float32, device=dev),
                torch.as_tensor(rng.integers(0, 10, (1, 8)), device=dev))
               for _ in range(steps)]
    engine = build_engine(mlp.loss_fn, sgd(0.05),
                          EngineConfig(mode="simulate", num_workers=1,
                                       delay=delays.Zero(), kernels="on"),
                          device=dev)
    state = engine.init(0, params=params)
    for b in batches:
        state, _ = engine.step(state, b)
    got = tm.tree_map(lambda x: x[0], drain(state.inner).caches)
    want = sequential_reference(make_sgd_update_fn(mlp.loss_fn, sgd(0.05)),
                                params, {"step": 0},
                                [(x[0], y[0]) for x, y in batches])
    err = max(check_close("sequential", a, b, **TOL_SEQUENTIAL)
              for a, b in zip(tm.tree_leaves(got), tm.tree_leaves(want)))
    print(f"s=0 P=1 packed engine vs sequential reference: "
          f"max_abs_err={err!r} (tol {TOL_SEQUENTIAL})")
    return err


def main_path(dev, *, depth=DEPTH, in_dim=784, hidden=256, workers=WORKERS,
              batch=BATCH, steps=STEPS, timed_steps=TIMED_STEPS, data=None):
    """Phase 4: Adam and SGD, kernels on vs off. Returns the four runs."""
    import numpy as np
    from repro_torch.data import synthetic
    from repro_torch.models import mlp

    if data is None:
        data = synthetic.teacher_classification(seed=0)
    params0 = mlp.init(0, mlp.MLPConfig(in_dim=in_dim, hidden=hidden,
                                        depth=depth), device=dev)
    # One delay table for every run: r[src, dst] = table[t, src] in
    # [0, s-1], the UniformDelay(s) range, so the ring has s slots.
    table = np.random.default_rng(0).integers(0, STALENESS, (steps, workers))
    table[0, 0] = STALENESS - 1
    kw = dict(workers=workers, batch=batch, steps=steps,
              timed_steps=timed_steps)
    runs = {}
    for algo in ("adam", "sgd"):
        for kernels in ("on", "off"):
            runs[algo, kernels] = run_engine(
                algo, kernels, params0, data, table, dev,
                profile=5 if dev.type == "cuda" else 0, **kw)
    compare_runs("adam", runs["adam", "on"], runs["adam", "off"],
                 TOL_ENGINE_ADAM)
    compare_runs("sgd", runs["sgd", "on"], runs["sgd", "off"], TOL_ENGINE_SGD)
    check_launches("adam on (fused step)", runs["adam", "on"],
                   {"stale_accum": steps, "fused_adam": steps})
    check_launches("sgd on (packed step)", runs["sgd", "on"],
                   {"stale_accum": steps, "fused_adam": 0})
    for algo in ("adam", "sgd"):
        check_launches(f"{algo} off (tree)", runs[algo, "off"],
                       {"stale_accum": 0, "fused_adam": 0})
    for (algo, kernels), run in runs.items():
        print(f"engine {algo} kernels={kernels}: "
              f"ms_per_step={run['ms_per_step']!r} "
              f"(mean of {timed_steps} steps after {steps}, host clock "
              f"between syncs)")
        if run["profile"] is not None:
            print(f"profile {algo} kernels={kernels}: "
                  f"{json.dumps(run['profile'])}")
    return runs


# -- phase 5: kernel timings ------------------------------------------------------

def time_ms(fn, arg_sets, reps: int = 60):
    """Mean ms per call with CUDA events, cycling through ``arg_sets``
    (sized past the 50 MB L2 so each call reads its inputs from HBM).

    Returns ``(device_ms, eager_ms)``. ``device_ms`` replays a CUDA graph of
    ``reps`` captured calls, so it is the device's time for the work with
    no host gaps between launches; ``eager_ms`` times the same calls issued
    from Python, which at these sizes is bounded by the host's per-call
    cost."""
    import torch
    k = len(arg_sets)
    for i in range(k * 2):
        fn(*arg_sets[i % k])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    start.record()
    for i in range(reps):
        fn(*arg_sets[i % k])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / reps

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % k])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / reps
    del graph
    return device, eager


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_timings(dev, n: int) -> dict:
    """Kernel, plain version and library call at the main path's shapes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.stale_accum import stale_accum

    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = {}

    # stale_accum, S = 1: 32 MB per call; 5 sets cycle through 160 MB.
    sets = [(rnd(n), rnd(1, n), torch.ones(1, device=dev)) for _ in range(5)]
    fns = {"ms": stale_accum, "plain_ms": ref.stale_accum,
           "library_ms": lambda p, buf, w: torch.addmv(p, buf.t(), w)}
    out["stale_accum"] = {key: time_ms(fn, sets) for key, fn in fns.items()}
    out["stale_accum"]["bound"] = bound_ms((2 * n + n + 1) * 4, 2 * n)

    # fused_adam: 75 MB per call; 3 sets.
    sets = [(torch.zeros(n, device=dev), 0.1 * rnd(n),
             0.01 * torch.rand(n, generator=gen, device=dev), rnd(n))
            for _ in range(3)]
    adam = lambda p, m, v, g: fused_adam(p, m, v, g, 1e-3, 0.9, 0.999, 1e-8, 10)
    plain = lambda p, m, v, g: ref.fused_adam(p, m, v, g, 1e-3, 0.9, 0.999,
                                              1e-8, 10)
    steps = torch.full((1,), 10.0, device=dev)
    library = lambda p, m, v, g: torch._fused_adam_(
        [p], [g], [m], [v], [], [steps], lr=1e-3, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)
    fns = {"ms": adam, "plain_ms": plain, "library_ms": library}
    out["fused_adam"] = {key: time_ms(fn, sets) for key, fn in fns.items()}
    out["fused_adam"]["bound"] = bound_ms(7 * n * 4, 16 * n)

    rows = {}
    for name, t in out.items():
        (b, why) = t.pop("bound")
        rows[name] = {key: dev_ms for key, (dev_ms, _) in t.items()}
        rows[name]["eager_ms"] = {key: eager for key, (_, eager) in t.items()}
        rows[name].update(bound_ms=b, bound_by=why)
        print(f"timing {name} N={n} (device time, CUDA graph replay): "
              f"kernel {rows[name]['ms']!r} ms, bound {b!r} ms ({why}), "
              f"plain {rows[name]['plain_ms']!r} ms, library "
              f"{rows[name]['library_ms']!r} ms; eager calls from Python "
              f"{rows[name]['eager_ms']}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import treemath as tm
    from repro_torch.kernels import build, dispatch
    from repro_torch.models import mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    path, log, secs = build.build()
    build.library()
    print(f"build: {path.name} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    # The packed width at the main path's shapes: D = 335,114 padded to
    # 335,872, times P = 8 workers.
    width = tm.padded_size(
        tm.pack_spec(mlp.init(0, mlp.MLPConfig(depth=DEPTH), device=dev)).total,
        dispatch.PACK_ALIGN)
    n = WORKERS * width
    print(f"packed width D_pad={width}, N=P*D_pad={n}")
    errs = kernel_checks(dev, n)

    runs = main_path(dev)
    sequential_check(dev)
    timings = kernel_timings(dev, n)

    replaces = {"stale_accum": "src/repro/kernels/stale_accum.py:38",
                "fused_adam": "src/repro/kernels/fused_adam.py:48"}
    kernels = []
    for name in ("stale_accum", "fused_adam"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": runs["adam", "on"]["launches"][name],
            "launches_by_run": {algo: runs[algo, "on"]["launches"][name]
                                for algo in ("adam", "sgd")},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "eager_ms": t["eager_ms"]})
    steps_line = {f"{algo}_{k}": runs[algo, k]["ms_per_step"]
                  for algo, k in runs}
    print(json.dumps({"engine_ms_per_step": steps_line}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
