#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   printing each kernel's registers, spills and static shared memory (from
   ``-Xptxas -v``; for the coherence kernels also the blocks an SM those
   registers allow) and, where the toolkit has ``cuobjdump``, the count of
   tensor-core (HMMA) instructions in each ``flash_attention`` entry;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at a ragged D;
4. the simulate path: the simulate engine training the full-width Fig.
   1(e)(f) DNN (784 -> 256 x 3 -> 10, P = 8 workers, s = 16, batch 32 per
   worker) through ``build_engine`` + ``Trainer`` with ``kernels="on"``, for
   Adam (fused step: ``stale_accum`` + ``fused_adam``) and SGD (packed step:
   ``stale_accum``), each held against the ``kernels="off"`` tree layout in
   plain torch on the card, with launch counters checked; and the s = 0,
   P = 1 packed engine against the sequential reference on a small input;
4b. the paper's other models (``paper_path``) at their published widths,
   P = 8, s = 16, 50 steps under the same delay table, through
   ``build_engine`` + ``Trainer``, kernels on against off: ResNet-32
   (widths 16/32/64, 32 x 32 images) with Adam (``stale_accum`` +
   ``fused_adam``) and SGD, MF at MovieLens-1M's shape (6,040 x 3,706,
   rank 5, ~1.0 M ratings), the VAE 784 -> 256 x 3 -> 2 x 32 with Adam,
   and LDA (K = 50, 400 documents of 64 tokens) through
   ``experiments.lda_run``; each leg held step by step from shared states
   (``shared_state_check``) and free-running against witnesses that move
   every update one ulp (the VAE's free-running runs only against a
   ceiling), with launch counters checked, the ResNet Adam and MF legs
   replayed bit for bit and LDA's on and off runs equal bit for bit, under
   ``cudnn.deterministic``; ms per step and the device-busy share of 5
   profiled steps per leg; then ``paper_points``: batches to target of
   ``cnn_experiment`` (ResNet-8, s = 0 and 8) and ``mf_experiment`` (s = 0
   and 10) at their defaults;
5. the ring path: the same DNN in the gradient-ring modes (``stale-psum``,
   ``ssp``, ``sync``; global batch 256) with the compensation layer, seven
   legs of 50 steps with ``kernels="on"`` (``fused_update`` in its three
   variants, ``sparsify_topk`` + ``stale_accum``, ``fused_adam``), each
   held against the same leg with ``kernels="off", megakernel="off"`` on
   the card, with launch counters checked;
6. timings with CUDA events: ms per engine step, and each kernel's time
   beside its bound, its plain version and one PyTorch library call (where
   one computes the same function);
7. the coherence path: ``coherence_dots`` against fp64 and its plain
   version (W = 8, 16 at the packed width, W = 3 at a ragged D; bitwise
   replay); the simulate Adam leg of ``examples/coherence_adaptive.py``
   (50 steps) with ``CoherenceHook(kernels=True, window=8, every=5)`` and
   its ``CoherenceController``, held against the same leg with the plain
   reduction (mu within the kernel's tolerance, the same ``allowed_s``,
   two kernel runs equal), with ``CheckpointHook`` (the last snapshot
   restores the eval params bit for bit) and ``TraceRecorderHook`` (the
   trace drives ``ssp`` steps as ``Trace(path, bound=16)``); the
   ``stale-psum`` Adam leg with ``lr_scale="theorem1"`` fed by the hook,
   kernels on vs off; the hook's cost per step and the split of one probe;
   ``coherence_dots``'s time beside its bound, its plain version and
   ``torch.mv``; its time at W = 8 over D = D_pad x 1-16 beside
   ``torch.sum`` and ``copy_`` over the same bytes, each series fit to
   fixed + bytes / rate (``coherence_sweep``);
8. the serve path: ``paged_attention`` against its plain version on the
   card at the head shapes of h2o-danube-1.8b (32/8/80), deepseek-7b
   (32/32/128, a pool past 2^31 elements) and qwen3-14b (40/8/128), with 8
   slots, 8- and 16-row pages, a ring that T does not divide, wrapped
   rings, lazily allocated and empty slots, windows 0, 16 and 4096, the
   last layer's columns, fp32 and bf16 operands, and two calls bitwise; its
   time beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` over the gathered ring, and at other
   split counts than the wrapper's; then the
   full-width h2o-danube-1.8b (24 layers, random weights from seed 0)
   served through ``Server`` on the paged route (the kernel): 16 requests
   over 8 slots, prompts of 128, up to 96 new tokens, bf16 compute over
   fp32 params, with the launch count checked against 24 x decode steps and
   the device-busy share of 5 decode steps under ``torch.profiler``; the
   same stream at fp32 on the paged and the gather route (no kernel), whose
   greedy tokens must agree up to the first near-tie; and the gather route
   at bf16, timed for the record;
9. the train path: ``flash_attention`` against its plain version at the
   head shapes of h2o-danube-1.8b, deepseek-7b and qwen3-14b (full causal
   at 2048, a 4096 window over 5120 keys, right-aligned Sq of 1, 17 and
   128 over 2085 keys, bidirectional; fp32 and bf16; two calls bitwise),
   timed beside its bound, its plain version and
   ``F.scaled_dot_product_attention``; the full-width, full-depth
   h2o-danube-1.8b (~1.83 B params, remat on) trained through the train
   CLI (``repro_torch.launch.train.main``) in sync mode with
   ``--kernels on`` (``fused_adam``), profiled, then ``--kernels off``;
   on its trained params, every layer's attention sent through
   ``dispatch.flash_attention`` and held against the model's own
   attention; the same width cut to 4 layers in the ring legs through the
   CLI (stale-psum, ssp, simulate, stale-psum top-k, SGD top-k with
   inverse LR scaling, and stale-psum with ``--coherence``, a checkpoint
   that restores bit for bit and a recorded trace that replays), each on
   against off; qwen2-moe-a2.7b at full width with 1 layer, stale-psum
   over the aggregate ring through ``make_train_engine``, on against off;
   and kernels 1-5 timed at the LM width.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.

``python3 chip_smoke.py --attention-times SRC`` runs only the two attention
kernels' timings, with the ``repro_torch`` package under ``SRC`` (see
``attention_times``); ``--coherence-times SRC`` only ``coherence_dots``'s
ptxas lines, checks, timings at the DNN and LM widths and D sweep (see
``coherence_times``).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet) at a 700 W limit:
# memory, fp32 outside the tensor cores, dense bf16 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

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
# fused_update, kernel vs plain version: the EF split, the momentum mask and
# the delivered sum u repeat the plain version's operations in its order,
# one rounding each, so they are equal bit for bit (checked); p', m', v'
# are TOL_ADAM's (the plain version divides by a scalar as a multiply by
# its reciprocal).
TOL_UPDATE = TOL_ADAM
# Ring legs, kernels on vs off (tree layout, plain torch, no megakernel):
# the two sum each step's P delayed rows in another order, so they part at
# fp32 roundoff; Adam's per-element normalisation can turn roundoff in an
# element near zero into up to 2 * lr (1e-3) of update, carried on over 50
# steps, as in the simulate check. SGD is linear in the gradient: a top-k
# flip moves one element by lr * thr / P and nothing amplifies it.
# Compressed Adam parts further: once the accumulators differ by roundoff,
# elements within roundoff of a row's top-k threshold flip between kept and
# held back, Adam turns each flip into a full lr step, and the changed
# gradients flip others. tools/ring_drift.py shows that this is the
# dynamics and not the kernels: two kernels-off runs started one ulp apart
# part as far (PERF.md, section 6). So each compressed Adam leg is held
# twice, with limits between the sound readings (on vs off, and the one-ulp
# witnesses) and the planted-fault readings of that script on the H100:
# over the first EARLY_STEPS steps, before flips compound (sound <= 3.0e-6,
# faults >= 6.2e-4), and over all 50 in loss and params' relative L2
# (stale-psum: sound <= 2.2e-2 / 4.4e-2, faults >= 3.0e-2 / 6.6e-2; sync:
# sound <= 4.3e-3 / 9.4e-3, faults >= 1.5e-2 / 1.6e-2). The 50-step
# limits have little room on either side: a change to the order of a sum
# moves the sound readings, and then the script is run again to re-derive
# them. No max-abs param limit: Adam moves a param by at most ~lr a step,
# so 50 steps bound it for any run.
EARLY_STEPS = 5
TOL_RING = {
    "adam": dict(loss=1e-3, param=2e-2, rel=1e-3),
    "adam_compress": dict(early=1e-4, loss=2.5e-2, rel=5.4e-2),
    "adam_compress_sync": dict(early=1e-4, loss=8e-3, rel=1.2e-2),
    "sgd_compress": dict(loss=1e-4, param=1e-3, rel=1e-3, early=1e-5),
}


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


def update_operands(dev, r: int, d: int, seed: int) -> dict:
    """Random fused_update / sparsify_topk operands on ``dev``: R rows of
    width D, a threshold keeping about 10% of a standard normal row, fresh
    flags on every other row (rows 0, 2, ...), the LR factor as a device
    scalar."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {"p": rnd(d), "m": 0.1 * rnd(d),
            "v": 0.01 * torch.rand(d, generator=gen, device=dev),
            "stale": rnd(r, d),
            "weights": torch.full((r,), 1.0 / r, device=dev),
            "acc": rnd(r, d), "thr": torch.full((r,), 1.64, device=dev),
            "fresh": (torch.arange(r, device=dev) % 2 == 0).float(),
            "mom": 0.1 * rnd(r, d), "scale": torch.full((1,), 0.5, device=dev)}


def variant_args(ops: dict, variant: str, ring: bool = True):
    """(positional args, keyword args) of one fused_update variant.
    ``ring=False`` is the sync tail's EF call: no ring rows, every row
    fresh (``stale=None, fresh=None``)."""
    args = [ops[k] for k in ("p", "m", "v", "stale", "weights")]
    kw = {}
    if variant != "plain":
        kw = {k: ops[k] for k in ("acc", "thr", "fresh")}
        if not ring:
            args[3] = kw["fresh"] = None
    if variant == "ef_mom":
        kw["mom"] = ops["mom"]
    return args, kw


def same(name, a, b) -> None:
    import torch
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(max abs {max_abs(a, b)!r})")


def check_update(name, ops, variant, ring=True) -> float:
    """fused_update ``variant`` vs its plain version on ``ops``: p/m/v
    within TOL_UPDATE; u, the split and the momentum bitwise; sent + resid
    == acc. Returns the p/m/v max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_update import fused_update
    args, kw = variant_args(ops, variant, ring)
    got = fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 10, ops["scale"], **kw)
    want = ref.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 10, ops["scale"],
                            **kw)
    err = max(check_close(f"{name} {k}", a, b, **TOL_UPDATE)
              for k, a, b in zip("pmv", got, want))
    for k, a, b in zip(("u", "sent", "resid", "mom"), got[3:], want[3:]):
        same(f"{name} {k}", a, b)
    if variant != "plain":
        same(f"{name} sent + resid vs acc", got[4] + got[5], ops["acc"])
    print(f"{name}: p/m/v max_abs_err={err!r} (tol {TOL_UPDATE}); "
          f"u, split and momentum bitwise equal")
    return err


def check_sparsify(name, ops) -> None:
    """sparsify_topk vs its plain version on ``ops``: bitwise, and sent +
    resid == acc."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparsify import sparsify_topk
    sent, resid = sparsify_topk(ops["acc"], ops["thr"])
    want = ref.sparsify_mask(ops["acc"], ops["thr"])
    same(f"{name} sent", sent, want[0])
    same(f"{name} resid", resid, want[1])
    same(f"{name} sent + resid vs acc", sent + resid, ops["acc"])
    kept = float((sent != 0).float().mean())
    print(f"{name}: bitwise equal, sent + resid == acc; kept {kept!r}")


def ring_kernel_checks(dev, d: int) -> dict:
    """fused_update (three variants) and sparsify_topk against their plain
    versions on ``dev``: R = 8 and R = 1 at the ring path's packed width D,
    and R = 3 at a ragged D; the EF variants also in the sync tail's form
    (no ring rows) at R = 1. Returns the max abs error at R = 8, width D."""
    import torch
    from repro_torch.kernels.fused_update import VARIANTS

    errs = {"fused_update": 0.0, "sparsify_topk": 0.0}
    for r, width in ((8, d), (1, d), (3, 1_000_003)):
        ops = update_operands(dev, r, width, seed=r)
        forms = [(variant, True) for variant in VARIANTS]
        if r == 1:
            forms += [(variant, False) for variant in VARIANTS[1:]]
        for variant, ring in forms:
            err = check_update(f"fused_update {variant} R={r} D={width}"
                               f"{'' if ring else ' (no ring)'}", ops,
                               variant, ring)
            if r == 8 and width == d:
                errs["fused_update"] = max(errs["fused_update"], err)
        check_sparsify(f"sparsify_topk R={r} D={width}", ops)
    torch.cuda.synchronize(dev)
    return errs


# -- phase 4: the simulate path --------------------------------------------

def device_events(prof) -> list:
    """The profile's device kernels (and device copies and sets), summed by
    name. ``key_averages()`` also lists every host op with the device time
    of the kernels it launched, so a sum over all its entries would count
    each kernel twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def busy_union_ms(prof) -> float:
    """Device busy time: the union of the device events' spans, in ms.
    Where kernels overlap (cuDNN's convolutions run some concurrently),
    the sum of their times exceeds the time the device was busy."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_steps(engine, state, batches, k: int) -> dict:
    """Device busy time per engine step (the sum of the device events'
    times, and the union of their spans, which sets the idle share) and
    the top ops by device time, from ``torch.profiler`` over ``k``
    steps."""
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
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / k
    union_ms = busy_union_ms(prof) / k
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_busy_union_ms_per_step": union_ms,
            "idle_share": 1.0 - union_ms / wall_ms if union_ms else None,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / k,
                     e.count / k) for e in top]}


def reset_counters() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.coherence import coherence_dots
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.fused_update import fused_update
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.sparsify import sparsify_topk
    from repro_torch.kernels.stale_accum import stale_accum
    for fn in (stale_accum, fused_adam, sparsify_topk, coherence_dots,
               paged_attention, flash_attention):
        fn.launches = 0
    fused_update.by_variant = dict.fromkeys(fused_update.by_variant, 0)


def counters() -> dict:
    """Every kernel wrapper's launch count, fused_update by variant."""
    from repro_torch.kernels.coherence import coherence_dots
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.fused_update import fused_update
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.sparsify import sparsify_topk
    from repro_torch.kernels.stale_accum import stale_accum
    out = {"stale_accum": stale_accum.launches,
           "fused_adam": fused_adam.launches,
           "sparsify_topk": sparsify_topk.launches,
           "coherence_dots": coherence_dots.launches,
           "paged_attention": paged_attention.launches,
           "flash_attention": flash_attention.launches}
    for variant, n in fused_update.by_variant.items():
        out[f"fused_update.{variant}"] = n
    return out


def expect(steps: int, **per_step) -> dict:
    """The counters a run of ``steps`` steps should leave: ``per_step``
    launches each (``fused_update_plain=1`` names ``fused_update.plain``),
    0 for every other kernel."""
    out = dict.fromkeys(counters(), 0)
    for key, n in per_step.items():
        key = key.replace("fused_update_", "fused_update.")
        if key not in out:
            raise KeyError(key)
        out[key] = n * steps
    return out


def drive(engine, params0, batches, xt, yt, dev, *, steps, timed_steps,
          profile=0, hooks=(), eval_fn=None):
    """One main-path run through ``Trainer`` (with ``hooks`` after the loss
    log): ``steps`` steps with the launch counters zeroed just before and
    read just after, then ``timed_steps`` more steps timed on the host clock
    between syncs, then ``profile`` steps under the profiler. ``eval_fn``
    (evaluated once, after ``steps``; default the DNN's accuracy on ``xt``,
    ``yt``) gives the run's ``accuracy`` entry."""
    import torch
    from repro_torch import treemath as tm
    from repro_torch.engine import Hook, Trainer
    from repro_torch.models import mlp

    class LossLog(Hook):
        """Keeps each step's loss as a device tensor (no sync in the
        loop)."""

        def __init__(self):
            self.losses = []

        def on_step(self, ctx):
            self.losses.append(ctx.metrics["loss"])

    state = engine.init(0, params=tm.tree_map(torch.clone, params0))
    log = LossLog()
    reset_counters()
    if eval_fn is None:
        eval_fn = lambda p: mlp.accuracy(p, xt, yt)
    res = Trainer(engine, hooks=[log, *hooks]).run(
        batches, steps, state=state, eval_fn=eval_fn, eval_every=steps)
    launches = counters()

    state = res.state
    params = tm.tree_map(lambda x: x.detach().cpu(), engine.params(state))
    comp = ({k: v.detach().cpu() for k, v in state.comp.items()}
            if state.comp else {})
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
            "params": params, "comp": comp, "accuracy": res.curve[-1][1],
            "launches": launches, "ms_per_step": ms,
            "meta": engine.meta["kernels"]}


def run_engine(algo, kernels, params0, data, table, dev, *, workers, batch,
               steps, timed_steps, profile=0):
    """One simulate-path run (see ``drive``)."""
    import torch
    from repro_torch import delays
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import EngineConfig, build_engine
    from repro_torch.models import mlp
    from repro_torch.optim import paper_default

    cfg = EngineConfig(mode="simulate", num_workers=workers, s=STALENESS,
                       delay=delays.Schedule(table), kernels=kernels)
    engine = build_engine(mlp.loss_fn, paper_default(algo), cfg, device=dev)
    batches = iter(ShardedBatches([data.x_train, data.y_train], workers,
                                  batch, seed=0))
    xt = torch.as_tensor(data.x_test, device=dev)
    yt = torch.as_tensor(data.y_test, device=dev)
    return drive(engine, params0, batches, xt, yt, dev, steps=steps,
                 timed_steps=timed_steps, profile=profile)


def run_distance(a, b) -> dict:
    """How far two runs of one leg part: the max abs loss difference over
    the first EARLY_STEPS steps (``early``) and over all (``loss``), the
    max abs param difference (``param``) and the params' relative L2
    distance (``rel``, against ``b``)."""
    from repro_torch import treemath as tm
    dloss = (a["losses"] - b["losses"]).double().abs()
    pairs = list(zip(tm.tree_leaves(a["params"]),
                     tm.tree_leaves(b["params"])))
    diff = sum(float(((x - y).double() ** 2).sum()) for x, y in pairs) ** 0.5
    norm = sum(float((y.double() ** 2).sum()) for _, y in pairs) ** 0.5
    return {"early": float(dloss[:EARLY_STEPS].max()),
            "loss": float(dloss.max()),
            "param": max(max_abs(x, y) for x, y in pairs),
            "rel": diff / norm}


def compare_runs(name, on, off, tol) -> None:
    """Holds ``on`` against ``off`` within ``tol``: each key of ``tol``
    bounds that key of ``run_distance``."""
    import torch
    from repro_torch import treemath as tm
    dist = run_distance(on, off)
    print(f"{name}: on vs off {json.dumps(dist)} (tol {tol}); accuracy "
          f"on={on['accuracy']!r} off={off['accuracy']!r}; loss diff by "
          f"step {[float(x) for x in (on['losses'] - off['losses'])[:10]]}")
    for run in (on, off):
        if not torch.isfinite(run["losses"]).all():
            raise AssertionError(f"{name}: non-finite loss")
        for leaf in tm.tree_leaves(run["params"]):
            if not torch.isfinite(leaf).all():
                raise AssertionError(f"{name}: non-finite params")
    over = [key for key, limit in tol.items() if dist[key] > limit]
    if over:
        raise AssertionError(f"{name}: kernels on and off disagree "
                             f"({', '.join(over)})")


def check_launches(name, run, want) -> None:
    print(f"{name}: launches {run['launches']} (expected {want}); "
          f"routing {run['meta']}")
    if run["launches"] != want:
        raise AssertionError(f"{name}: launch counts {run['launches']} != "
                             f"{want}")


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
                   expect(steps, stale_accum=1, fused_adam=1))
    check_launches("sgd on (packed step)", runs["sgd", "on"],
                   expect(steps, stale_accum=1))
    for algo in ("adam", "sgd"):
        check_launches(f"{algo} off (tree)", runs[algo, "off"], expect(steps))
    for (algo, kernels), run in runs.items():
        print(f"engine {algo} kernels={kernels}: "
              f"ms_per_step={run['ms_per_step']!r} "
              f"(mean of {timed_steps} steps after {steps}, host clock "
              f"between syncs)")
        if run["profile"] is not None:
            print(f"profile {algo} kernels={kernels}: "
                  f"{json.dumps(run['profile'])}")
    return runs


# -- phase 4b: the paper's other models -------------------------------------

# Each leg runs P = 8 workers, s = 16, 50 steps under the simulate path's
# [50, 8] delay Schedule, kernels "on" against "off", at the published
# width: ResNet-32 (n = 5, widths 16/32/64, 8 groups) on 32 x 32 x 3
# images; MF at MovieLens-1M's shape (6,040 x 3,706, rank 5, ~1.0 M
# ratings); the VAE 784 -> 256 x 3 -> 2 x 32 (obs_scale 0.5); LDA with
# K = 50 over lda_corpus's 400 documents of 64 tokens, vocab 500.
PAPER = dict(resnet_n=5, resnet_widths=(16, 32, 64), image_hw=32,
             mf_users=6040, mf_items=3706, mf_density=0.04468,
             vae_dim=784, vae_depth=3, vae_latent=32,
             lda_topics=50, lda_docs=400, lda_len=64, lda_vocab=500)
# (name, model, optimizer, launches per step with kernels="on", replayed,
# free-running on vs off held to the witness)
PAPER_LEGS = (
    ("resnet32 adam", "resnet", "adam", dict(stale_accum=1, fused_adam=1),
     True, True),
    ("resnet32 sgd", "resnet", "sgd", dict(stale_accum=1), False, True),
    ("mf sgd", "mf", "sgd", dict(stale_accum=1), True, True),
    ("vae adam", "vae", "adam", dict(stale_accum=1, fused_adam=1), False,
     False),
)
# Every leg is also held step by step from shared states: at each of the
# off run's steps the kernels-on engine is handed the off state (caches,
# Adam moments, the ring in its packed layout, the generator) and both
# step once. From one state both routes compute the same gradients from
# the same draws, so only their roundings part them: deliveries add the
# same two numbers (caches), the moments repeat the same operations, and
# an update differs by a few ulps (fused_adam divides where PyTorch
# multiplies by a reciprocal; the ring sums a slot's rows in another
# order). Each is held relative to the largest magnitude in the off
# tensor. This is what holds the VAE leg: its free-running runs part at
# a discrete event, one worker's gradient changing at a ReLU or the logvar
# clip that a roundoff-sized difference crossed (PERF.md, section 6), and
# no run-level witness bounds when that happens; its free-running
# distances are printed and held to PAPER_CEILING only.
TOL_SHARED = dict(loss=1e-6, caches=1e-6, moments=1e-6, ring=1e-5)
# On vs off parts by roundoff, injected at every step. Packed delivery
# alone (stale_accum and the ring's index_add) matches the tree route to
# ~1e-7 over 50 steps; the parting is the optimizer's: the fused_adam
# kernel and tree Adam round an update differently (by up to an ulp), and
# Adam turns a gradient element that is itself roundoff into a full +-lr
# step whose sign the roundoff picks, which the ResNet's 32 layers and the
# VAE's sampled latents (at s = 16 its loss moves by tens of percent a
# step) carry on (PERF.md, section 6). So each leg's witnesses are the same
# kernels-off leg with every element of every update moved one ulp up, and
# one ulp down (``ulp_witness``), and its limit WITNESS_FACTOR times the
# larger of how far they part from the off run, in the largest relative
# loss difference over the first EARLY_STEPS steps (``early``) and over
# all 50 (``loss``), and the relative L2 distance of the updates
# (``rel``). Each limit is at least PAPER_FLOOR (a witness that reads 0
# would allow nothing) and at most PAPER_CEILING: over the first steps,
# before the dynamics amplify anything, roundoff moves a loss by ~1e-6 of
# itself and a dropped arrival or a wrong Adam step by far more than 1e-3;
# over 50 steps the ceiling stops only what no roundoff explains (a tenth
# of a loss, half the updates).
PAPER_FLOOR = dict(early=1e-6, loss=1e-6, rel=1e-6)
PAPER_CEILING = dict(early=1e-3, loss=0.1, rel=0.5)
# The paper's metric, batches to target, through the experiment twins at
# their defaults, capped at the quick figures' step budgets.
PAPER_POINTS = (("cnn_experiment", dict(n_blocks=1, algo="sgd", workers=8),
                 (0, 8), 400),
                ("mf_experiment", dict(workers=8), (0, 10), 3000))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms only (its default weight-gradient
    algorithms for the ResNet's grouped convolutions may add with atomics,
    which would break the bitwise replay); restored on exit."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def paper_model(dev, model: str) -> dict:
    """A leg's loss, params (seed 0), batches and evaluation at full
    width."""
    import torch
    from repro_torch import device as device_lib
    from repro_torch.data import ShardedBatches, synthetic
    from repro_torch.models import mf, resnet, vae

    if model == "resnet":
        cfg = resnet.ResNetConfig(n=PAPER["resnet_n"],
                                  widths=PAPER["resnet_widths"])
        params, strides = resnet.init(0, cfg, device=dev)
        data = synthetic.synthetic_images(seed=0, hw=PAPER["image_hw"])
        acc = resnet.make_accuracy_fn(cfg, strides)
        xt = torch.as_tensor(data.x_test[:512], device=dev)
        yt = torch.as_tensor(data.y_test[:512], device=dev)
        return dict(loss=resnet.make_loss_fn(cfg, strides), params=params,
                    arrays=[data.x_train, data.y_train], batch=BATCH,
                    eval_fn=lambda p: acc(p, xt, yt), metric="accuracy")
    if model == "mf":
        data = synthetic.low_rank_ratings(
            seed=0, num_users=PAPER["mf_users"], num_items=PAPER["mf_items"],
            density=PAPER["mf_density"])
        cfg = mf.MFConfig(num_users=data.num_users, num_items=data.num_items)
        arrays = (data.rows, data.cols, data.vals)
        full = [torch.as_tensor(a, device=dev) for a in arrays]
        return dict(loss=mf.make_loss_fn(cfg),
                    params=mf.init(0, cfg, device=dev), arrays=list(arrays),
                    batch=500, n_obs=len(data.rows), metric="objective",
                    eval_fn=lambda p: mf.full_objective(p, *full, cfg))
    cfg = vae.VAEConfig(in_dim=PAPER["vae_dim"], hidden=256,
                        depth=PAPER["vae_depth"], latent=PAPER["vae_latent"],
                        obs_scale=0.5)
    data = synthetic.vae_data(seed=0, dim=PAPER["vae_dim"])
    xt = torch.as_tensor(data.x_test[:512], device=dev)
    return dict(loss=vae.make_loss_fn(cfg), params=vae.init(0, cfg, device=dev),
                arrays=[data.x_train], batch=BATCH, takes_key=True,
                metric="test_loss",
                eval_fn=lambda p: vae.test_loss(
                    p, xt, device_lib.generator(99, dev), cfg))


def ulp_witness(opt, toward: float):
    """``opt`` with every element of each update moved one ulp toward
    ``toward`` (+inf or -inf): the roundoff witness of a paper leg."""
    import torch
    from repro_torch import treemath as tm
    from repro_torch.optim import Optimizer

    def update(grads, state, params):
        delta, state = opt.update(grads, state, params)
        return tm.tree_map(
            lambda d: torch.nextafter(d, torch.full_like(d, toward)),
            delta), state

    return Optimizer(opt.init, update)


def paper_engine(dev, m: dict, algo: str, kernels: str, table,
                 witness=None):
    """A paper leg's simulate engine (P = 8, s = 16, the delay table), with
    the optimizer as the experiment twins use it (MF: SGD at lr 1.0;
    ``witness``, +-inf, wraps it in ``ulp_witness``), and its batches."""
    from repro_torch import delays
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import EngineConfig, build_engine
    from repro_torch.optim import paper_default, sgd

    opt = sgd(1.0) if m["metric"] == "objective" else paper_default(algo)
    if witness is not None:
        opt = ulp_witness(opt, witness)
    cfg = EngineConfig(mode="simulate", num_workers=WORKERS, s=STALENESS,
                       delay=delays.Schedule(table), kernels=kernels,
                       loss_takes_key=m.get("takes_key", False))
    return (build_engine(m["loss"], opt, cfg, device=dev),
            iter(ShardedBatches(m["arrays"], WORKERS, m["batch"], seed=0)))


def paper_run(dev, m: dict, algo: str, kernels: str, params0, table, *,
              steps, timed_steps, profile=0, witness=None) -> dict:
    """One run of a paper leg through ``build_engine`` + ``Trainer``
    (``drive``)."""
    engine, batches = paper_engine(dev, m, algo, kernels, table, witness)
    return drive(engine, params0, batches, None, None, dev, steps=steps,
                 timed_steps=timed_steps, profile=profile,
                 eval_fn=m["eval_fn"])


def paper_distance(a: dict, b: dict, p0) -> dict:
    """How far two runs of a paper leg part: the largest relative loss
    difference over the first EARLY_STEPS steps and over all, and the
    relative L2 distance of their updates (params minus the shared init
    ``p0``)."""
    from repro_torch import treemath as tm
    la, lb = a["losses"].double(), b["losses"].double()
    dloss = (la - lb).abs() / lb.abs().clamp_min(1e-30)
    diff = norm = 0.0
    for x, y, c in zip(tm.tree_leaves(a["params"]),
                       tm.tree_leaves(b["params"]), tm.tree_leaves(p0)):
        x, y, c = (t.cpu().double() for t in (x, y, c))
        diff += float(((x - y) ** 2).sum())
        norm += float(((y - c) ** 2).sum())
    return {"early": float(dloss[:EARLY_STEPS].max()),
            "loss": float(dloss.max()),
            "rel": diff ** 0.5 / max(norm ** 0.5, 1e-30)}


def same_run(name: str, a: dict, b: dict) -> None:
    """Two runs of one leg are equal bit for bit (losses and params)."""
    import torch
    from repro_torch import treemath as tm
    equal = torch.equal(a["losses"], b["losses"]) and all(
        torch.equal(x, y) for x, y in zip(tm.tree_leaves(a["params"]),
                                          tm.tree_leaves(b["params"])))
    print(f"{name}: two kernels-on runs bitwise equal: {equal}")
    if not equal:
        raise AssertionError(f"{name}: kernels-on replay is not bitwise")


def shared_state_check(dev, m: dict, algo: str, table, *,
                       steps=STEPS) -> dict:
    """Each of the off run's ``steps`` steps taken again by the kernels-on
    engine from the off state (TOL_SHARED); returns the largest relative
    difference of each kind over the steps."""
    import torch
    from repro_torch import treemath as tm
    from repro_torch.kernels import dispatch

    (on_engine, _), (off_engine, batches) = (
        paper_engine(dev, m, algo, k, table) for k in ("on", "off"))
    engines = {"on": on_engine, "off": off_engine}
    fused = engines["on"].meta["kernels"]["megakernel"] == "fused"
    states = {k: e.init(0, params=tm.tree_map(torch.clone, m["params"]))
              for k, e in engines.items()}
    pack = lambda tree: tm.tree_pack(tree, lead_ndim=1,
                                     pad_to=dispatch.PACK_ALIGN)
    slot = lambda pending, d: pack(tm.tree_map(lambda b: b[:, d], pending))

    def rel(got, want) -> float:
        return float((got - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))

    worst = dict.fromkeys(TOL_SHARED, 0.0)
    for t in range(steps):
        batch = next(batches)
        on, off = states["on"].inner, states["off"].inner
        ring = on.pending["ring"]
        slots = ring.shape[1]
        # Slot d of the tree ring lands at step t + d: the packed ring's
        # cursor position (t + d) mod B, slot t mod B prefetched.
        for d in range(slots):
            ring[:, (t + d) % slots] = slot(off.pending, d)
        on.pending["arrived"] = ring[:, t % slots].clone()
        on.caches = tm.tree_map(torch.clone, off.caches)
        on.update_state = ({k: pack(off.update_state[k]) for k in ("m", "v")}
                           if fused else tm.tree_map(
                               lambda x: x.clone() if torch.is_tensor(x)
                               else x, off.update_state))
        on.key.set_state(off.key.get_state())
        metrics = {}
        for k in ("on", "off"):
            states[k], metrics[k] = engines[k].step(states[k], batch)
        on, off = states["on"].inner, states["off"].inner
        got = {"loss": metrics["on"]["loss"].reshape(1),
               "caches": pack(on.caches),
               "ring": torch.stack([on.pending["ring"][:, (t + 1 + d) % slots]
                                    for d in range(slots)]),
               "moments": (torch.cat([on.update_state["m"],
                                      on.update_state["v"]])
                           if fused else torch.zeros(1, device=dev))}
        want = {"loss": metrics["off"]["loss"].reshape(1),
                "caches": pack(off.caches),
                "ring": torch.stack([slot(off.pending, d)
                                     for d in range(slots)]),
                "moments": (torch.cat([pack(off.update_state["m"]),
                                       pack(off.update_state["v"])])
                            if fused else torch.zeros(1, device=dev))}
        for key in worst:
            worst[key] = max(worst[key], rel(got[key], want[key]))
    return worst


def paper_leg(dev, leg, table, *, steps=STEPS,
              timed_steps=TIMED_STEPS) -> dict:
    """One paper leg: on (profiled), off, the two witnesses (off with every
    update moved one ulp up, and down), and a second on run where the leg
    is replayed; holds on against off within the witness-derived limit and
    checks the launch counters."""
    import math
    from repro_torch import treemath as tm

    name, model, algo, per_step, replayed, gated = leg
    m = paper_model(dev, model)
    shared = shared_state_check(dev, m, algo, table, steps=steps)
    print(f"paper {name}: kernels on from the off run's state, one step at "
          f"a time over {steps} steps: largest relative difference "
          f"{json.dumps(shared)} (tol {TOL_SHARED})")
    over = [k for k in shared if shared[k] > TOL_SHARED[k]]
    if over:
        raise AssertionError(f"{name}: from shared states kernels on and "
                             f"off disagree ({over})")
    p0 = tm.tree_map(lambda x: x.detach().cpu(), m["params"])
    kw = dict(steps=steps, timed_steps=timed_steps)
    on = paper_run(dev, m, algo, "on", m["params"], table,
                   profile=5 if dev.type == "cuda" else 0, **kw)
    off = paper_run(dev, m, algo, "off", m["params"], table, **kw)
    untimed = dict(steps=steps, timed_steps=0)
    wits = [paper_distance(paper_run(dev, m, algo, "off", m["params"],
                                     table, witness=toward, **untimed),
                           off, p0)
            for toward in (float("inf"), float("-inf"))]
    dist = paper_distance(on, off, p0)
    wdist = {k: max(w[k] for w in wits) for k in dist}
    limit = {k: min(max(WITNESS_FACTOR * wdist[k], PAPER_FLOOR[k]),
                    PAPER_CEILING[k]) for k in dist}
    print(f"paper {name}: on vs off {json.dumps(dist)}; witnesses (off, "
          f"updates one ulp up / down) vs off {json.dumps(wits)}; limit "
          f"{json.dumps(limit)}; {m['metric']} on={on['accuracy']!r} "
          f"off={off['accuracy']!r}; first losses on "
          f"{[float(x) for x in on['losses'][:5]]}")
    if not all(math.isfinite(w[k]) for w in wits for k in w):
        raise AssertionError(f"{name}: a witness went non-finite")
    for run in (on, off):
        if not all(math.isfinite(float(x)) for x in run["losses"]):
            raise AssertionError(f"{name}: non-finite loss")
        if not math.isfinite(run["accuracy"]):
            raise AssertionError(f"{name}: non-finite {m['metric']}")
    bounds = limit if gated else PAPER_CEILING
    over = [k for k in dist if dist[k] > bounds[k]]
    if over:
        raise AssertionError(f"{name}: kernels on and off part further "
                             f"than {'the witness' if gated else 'the ceiling'}"
                             f" allows ({over})")
    check_launches(f"paper {name} on", on, expect(steps, **per_step))
    check_launches(f"paper {name} off", off, expect(steps))
    if replayed:
        again = paper_run(dev, m, algo, "on", m["params"], table, **untimed)
        same_run(f"paper {name}", on, again)
    row = {"shared_state": shared, "on_vs_off": dist, "witness": wdist,
           "limit": limit if gated else PAPER_CEILING,
           "launches": on["launches"], "meta": on["meta"],
           "ms_per_step": {"on": on["ms_per_step"],
                           "off": off["ms_per_step"]},
           m["metric"]: {"on": on["accuracy"], "off": off["accuracy"]},
           "profile": on["profile"]}
    if "n_obs" in m:
        row["ratings"] = m["n_obs"]
    print(f"paper {name}: ms_per_step on={on['ms_per_step']!r} "
          f"off={off['ms_per_step']!r} (mean of {timed_steps} steps after "
          f"{steps}, host clock between syncs); profile (5 steps, kernels "
          f"on) {json.dumps(on['profile'])}")
    return row


def lda_leg(dev, table, *, steps=STEPS, timed_steps=TIMED_STEPS) -> dict:
    """LDA through ``experiments.lda_run`` (K = 50, P = 8; 5 sweeps of the
    50 documents a worker, 5 a step, are 50 steps), kernels on against
    off: both add the same
    integer deltas and share the Gumbel draws, so z and the counts agree
    bit for bit."""
    import itertools
    import torch
    from repro_torch import delays, experiments

    runs = {}
    for kernels in ("on", "off"):
        reset_counters()
        curve, engine, state, cfg, _ = experiments.lda_run(
            STALENESS, WORKERS, k_topics=PAPER["lda_topics"],
            sweeps=5, n_docs=PAPER["lda_docs"], doc_len=PAPER["lda_len"],
            vocab=PAPER["lda_vocab"], delay=delays.Schedule(table),
            kernels=kernels, device=dev)
        launches = counters()
        counted = engine.step_count(state)
        z = state.inner.update_state["z"].cpu()
        caches = {k: v.cpu() for k, v in state.inner.caches.items()}
        placeholder = torch.zeros((WORKERS, 1), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, _ = engine.step(state, placeholder)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / max(timed_steps, 1)
        prof = (profile_steps(engine, state, itertools.repeat(placeholder), 5)
                if kernels == "on" and dev.type == "cuda" else None)
        runs[kernels] = dict(curve=curve, z=z, caches=caches, ms=ms,
                             launches=launches, profile=prof,
                             meta=engine.meta["kernels"], steps=counted)
    on, off = runs["on"], runs["off"]
    equal = torch.equal(on["z"], off["z"]) and all(
        torch.equal(on["caches"][k], off["caches"][k]) for k in on["caches"])
    print(f"paper lda: steps {on['steps']}; z and counts on vs off bitwise "
          f"equal: {equal}; log-likelihood on {on['curve'][0][1]!r} -> "
          f"{on['curve'][-1][1]!r}, off -> {off['curve'][-1][1]!r}; "
          f"ms_per_step on={on['ms']!r} off={off['ms']!r}; profile (5 "
          f"steps, kernels on) {json.dumps(on['profile'])}")
    if not equal:
        raise AssertionError("lda: kernels on and off disagree")
    if not on["curve"][-1][1] > on["curve"][0][1]:
        raise AssertionError("lda: the log-likelihood did not rise")
    if on["steps"] != steps:
        raise AssertionError(f"lda: {on['steps']} steps, not {steps}")
    check_launches("paper lda on", {"launches": on["launches"],
                                    "meta": on["meta"]},
                   expect(steps, stale_accum=1))
    check_launches("paper lda off", {"launches": off["launches"],
                                     "meta": off["meta"]}, expect(steps))
    return {"launches": on["launches"], "meta": on["meta"],
            "ms_per_step": {"on": on["ms"], "off": off["ms"]},
            "log_likelihood": {"first": on["curve"][0][1],
                               "on": on["curve"][-1][1],
                               "off": off["curve"][-1][1]},
            "profile": on["profile"]}


def paper_points(dev) -> dict:
    """Batches to target for two experiment pairs through the twins at
    their defaults (the paper's metric; printed, not compared)."""
    from repro_torch import experiments
    out = {}
    for fn, kw, stalenesses, budget in PAPER_POINTS:
        results = {s: getattr(experiments, fn)(s=s, max_steps=budget,
                                               device=dev, **kw)
                   for s in stalenesses}
        norm = experiments.normalized(results)
        for s, r in results.items():
            out[f"{fn} s={s}"] = {
                "batches_to_target": r.batches_to_target,
                "converged": r.converged, "normalized": norm[s],
                "last_eval": r.curve[-1] if r.curve else None,
                "wall_s": r.wall_s}
    print(json.dumps({"paper_points": out}))
    return out


def paper_path(dev, table) -> dict:
    """Phase 4b: the ResNet, MF, VAE and LDA legs, then the paper's
    metric. Returns the legs by name and the points."""
    with deterministic_cudnn():
        legs = {leg[0]: paper_leg(dev, leg, table) for leg in PAPER_LEGS}
        legs["lda"] = lda_leg(dev, table)
        return {"legs": legs, "points": paper_points(dev)}


# -- phase 5: the ring path ------------------------------------------------

# (name, mode, optimizer, compensation knobs, TOL_RING key, launches per
# step with kernels="on").
RING_LEGS = (
    ("stale-psum adam dense", "stale-psum", "adam", {}, "adam",
     dict(fused_update_plain=1)),
    ("stale-psum adam topk", "stale-psum", "adam",
     dict(compress="topk:0.1"), "adam_compress", dict(fused_update_ef=1)),
    ("stale-psum adam topk+ef_momentum", "stale-psum", "adam",
     dict(compress="topk:0.1", ef_momentum=0.9), "adam_compress",
     dict(fused_update_ef_mom=1)),
    ("stale-psum sgd topk+inverse", "stale-psum", "sgd",
     dict(compress="topk:0.1", lr_scale="inverse"), "sgd_compress",
     dict(sparsify_topk=1, stale_accum=1)),
    ("ssp adam dense", "ssp", "adam", {}, "adam",
     dict(fused_update_plain=1)),
    ("sync adam topk (R=1)", "sync", "adam", dict(compress="topk:0.1"),
     "adam_compress_sync", dict(fused_update_ef=1)),
    ("sync adam dense", "sync", "adam", {}, "adam", dict(fused_adam=1)),
)


def ring_run(dev, leg, kernels, params0, data, table, speeds, *,
             workers=WORKERS, batch=BATCH, steps=STEPS,
             timed_steps=TIMED_STEPS, profile=0) -> dict:
    """One run of one ring leg (a RING_LEGS entry) through ``drive``:
    ``kernels="on"`` with megakernel "auto", or ``"off"`` with megakernel
    "off"."""
    import torch
    from repro_torch import delays
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import EngineConfig, build_engine
    from repro_torch.models import mlp
    from repro_torch.optim import paper_default

    _, mode, algo, knobs = leg[:4]
    delay_kw = {"stale-psum": dict(delay=delays.Schedule(table)),
                "ssp": dict(ssp_speeds=speeds), "sync": {}}[mode]
    cfg = EngineConfig(mode=mode, num_workers=workers, s=STALENESS,
                       kernels=kernels,
                       megakernel="auto" if kernels == "on" else "off",
                       **delay_kw, **knobs)
    engine = build_engine(mlp.loss_fn, paper_default(algo), cfg, device=dev)
    batches = ShardedBatches([data.x_train, data.y_train], workers, batch,
                             seed=0).flat_iter()
    return drive(engine, params0, batches,
                 torch.as_tensor(data.x_test, device=dev),
                 torch.as_tensor(data.y_test, device=dev), dev, steps=steps,
                 timed_steps=timed_steps, profile=profile)


def ring_path(dev, params0, data, table, speeds, *, workers=WORKERS,
              batch=BATCH, steps=STEPS, timed_steps=TIMED_STEPS) -> dict:
    """Phase 5: every ring leg with kernels="on" (megakernel "auto")
    against kernels="off", megakernel="off", on ``dev``. Returns the runs
    by (leg name, "on" | "off")."""
    runs = {}
    for i, leg in enumerate(RING_LEGS):
        name, _, _, knobs, tol, per_step = leg
        for kernels in ("on", "off"):
            profile = 5 if (i == 0 and kernels == "on"
                            and dev.type == "cuda") else 0
            runs[name, kernels] = ring_run(
                dev, leg, kernels, params0, data, table, speeds,
                workers=workers, batch=batch, steps=steps,
                timed_steps=timed_steps, profile=profile)
        on, off = runs[name, "on"], runs[name, "off"]
        compare_runs(name, on, off, TOL_RING[tol])
        for key in on["comp"]:
            print(f"{name}: comp[{key!r}] on vs off max_abs_err="
                  f"{max_abs(on['comp'][key], off['comp'][key])!r}")
        check_launches(f"{name} on", on, expect(steps, **per_step))
        # kernels="off" still EF-splits through dispatch.sparsify_topk,
        # which is the kernel for CUDA tensors.
        split = dict(sparsify_topk=1) if "compress" in knobs else {}
        check_launches(f"{name} off", off, expect(steps, **split))
        for kernels in ("on", "off"):
            run = runs[name, kernels]
            print(f"ring {name} kernels={kernels}: "
                  f"ms_per_step={run['ms_per_step']!r} (mean of "
                  f"{timed_steps} steps after {steps}, host clock between "
                  f"syncs); accuracy={run['accuracy']!r}")
            if run["profile"] is not None:
                print(f"profile ring {name} kernels={kernels}: "
                      f"{json.dumps(run['profile'])}")
    return runs


# -- phase 6: kernel timings -----------------------------------------------

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

    # The graph allocates from its own pool: give it back what the eager
    # calls left cached (at the LM's D their outputs are GBs).
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % k])
    # Replay for ~25 ms first, so that the timed replay finds the card's
    # clocks and caches in the state this work keeps them in, not in one
    # that the previous phase left (a short call's graph lasts < 1 ms).
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < 0.025:
        graph.replay()
        torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / reps
    del graph
    return device, eager


def bound_ms(n_bytes: float, n_flops: float, peak: float = PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
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

    return summarize(out, n)


def update_bound(ops: dict, variant: str, ring: bool = True):
    """Least time of one fused_update call on these operands: each input
    it needs read once, each output written once (fp32), and its
    operations. The function needs a ring row only where it delivers it:
    every row for ``plain``, with EF only the rows that are not fresh (a
    fresh row delivers this step's sent), none without a ring."""
    r, d = ops["acc"].shape
    stale_rows = r
    if variant != "plain":
        stale_rows = int((ops["fresh"] <= 0).sum()) if ring else 0
    floats = 3 * d + stale_rows * d + r + 1  # p m v, ring rows, w, scale
    floats += 4 * d                          # p' m' v' u
    flops = (16 + 2 * r) * d                 # Adam, then u's R terms
    if variant != "plain":
        floats += r * d + r + 2 * r * d      # acc thr; sent resid
        floats += r if ring else 0           # fresh
        flops += 3 * r * d                   # |a| >= t, select, a - sent
    if variant == "ef_mom":
        floats += 2 * r * d                  # mom in and out
        flops += r * d
    return bound_ms(floats * 4, flops)


def ring_kernel_timings(dev, width: int) -> dict:
    """fused_update (each variant) and sparsify_topk at the ring path's
    shapes: R = 8 rows (the per-worker ring) and R = 1 (sync) of the packed
    width D. No single PyTorch call computes either function."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_update import fused_update
    from repro_torch.kernels.sparsify import sparsify_topk

    def update_fns(variant, ring):
        def kernel(ops):
            args, kw = variant_args(ops, variant, ring)
            return fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 10,
                                ops["scale"], **kw)

        def plain(ops):
            args, kw = variant_args(ops, variant, ring)
            return ref.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 10,
                                    ops["scale"], **kw)
        return kernel, plain

    out = {}
    # Sets sized so each cycle reads past the 50 MB L2 (13-69 MB a call).
    # R = 8 rows with every other row fresh; ef_r1 is the sync tail's call
    # (one row, no ring).
    for label, r, variant, ring, k in (
            ("plain", 8, "plain", True, 5), ("ef", 8, "ef", True, 3),
            ("ef_mom", 8, "ef_mom", True, 3), ("ef_r1", 1, "ef", False, 5)):
        sets = [(update_operands(dev, r, width, seed=100 + i),)
                for i in range(k)]
        kernel, plain = update_fns(variant, ring)
        out[f"fused_update.{label}"] = {
            "ms": time_ms(kernel, sets), "plain_ms": time_ms(plain, sets),
            "library_ms": (None, None),
            "bound": update_bound(sets[0][0], variant, ring)}
    sets = [(update_operands(dev, 8, width, seed=200 + i),) for i in range(4)]
    out["sparsify_topk"] = {
        "ms": time_ms(lambda ops: sparsify_topk(ops["acc"], ops["thr"]), sets),
        "plain_ms": time_ms(lambda ops: ref.sparsify_mask(ops["acc"],
                                                          ops["thr"]), sets),
        "library_ms": (None, None),
        "bound": bound_ms(3 * 8 * width * 4 + 8 * 4, 3 * 8 * width)}
    return summarize(out, width)


def summarize(out: dict, n: int) -> dict:
    """Per kernel: device ms (CUDA graph replay) of the kernel, its plain
    version and the library call, the eager ms of each, and the bound."""
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


def kernel_entries(timings: dict, runs: dict, ring: dict, errs: dict) -> list:
    """The ``{"kernels": [...]}`` entries: each kernel's launches on its
    main-path run (and on every run of its path), its max abs error against
    the plain version at the main path's shapes, and its timings."""
    replaces = {"stale_accum": "src/repro/kernels/stale_accum.py:38",
                "fused_adam": "src/repro/kernels/fused_adam.py:48"}
    ring_on = {name: run["launches"] for (name, k), run in ring.items()
               if k == "on"}
    kernels = []
    for name in ("stale_accum", "fused_adam"):
        t = timings[name]
        by_run = {f"simulate {algo}": runs[algo, "on"]["launches"][name]
                  for algo in ("adam", "sgd")}
        by_run.update({leg: c[name] for leg, c in ring_on.items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": runs["adam", "on"]["launches"][name],
            "launches_by_run": by_run,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "eager_ms": t["eager_ms"]})
    # fused_update's main-path run is the dense stale-psum Adam leg (the
    # plain variant); sparsify_topk's is the SGD top-k leg.
    fu_runs = {leg: sum(n for k, n in c.items()
                        if k.startswith("fused_update."))
               for leg, c in ring_on.items()}
    sp_runs = {leg: c["sparsify_topk"] for leg, c in ring_on.items()}
    for name, source, replaced, t, launches, by_run in (
            ("fused_update", "fused_update.cu",
             "src/repro/kernels/fused_update.py:147",
             timings["fused_update.plain"],
             ring_on["stale-psum adam dense"]["fused_update.plain"], fu_runs),
            ("sparsify_topk", "sparsify.cu",
             "src/repro/kernels/sparsify.py:41", timings["sparsify_topk"],
             ring_on["stale-psum sgd topk+inverse"]["sparsify_topk"],
             sp_runs)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaced, "launches": launches,
            "launches_by_run": by_run, "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "eager_ms": t["eager_ms"]})
    kernels[2]["variants"] = {
        label: {key: timings[f"fused_update.{label}"][key]
                for key in ("ms", "plain_ms", "bound_ms", "eager_ms")}
        for label in ("plain", "ef", "ef_mom", "ef_r1")}
    return kernels


def add_paper_launches(kernels: list, paper: dict) -> None:
    """Beside stale_accum's and fused_adam's other runs, their launches on
    each paper leg (kernels on)."""
    for entry in kernels:
        if entry["name"] in ("stale_accum", "fused_adam"):
            entry["launches_by_run"].update({
                f"paper {name}": leg["launches"][entry["name"]]
                for name, leg in paper["legs"].items()})


def coherence_entry(timings: dict, coh: dict, err: float) -> dict:
    """The ``{"kernels": [...]}`` entry of coherence_dots: its main-path
    run is the gated simulate leg with the kernel; times at W = 8, with
    W = 16 beside them, and torch.mv (the dots alone) for scale."""
    t = timings["coherence_dots.W8"]
    return {
        "name": "coherence_dots", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coherence.cu",
        "replaces": "src/repro/kernels/coherence.py:49",
        "launches": coh["gated", "on"]["launches"]["coherence_dots"],
        "launches_by_run": {f"{leg} {k}": run["launches"]["coherence_dots"]
                            for (leg, k), run in coh.items()},
        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "mv_ms": t["mv_ms"], "eager_ms": t["eager_ms"],
        "variants": {f"W{w}": {key: timings[f"coherence_dots.W{w}"][key]
                               for key in ("ms", "plain_ms", "bound_ms",
                                           "mv_ms", "eager_ms")}
                     for w in (8, 16)}}


# -- phase 7: the coherence path --------------------------------------------

# coherence_dots, kernel and plain version, normwise against fp64:
# |x - x64| <= COHERENCE_C * eps * sum_i |t_i| for the terms t_i of each sum
# (eps = 2^-23). The kernel's longest chain of roundings from a term to its
# output (a trip's 3-level tree, the U trips' tree, the per-thread cascade,
# the 5-level warp shuffle tree, the 8 warps' 3-level tree, the final
# grid's 8-slot and 5-level shuffle trees; kernels/coherence.py::
# chain_length) is 22 at W = 8 and 20 at W = 16 over D_pad, 23 at W = 3
# over the ragged D and 48 at the LM width (W = 4, where the cascade holds
# ~843 iterations a thread to 28 roundings), so 64 is its worst-case bound;
# the plain version is held to the same bound.
COHERENCE_C = 64
# The coherence phase: the example's window, probe cadence and controller.
PROBE_EVERY, WINDOW, PROBE_N = 5, 8, 1000
CONTROLLER = dict(s_max=16, lo=0.0, hi=0.3, patience=10)
CKPT_EVERY, TRACE_STEPS = 25, 5


def coherence_excess(out, h, g) -> float:
    """Largest error of (dots, hist_sq, g_sq) against fp64, in units of
    eps * sum |terms|: within tolerance when <= COHERENCE_C."""
    import torch
    h64, g64 = h.double(), g.double()
    want = (h64 @ g64, (h64 * h64).sum(-1), (g64 * g64).sum())
    scale = (h64.abs() @ g64.abs(), want[1], want[2])
    eps = torch.finfo(torch.float32).eps
    return max(float(((a.double() - w).abs() / (eps * sc).clamp(
        min=1e-300)).max()) for a, w, sc in zip(out, want, scale))


def coherence_kernel_checks(dev, width: int) -> float:
    """coherence_dots and its plain version against fp64 at W = 8 and 16
    (width D_pad) and W = 3 at a ragged D; two kernel calls replay bit for
    bit. Returns the kernel's max abs error against the plain version at
    W = 8, D_pad."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coherence import coherence_dots

    gen = torch.Generator(device=dev).manual_seed(3)
    err8 = None
    for w, d in ((8, width), (16, width), (3, 1_000_003)):
        h = torch.randn((w, d), generator=gen, device=dev)
        g = torch.randn((d,), generator=gen, device=dev)
        got, again = coherence_dots(h, g), coherence_dots(h, g)
        plain = ref.coherence_dots(h, g)
        k_exc, p_exc = coherence_excess(got, h, g), coherence_excess(plain, h, g)
        err = max(max_abs(a, b) for a, b in zip(got, plain))
        print(f"coherence_dots W={w} D={d}: error vs fp64 {k_exc!r} x eps "
              f"x sum|terms| (plain version {p_exc!r}; tol {COHERENCE_C}); "
              f"max_abs_err vs plain {err!r}")
        if k_exc > COHERENCE_C or p_exc > COHERENCE_C:
            raise AssertionError(f"coherence_dots W={w} D={d}: outside the "
                                 "fp64 tolerance")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"coherence_dots W={w} D={d}: two calls on "
                                 "the same inputs differ")
        if w == 8:
            err8 = err
    torch.cuda.synchronize(dev)
    print("coherence_dots: two calls replay bit for bit at every shape")
    return err8


def probe_hooks(data, dim: int, kernels: bool, controller: bool = True):
    """A CoherenceHook on Fig. 4's probe set (the first 1000 training
    samples) that also keeps, at each probe, the ring's largest row norm
    from before the observation (for the mu tolerance) and the reading."""
    from repro_torch.core import CoherenceController
    from repro_torch.engine import CoherenceHook
    from repro_torch.models import mlp

    class Probed(CoherenceHook):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.probes = []

        def on_step(self, ctx):
            probe = (ctx.step + 1) % self.every == 0
            if probe:
                hmax = self.monitor.history.norm(dim=1).max()
            super().on_step(ctx)
            if probe:
                self.probes.append((float(hmax), dict(self.last)))

    ctl = CoherenceController(**CONTROLLER) if controller else None
    return Probed(mlp.loss_fn, (data.x_train[:PROBE_N], data.y_train[:PROBE_N]),
                  dim=dim, window=WINDOW, every=PROBE_EVERY, controller=ctl,
                  kernels=kernels)


def mu_tolerance(hmax: float, reading: dict) -> float:
    """How far two fp32 readings of mu = min_w <h_w, g> / <g, g> may part
    when each sum is within COHERENCE_C * eps * sum|terms| of exact: per
    reading C * eps * (max_w ||h_w|| / ||g|| + |mu|) (Cauchy-Schwarz bounds
    sum|h g| by ||h|| ||g||), twice for two readings."""
    import torch
    eps = torch.finfo(torch.float32).eps
    return 2 * COHERENCE_C * eps * (hmax / max(reading["grad_norm"], 1e-30)
                                    + abs(reading["mu"]))


def coherence_path(dev, params0, data, table, tmp: str, *, workers=WORKERS,
                   batch=BATCH, steps=STEPS, timed_steps=TIMED_STEPS) -> dict:
    """Phase 7: the gated simulate leg (Adam, kernels="on", the CoherenceHook
    with the example's controller) with the hook's reduction on the kernel
    and on the plain version, twice with the kernel; the checkpoint and
    trace hooks on the first kernel run; the theorem1 stale-psum leg, on
    vs off. Returns the runs."""
    import numpy as np
    import torch
    from repro_torch import delays
    from repro_torch import treemath as tm
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import (CheckpointHook, EngineConfig, Hook,
                                    TraceRecorderHook, build_engine)
    from repro_torch.models import mlp
    from repro_torch.optim import paper_default

    dim = tm.tree_size(params0)
    xt = torch.as_tensor(data.x_test, device=dev)
    yt = torch.as_tensor(data.y_test, device=dev)
    trace_path = os.path.join(tmp, "trace.jsonl")
    ckpt_dir = os.path.join(tmp, "ckpt")

    class RestoreCheck(Hook):
        """After the run: the last snapshot restores the eval params bit
        for bit."""

        def on_end(self, ctx, result):
            step = ckpt.latest_step(ckpt_dir)
            params = ctx.engine.params(ctx.state)
            tree, got, _ = ckpt.restore(ckpt.step_path(ckpt_dir, step),
                                        like=params)
            same = all(torch.equal(a, b) for a, b in zip(
                tm.tree_leaves(tree), tm.tree_leaves(params)))
            print(f"checkpoint: steps {ckpt.steps_in(ckpt_dir)}, step {got} "
                  f"restores the eval params bit for bit: {same}")
            if not same or got != ctx.step + 1:
                raise AssertionError("checkpoint does not restore the eval "
                                     "params")

    def gated(kernels: bool, extra=()):
        cfg = EngineConfig(mode="simulate", num_workers=workers, s=STALENESS,
                           delay=delays.Schedule(table), kernels="on")
        engine = build_engine(mlp.loss_fn, paper_default("adam"), cfg,
                              device=dev)
        hook = probe_hooks(data, dim, kernels)
        batches = iter(ShardedBatches([data.x_train, data.y_train], workers,
                                      batch, seed=0))
        run = drive(engine, params0, batches, xt, yt, dev, steps=steps,
                    timed_steps=0, hooks=[hook, *extra])
        run["probes"] = hook.probes
        return run

    runs = {}
    runs["gated", "on"] = gated(True, extra=[
        CheckpointHook(ckpt_dir, every=CKPT_EVERY, keep_last=2),
        RestoreCheck(), TraceRecorderHook(trace_path)])
    runs["gated", "off"] = gated(False)
    runs["gated", "on2"] = gated(True)
    n_probes = steps // PROBE_EVERY
    check_launches("gated on", runs["gated", "on"],
                   {**expect(steps, stale_accum=1, fused_adam=1),
                    "coherence_dots": n_probes})
    check_launches("gated off", runs["gated", "off"],
                   expect(steps, stale_accum=1, fused_adam=1))
    on, off, again = (runs["gated", k]["probes"] for k in ("on", "off", "on2"))
    report = []
    for (hmax, a), (_, b), (_, c) in zip(on, off, again):
        tol = mu_tolerance(hmax, b)
        near = min(abs(b["mu"] - CONTROLLER["lo"]),
                   abs(b["mu"] - CONTROLLER["hi"])) <= tol
        report.append({"mu_on": a["mu"], "mu_off": b["mu"],
                       "diff": abs(a["mu"] - b["mu"]), "tol": tol,
                       "allowed_on": a["allowed_s"],
                       "allowed_off": b["allowed_s"], "near_threshold": near})
        if abs(a["mu"] - b["mu"]) > tol:
            raise AssertionError(f"gated leg: mu on {a['mu']!r} vs off "
                                 f"{b['mu']!r} beyond {tol!r}")
        if a["allowed_s"] != b["allowed_s"] and not near:
            raise AssertionError("gated leg: allowed_s differs at a probe "
                                 "whose mu is not near a threshold")
        if a["mu"] != c["mu"]:
            raise AssertionError("gated leg: two kernel runs give different "
                                 "mu traces")
    print(f"gated leg, {len(on)} probes (kernel vs plain reduction): "
          f"{json.dumps(report)}")
    flips = [r for r in report if r["allowed_on"] != r["allowed_off"]]
    print(f"gated leg: allowed_s {[r['allowed_on'] for r in report]} "
          f"(kernel) vs {[r['allowed_off'] for r in report]} (plain); "
          f"{len(flips)} probes differ, all within tolerance of a threshold; "
          f"two kernel runs give identical mu traces")
    compare_runs("gated", runs["gated", "on"], runs["gated", "off"],
                 TOL_RING["adam"])

    # The recorded trace drives a few ssp steps.
    durations, header = delays.read_trace(trace_path)
    spec = delays.Trace(trace_path, bound=STALENESS)
    engine = build_engine(mlp.loss_fn, paper_default("adam"),
                          EngineConfig(mode="ssp", num_workers=workers,
                                       s=STALENESS, delay=spec, kernels="on"),
                          device=dev)
    state = engine.init(0, params=tm.tree_map(torch.clone, params0))
    batches = ShardedBatches([data.x_train, data.y_train], workers, batch,
                             seed=0).flat_iter()
    losses = []
    for _ in range(TRACE_STEPS):
        state, m = engine.step(state, next(batches))
        losses.append(float(m["loss"]))
    table_t = np.asarray(engine.meta["ssp_schedule"])
    print(f"trace: {durations.shape} recorded ({header}); replayed as "
          f"Trace(bound={STALENESS}) in ssp: schedule {table_t.shape} in "
          f"[{table_t.min()}, {table_t.max()}], losses {losses}")
    if not (np.isfinite(losses).all() and table_t.max() <= STALENESS):
        raise AssertionError("trace replay: non-finite loss or bound broken")

    # Theorem-1 leg: stale-psum Adam, live mu and L from the hook.
    for kernels in ("on", "off"):
        cfg = EngineConfig(mode="stale-psum", num_workers=workers,
                           s=STALENESS, delay=delays.Schedule(table),
                           lr_scale="theorem1", kernels=kernels,
                           megakernel="auto" if kernels == "on" else "off")
        engine = build_engine(mlp.loss_fn, paper_default("adam"), cfg,
                              device=dev)
        hook = probe_hooks(data, dim, kernels == "on", controller=False)
        batches = ShardedBatches([data.x_train, data.y_train], workers,
                                 batch, seed=0).flat_iter()
        runs["theorem1", kernels] = drive(
            engine, params0, batches, xt, yt, dev, steps=steps,
            timed_steps=timed_steps, hooks=[hook])
        runs["theorem1", kernels]["probes"] = hook.probes
    t_on, t_off = runs["theorem1", "on"], runs["theorem1", "off"]
    compare_runs("theorem1 stale-psum adam", t_on, t_off, TOL_RING["adam"])
    check_launches("theorem1 on", t_on,
                   {**expect(steps, fused_update_plain=1),
                    "coherence_dots": n_probes})
    check_launches("theorem1 off", t_off, expect(steps))
    print("theorem1 leg (mu, lip) per probe, on / off: "
          f"{[(a['mu'], a['lip']) for _, a in t_on['probes']]} / "
          f"{[(b['mu'], b['lip']) for _, b in t_off['probes']]}; "
          f"comp on {t_on['comp']['mu']!r} {t_on['comp']['lip']!r}")
    return runs


def hook_cost(dev, params0, data, table, *, workers=WORKERS, batch=BATCH,
              steps=STEPS) -> dict:
    """ms per step of the gated leg with its CoherenceHook (kernel, the
    example's controller) against the same leg without hooks, run in turns
    (without, with, with, without) on the host clock between syncs; and the
    split of one probe: probe gradient, reduction, host read of mu."""
    import torch
    from repro_torch import delays
    from repro_torch import treemath as tm
    from repro_torch.core import CoherenceController
    from repro_torch.core import coherence as coh
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import (CoherenceHook, EngineConfig, Trainer,
                                    build_engine)
    from repro_torch.models import mlp
    from repro_torch.optim import paper_default

    cfg = EngineConfig(mode="simulate", num_workers=workers, s=STALENESS,
                       delay=delays.Schedule(table), kernels="on")
    engine = build_engine(mlp.loss_fn, paper_default("adam"), cfg, device=dev)
    batches = iter(ShardedBatches([data.x_train, data.y_train], workers, batch,
                                  seed=0))
    state = engine.init(0, params=tm.tree_map(torch.clone, params0))
    hook = CoherenceHook(mlp.loss_fn, (data.x_train[:PROBE_N],
                                       data.y_train[:PROBE_N]),
                         dim=tm.tree_size(params0), window=WINDOW,
                         every=PROBE_EVERY,
                         controller=CoherenceController(**CONTROLLER),
                         kernels=True)
    state = Trainer(engine, hooks=[hook]).run(batches, 10, state=state).state

    with_ms, without_ms = [], []
    for use in (False, True, True, False):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state = Trainer(engine, hooks=[hook] if use else []).run(
            batches, steps, state=state).state
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        (with_ms if use else without_ms).append(ms)

    # One probe, part by part, each between syncs (mean of 20).
    params = engine.params(state)
    probe = hook.probe_batch
    parts = {"probe_gradient": [], "reduction": [], "host_read": []}
    for _ in range(20):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        g = coh.probe_gradient(mlp.loss_fn, params, probe)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        hook.monitor, out = coh.observe(hook.monitor, g, kernels=True)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        torch.stack([out["mu"], out["grad_norm"]]).tolist()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    split = {key: sum(v) / len(v) for key, v in parts.items()}

    # Device time of one probe by kernel, from the profiler.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g = coh.probe_gradient(mlp.loss_fn, params, probe)
        hook.monitor, out = coh.observe(hook.monitor, g, kernels=True)
        torch.stack([out["mu"], out["grad_norm"]]).tolist()
        torch.cuda.synchronize(dev)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    out = {"with_hook_ms_per_step": sum(with_ms) / 2,
           "without_hooks_ms_per_step": sum(without_ms) / 2,
           "runs_ms_per_step": {"without": without_ms, "with": with_ms},
           "probe_split_ms": split, "probe_device_busy_ms": busy,
           "probe_top": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                         for e in top]}
    print(f"hook cost (simulate Adam, {steps} steps per run, probe every "
          f"{PROBE_EVERY}): {json.dumps(out)}")
    return out


def coherence_timings(dev, width: int) -> dict:
    """coherence_dots at W = 8 and 16 (width D_pad): kernel, plain version
    and torch.mv (the dots alone) beside the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coherence import coherence_dots

    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    # Sets past the 50 MB L2: 12 MB per call at W = 8, 23 MB at W = 16.
    for w, k in ((8, 6), (16, 3)):
        sets = [(torch.randn((w, width), generator=gen, device=dev),
                 torch.randn((width,), generator=gen, device=dev))
                for _ in range(k)]
        out[f"coherence_dots.W{w}"] = {
            "ms": time_ms(coherence_dots, sets),
            "plain_ms": time_ms(ref.coherence_dots, sets),
            "library_ms": (None, None),
            "mv_ms": time_ms(torch.mv, sets),
            "bound": bound_ms(((w + 1) * width + 2 * w + 1) * 4,
                              4 * w * width + 2 * width)}
    rows = summarize(out, width)
    for name, row in rows.items():
        print(f"timing {name}: torch.mv (the dots alone) {row['mv_ms']!r} ms")
    return rows


# coherence_sweep: W and the multiples of the DNN width it runs.
SWEEP_W, SWEEP_FACTORS = 8, (1, 2, 4, 8, 16)


def fit_line(points) -> tuple:
    """Least-squares (fixed ms, TB/s) of ms = fixed + bytes / rate."""
    n = len(points)
    mx = sum(b for b, _ in points) / n
    my = sum(t for _, t in points) / n
    slope = (sum((b - mx) * (t - my) for b, t in points)
             / sum((b - mx) ** 2 for b, _ in points))
    return my - slope * mx, 1e-9 / slope if slope > 0 else float("inf")


def coherence_sweep(dev, width: int) -> dict:
    """coherence_dots at W = SWEEP_W over D = width x SWEEP_FACTORS, beside
    two library yardsticks over the same bytes: torch.sum of one
    [(W + 1) D] fp32 tensor (a single-pass read) and copy_ of it into
    another (that read plus a write of as many bytes). Each series is fit
    to ms = fixed + bytes read / rate: the fixed part is what a call costs
    whatever its size (launches, ramp-up, the tail of the last wave, a
    reduction's final step), the rate what it streams at. Returns the
    points and the fits."""
    import torch
    from repro_torch.kernels.coherence import coherence_dots

    gen = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    w = SWEEP_W
    points = {"kernel": [], "sum": [], "copy": []}
    for f in SWEEP_FACTORS:
        d = width * f
        n_bytes = (w + 1) * d * 4
        k = -(-150_000_000 // n_bytes)        # sets past the 50 MB L2
        sets = [(rnd(w, d), rnd(d)) for _ in range(k)]
        flat = [(torch.empty((w + 1) * d, device=dev), rnd((w + 1) * d))
                for _ in range(k)]
        ms = {"kernel": time_ms(coherence_dots, sets)[0],
              "sum": time_ms(lambda dst, src: torch.sum(src), flat)[0],
              "copy": time_ms(lambda dst, src: dst.copy_(src), flat)[0]}
        for key, t in ms.items():
            points[key].append((n_bytes, t))
        print(f"coherence sweep W={w} D={d} ({n_bytes} B read): kernel "
              f"{ms['kernel']!r} ms, torch.sum {ms['sum']!r} ms, copy_ "
              f"{ms['copy']!r} ms (device time, CUDA graph replay)")
        del sets, flat
        torch.cuda.empty_cache()
    fits = {}
    for key, pts in points.items():
        fixed, rate = fit_line(pts)
        fits[key] = {"fixed_ms": fixed, "tb_per_s": rate}
        print(f"coherence sweep fit {key}: ms = {fixed!r} + bytes read / "
              f"({rate!r} TB/s)")
    return {"points": points, "fits": fits}


# -- phase 8: the serve path -------------------------------------------------

# paged_attention, fp32 operands: the kernel's online softmax (per-chunk max
# and rescale) and the plain version's one-shot softmax round differently;
# outputs are convex combinations of O(1) values, so a few ulps of 1.
TOL_PAGED = dict(rtol=1e-5, atol=1e-5)
# bf16 q/k_new/v_new (the full-width cache dtype). The kernel reads the fp32
# pages and computes in fp32, so against the plain version on the upcast
# operands it differs by one bf16 rounding of the output (one ulp, at most
# 2^-7 relative). Against the plain version on the bf16 operands (the JAX
# oracle's numerics: gathered K/V and the probabilities rounded to bf16
# first) outputs of size O(1) move by a few bf16 ulps: 0.05 absolute.
TOL_PAGED_BF16_UP = dict(rtol=2 ** -7, atol=1e-5)
TOL_PAGED_BF16 = dict(rtol=0.0, atol=0.05)
# Routes agree (fp32 compute): greedy tokens of the paged route (kernel) and
# the gather route (no kernel) are compared per request up to the first step
# where either run's top-2 logit margin is below ROUTE_MARGIN. The routes'
# logits differ by fp32 roundoff carried through 24 layers (~1e-5 on logits
# of size O(1)); the margin sits 100x above that, and the smoke also fails
# if the measured logit difference along the compared steps reaches it.
ROUTE_MARGIN = 1e-3

# The full-width serve cell: h2o-danube-1.8b (24 layers, d_model 2560, 32
# heads over 8 kv heads, head_dim 80), random weights from seed 0.
SERVE_ARCH = "h2o-danube-1.8b"
SERVE = dict(slots=8, prompt_len=128, max_seq=512, page_tokens=8,
             prefill_batch=8, temperature=0.0, seed=0)
SERVE_REQUESTS = 16
SERVE_NEW_TOKENS = (32, 96)         # max_new_tokens drawn in this range
# Routes-agree legs where the kernel's ring and window masks bite at full
# width (fp32, the first 8 requests: one prefill batch): (label,
# ServingConfig changes, model overrides). "wrap": a 160-row ring under
# 128-token prompts and 32-96 new tokens, so most rings wrap, and the
# cursor row then holds position pos - 160, which the kernel drops as the
# gather route's overwrite does; danube's own window (4096) stays
# inactive. "window 96": the window cut below the prompt, so the ring is
# 96 rows, the prefill keeps its last 96 positions and every decode step
# masks by the window.
ROUTE_LEGS = (("wrap", {"max_seq": 160}, {}),
              ("window 96", {}, {"swa_window": 96}))
ROUTE_LEG_REQUESTS = 8


def paged_case(dev, *, heads, t, tokens, layers, s=8, seed=0):
    """A random page pool at an arch's row width (``layers`` K blocks, then
    V blocks, then slot_pos) with its page table and positions: slot 0
    lazily allocated (its later page slots on the null page), slot S-1
    empty (all null, position 0), the others at random positions up to
    three ring lengths (wrapped rings). Returns (pool dict, layout kw)."""
    import numpy as np
    import torch
    h, hkv, hd = heads
    rng = np.random.default_rng(seed)
    kvsz = hkv * hd
    pps = -(-tokens // t)
    n_pages = s * pps
    width = 2 * layers * kvsz + layers
    gen = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.randn((n_pages + 1, t, width), generator=gen, device=dev)
    tables = rng.permutation(n_pages).reshape(s, pps).astype(np.int32)
    tables[0, pps // 2:] = n_pages
    tables[-1] = n_pages
    pos = rng.integers(0, 3 * tokens, s)
    pos[0], pos[-1] = (pps // 2) * t - 1, 0
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    pool = dict(q=rnd(s, h, hd), k_new=rnd(s, hkv, hd), v_new=rnd(s, hkv, hd),
                pages=pages, tables=torch.from_numpy(tables).to(dev),
                pos=torch.from_numpy(pos.astype(np.int32)).to(dev))
    kw = dict(k_off=0, v_off=layers * kvsz, kv_heads=hkv, head_dim=hd,
              tokens=tokens, page_tokens=t)
    return pool, kw


def _paged_args(pool, dtype=None):
    ops = [pool[k] for k in ("q", "k_new", "v_new")]
    if dtype is not None:
        ops = [x.to(dtype) for x in ops]
    return ops + [pool["pages"], pool["tables"], pool["pos"]]


# (name, (H, Hkv, hd), T, tokens, layers, layer, windows). danube is the
# main path's shape (its own window 4096 exceeds the 512-row ring: full
# causal there); deepseek-7b's pool passes 2^31 elements (1,105 pages x 8
# rows x 245,790 floats) and its T does not divide its 1,100-row ring.
PAGED_GRID = (
    ("h2o-danube-1.8b", (32, 8, 80), 8, 512, 24, 23, (4096, 16, 0)),
    ("h2o-danube-1.8b T16", (32, 8, 80), 16, 512, 24, 5, (4096, 16)),
    ("deepseek-7b", (32, 32, 128), 8, 1100, 30, 29, (0, 16)),
    ("qwen3-14b", (40, 8, 128), 16, 512, 40, 1, (16, 4096, 0)),
)


def paged_kernel_checks(dev) -> dict:
    """paged_attention vs its plain version over PAGED_GRID, fp32 and bf16
    operands, and two calls bitwise. Returns the max abs errors at the main
    path's shape (danube, T = 8, fp32 and bf16)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    errs = {}
    for i, (name, heads, t, tokens, layers, layer, windows) in enumerate(
            PAGED_GRID):
        pool, kw = paged_case(dev, heads=heads, t=t, tokens=tokens,
                              layers=layers, seed=10 + i)
        for window in windows:
            args = _paged_args(pool)
            got = paged_attention(*args, layer, window=window, **kw)
            want = ref.paged_attention(*args, layer, window=window, **kw)
            e32 = check_close(f"paged_attention {name} w={window}", got,
                              want, **TOL_PAGED)
            again = paged_attention(*args, layer, window=window, **kw)
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {name}: two calls on "
                                     "the same inputs differ")
            b16 = _paged_args(pool, torch.bfloat16)
            got16 = paged_attention(*b16, layer, window=window, **kw)
            up = [x.float() for x in b16[:3]] + b16[3:]
            e_up = check_close(
                f"paged_attention {name} w={window} bf16 vs upcast",
                got16.float(), ref.paged_attention(*up, layer, window=window,
                                                   **kw), **TOL_PAGED_BF16_UP)
            e16 = check_close(
                f"paged_attention {name} w={window} bf16",
                got16.float(), ref.paged_attention(
                    *b16, layer, window=window, **kw).float(),
                **TOL_PAGED_BF16)
            print(f"paged_attention {name} T={t} tokens={tokens} "
                  f"layer={layer} window={window}: fp32 max_abs_err={e32!r} "
                  f"(tol {TOL_PAGED}); bf16 vs upcast plain {e_up!r} (tol "
                  f"{TOL_PAGED_BF16_UP}), vs bf16 plain {e16!r} (tol "
                  f"{TOL_PAGED_BF16}); bitwise replay ok")
            if i == 0:
                errs["fp32"] = max(errs.get("fp32", 0.0), e32)
                errs["bf16"] = max(errs.get("bf16", 0.0), e16)
        del pool
    torch.cuda.synchronize(dev)
    return errs


def paged_timing_case(dev):
    """The serve cell's paged_attention inputs that paged_timings
    describes: the pool, the wrapper's keywords, its positional arguments
    and one argument set per layer."""
    import torch
    pool, kw = paged_case(dev, heads=(32, 8, 80), t=8, tokens=512,
                          layers=24, seed=3)
    s = pool["tables"].shape[0]
    held = 28
    tables = pool["tables"].clone()
    tables[:, held:] = pool["pages"].shape[0] - 1
    pool["tables"] = tables.contiguous()
    pool["pos"] = torch.full((s,), 176, dtype=torch.int32, device=dev)
    return pool, kw, _paged_args(pool), [(layer,) for layer in range(24)]


@contextlib.contextmanager
def forced_split(n: int):
    """Within the block the paged_attention wrapper splits each (slot, kv
    head) into ``n`` chunks instead of its chooser's count (any count
    computes the same function)."""
    from repro_torch.kernels import paged_attention as tpa
    chooser = tpa.choose_split
    tpa.choose_split = lambda *shape: n
    try:
        yield
    finally:
        tpa.choose_split = chooser


def paged_timings(dev) -> dict:
    """paged_attention at the serve cell's shapes (danube, 8 slots, 8-row
    pages, 512-row rings), slots 0-6 mid-run at position 176 with the 28
    pages a request holds (lazy allocation: prompt 128 + up to 96 new
    tokens) and the rest null, slot 7 empty; fp32 operands. Sets cycle
    through the 24 layers' column blocks (6.3 MB of K/V read a call, 151 MB
    a cycle, past the 50 MB L2). Library call: F.scaled_dot_product_attention over the
    already-gathered contiguous ring with the boolean mask (gather
    excluded), a cross-check only. The bound counts the bytes of the rows
    the call attends over, not of every row its held pages hold."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    pool, kw, args, sets = paged_timing_case(dev)
    s, pps = pool["tables"].shape

    # SDPA inputs per layer: the gathered ring with the new token written
    # at the cursor, and the validity mask, exactly as the plain version
    # builds them.
    h, hkv, hd = 32, 8, 80
    kvsz = hkv * hd
    c = kw["tokens"]
    tl = pool["tables"].long()
    cur = pool["pos"].long() % c
    rows = torch.arange(c, device=dev)
    p = pool["pos"].long()[:, None]
    spos = p - 1 - ((p - 1 - rows[None]) % c)
    valid = (tl[:, rows // kw["page_tokens"]] != pool["pages"].shape[0] - 1)
    valid = (valid & (spos >= 0)) | (rows[None] == cur[:, None])
    sidx = torch.arange(s, device=dev)
    qs = pool["q"][:, :, None]                         # [S, H, 1, hd]
    rings = []
    for layer in range(24):
        ring = []
        for off, new in ((kw["k_off"], pool["k_new"]),
                         (kw["v_off"], pool["v_new"])):
            col = off + layer * kvsz
            g = pool["pages"][:, :, col:col + kvsz][tl].reshape(
                s, -1, hkv, hd)[:, :c].clone()
            g[sidx, cur] = new
            ring.append(g.transpose(1, 2).contiguous())  # [S, Hkv, C, hd]
        rings.append(tuple(ring))
    mask = valid[:, None, None, :]
    lib_sets = [(qs,) + rings[layer] for layer in range(24)]

    out = {"paged_attention": {
        "ms": time_ms(lambda layer: paged_attention(*args, layer, **kw),
                      sets),
        "plain_ms": time_ms(lambda layer: ref.paged_attention(*args, layer,
                                                              **kw), sets),
        "library_ms": time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), lib_sets),
        "bf16_wrapper_ms": time_ms(
            lambda layer: paged_attention(*_paged_args(pool, torch.bfloat16),
                                          layer, **kw), sets)}}
    # Bytes the function must move: the K and V blocks of the rows it
    # attends over in the pool (written rows of held pages; the cursor
    # row's K/V comes from k_new), the table entries of the page slots
    # those positions fall in (an entry is read to learn whether its page
    # is held), q, k_new, v_new and out (fp32), and pos.
    non_null = int((tl != pool["pages"].shape[0] - 1).sum())
    in_ring = (spos >= 0) & (rows[None] != cur[:, None])
    pool_rows = int((valid & in_ring).sum())
    entries = int(in_ring.reshape(s, pps, kw["page_tokens"]).any(-1).sum())
    n_bytes = (pool_rows * 2 * kvsz * 4
               + (2 * s * h * hd + 2 * s * kvsz) * 4 + entries * 4 + s * 4)
    # Operations: scores and the weighted sum, 4 flops per K/V element of
    # each attended row (pool rows and the new token) and query head.
    valid_rows = int(valid.sum())
    n_flops = 4 * valid_rows * h * hd
    out["paged_attention"]["bound"] = bound_ms(n_bytes, n_flops)
    print(f"paged_attention timing inputs: S={s}, {non_null} non-null pages "
          f"of {s * pps}, {pool_rows} pool rows and {s} new tokens attended, "
          f"{entries} table entries read, {n_bytes} bytes a call")
    rows_ = summarize(out, n_bytes)
    row = rows_["paged_attention"]
    print(f"timing paged_attention: bf16 operands through the wrapper "
          f"(casts included) {row['bf16_wrapper_ms']!r} ms")
    # the SDPA cross-check computes the same function
    lay = 7
    got = paged_attention(*args, lay, **kw)
    sd = F.scaled_dot_product_attention(qs, *rings[lay], attn_mask=mask,
                                        enable_gqa=True)[:, :, 0]
    err = check_close("SDPA cross-check", got, sd, **TOL_PAGED)
    print(f"SDPA cross-check vs kernel: max_abs_err={err!r}")
    del pool, rings, lib_sets
    return rows_


def paged_split_sweep(dev) -> None:
    """paged_attention's device time on paged_timings' inputs at other
    split counts than its chooser's, printed beside the chooser's."""
    from repro_torch.kernels import paged_attention as tpa
    pool, kw, args, sets = paged_timing_case(dev)
    s, h = pool["q"].shape[:2]
    chosen = tpa.choose_split(s, h, kw["kv_heads"], kw["tokens"])
    sweep = {}
    for n in sorted({1, 2, 3, 4, 6, 8, chosen}):
        with forced_split(n):
            sweep[n] = time_ms(lambda layer: tpa.paged_attention(
                *args, layer, **kw), sets)[0]
    print(f"timing paged_attention n_split (chooser: {chosen}) -> device "
          f"ms: {sweep}")


def serve_requests(vocab: int, n: int = SERVE_REQUESTS):
    """``n`` synthetic requests (seed 1), all arriving at 0.0, with
    max_new_tokens drawn in SERVE_NEW_TOKENS (numpy, seed 1)."""
    import numpy as np
    from repro_torch.serving import synthetic_requests
    reqs = synthetic_requests(n, SERVE["prompt_len"], 1, vocab,
                              arrivals=[0.0] * n, seed=1)
    lo, hi = SERVE_NEW_TOKENS
    gens = np.random.default_rng(1).integers(lo, hi + 1, n)
    for r, g in zip(reqs, gens):
        r.max_new_tokens = int(g)
    return reqs


def profile_decode(server, k: int = 5) -> dict:
    """Device busy share of ``k`` decode steps of a full batch under
    torch.profiler (the slots admitted and prefilled first, outside the
    window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import AdmissionQueue

    server._admit(AdmissionQueue(serve_requests(server.api.vocab_real,
                                                server.cfg.slots)), 0.0)
    inputs = server.step_inputs()
    server.splan(*inputs)                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(k):
            server.splan(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / k
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / k
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    for i in server.batcher.active():
        server._finish(i, [], 0.0, "done")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / k,
                     e.count / k) for e in top]}


def serve_run(dev, params, *, paged: str, overrides=None, record=False,
              serve_kw=None, n=SERVE_REQUESTS):
    """One full serve of serve_requests(n) on a fresh Server (after a short
    warm-up serve on another), with SERVE changed by ``serve_kw``. Returns
    the server, the report, the launch counters of the measured run and,
    with ``record``, per request the (top-2 margin, logits) of each decode
    step."""
    import torch
    from repro_torch.engine import plan as planlib
    from repro_torch.serving import Server, ServingConfig

    cfg = ServingConfig(arch=SERVE_ARCH, reduced=False, paged=paged,
                        overrides=overrides, **{**SERVE, **(serve_kw or {})})
    warm = Server(cfg, params=params, device=dev)
    vocab = warm.api.vocab_real
    warm_reqs = serve_requests(vocab, 2)
    for r in warm_reqs:
        r.max_new_tokens = 3
    warm.run(warm_reqs)
    del warm
    server = Server(cfg, params=params, device=dev)
    steps = {}
    pick = planlib._pick
    if record:
        def recording_pick(logits, tokens, mask, gen, temp):
            top2 = torch.topk(logits, 2, dim=-1).values.cpu()
            lg = logits.cpu()
            for i, st in enumerate(server.batcher.slots):
                if st is not None:
                    steps.setdefault(st.request.rid, []).append(
                        (float(top2[i, 0] - top2[i, 1]), lg[i]))
            return pick(logits, tokens, mask, gen, temp)
        planlib._pick = recording_pick
    try:
        torch.cuda.synchronize()
        reset_counters()
        report = server.run(serve_requests(vocab, n))
        launches = counters()
    finally:
        planlib._pick = pick
    return server, report, launches, steps


def compare_routes(label, paged_rep, paged_steps, gather_rep, gather_steps,
                   ring: int) -> dict:
    """Greedy tokens per request, paged route vs gather route, up to the
    first step where either run's top-2 margin is below ROUTE_MARGIN.
    Decode step j of a request runs at position prompt_len + j; those at a
    position >= ``ring`` (the ring's rows) read a wrapped ring."""
    ptoks = {r.rid: r.tokens for r in paged_rep.completed}
    gtoks = {r.rid: r.tokens for r in gather_rep.completed}
    compared, wrapped, stops, max_diff = 0, 0, {}, 0.0
    for rid in sorted(ptoks):
        pt, gt = ptoks[rid], gtoks[rid]
        if pt[0] != gt[0]:
            raise AssertionError(f"rid {rid}: prefill tokens differ")
        compared += 1
        for j, ((pm, plg), (gm, glg)) in enumerate(
                zip(paged_steps[rid], gather_steps[rid])):
            if min(pm, gm) < ROUTE_MARGIN:
                stops[rid] = (j + 1, min(pm, gm))
                break
            max_diff = max(max_diff, float((plg - glg).abs().max()))
            if pt[j + 1] != gt[j + 1]:
                raise AssertionError(
                    f"rid {rid} token {j + 1}: paged {pt[j + 1]} vs gather "
                    f"{gt[j + 1]} at top-2 margin {min(pm, gm)!r} >= "
                    f"{ROUTE_MARGIN}")
            compared += 1
            wrapped += SERVE["prompt_len"] + j >= ring
    if max_diff >= ROUTE_MARGIN:
        raise AssertionError(f"{label}: route logits differ by {max_diff!r}, "
                             f"not below the margin {ROUTE_MARGIN}")
    total = sum(len(t) for t in ptoks.values())
    print(f"routes agree ({label}): {compared} of {total} tokens compared, "
          f"{wrapped} of them from a wrapped {ring}-row ring, max logit "
          f"difference {max_diff!r} (margin {ROUTE_MARGIN}); comparison "
          f"stopped at a low margin for {len(stops)} requests: "
          f"{ {rid: (tok, round(m, 6)) for rid, (tok, m) in stops.items()} }")
    return {"compared": compared, "wrapped": wrapped, "total": total,
            "max_logit_diff": max_diff, "stops": stops}


def serve_path(dev) -> dict:
    """The full-width danube serve on the paged route (bf16 compute, fp32
    params), its profile, the fp32 routes-agree legs (the serve cell, then
    ROUTE_LEGS) and the bf16 gather route's timing."""
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm

    api = cfglib.get(SERVE_ARCH).api(reduced=False)
    cfg = api.cfg
    t0 = time.perf_counter()
    params, _ = api.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tm.tree_leaves(params))
    print(f"serve: {SERVE_ARCH} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} H {cfg.num_heads}/{cfg.num_kv_heads} hd "
          f"{cfg.head_dim}, {n_params} params fp32 (init "
          f"{time.perf_counter() - t0:.1f} s)")
    gens = [r.max_new_tokens for r in serve_requests(cfg.vocab_real)]
    out = {}

    def run(label, paged, overrides=None, record=False, serve_kw=None,
            n=SERVE_REQUESTS):
        server, rep, launches, steps = serve_run(
            dev, params, paged=paged, overrides=overrides, record=record,
            serve_kw=serve_kw, n=n)
        s = rep.summary()
        got = {r.rid: len(r.tokens) for r in rep.completed}
        if len(rep.completed) != n or [got[i] for i in range(n)] != gens[:n]:
            raise AssertionError(f"{label}: requests or token counts wrong: "
                                 f"{got} vs {gens[:n]}")
        if not all(all(0 <= t < cfg.vocab_real for t in r.tokens)
                   for r in rep.completed):
            raise AssertionError(f"{label}: token outside the vocab")
        want = cfg.num_layers * rep.decode_steps if paged == "on" else 0
        others = {k: n for k, n in launches.items()
                  if k != "paged_attention" and n}
        if launches["paged_attention"] != want or others:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"paged_attention={want} and no other")
        row = {"tokens_per_s": rep.tokens_per_s,
               "ms_per_decode_step": 1e3 * rep.phase_s["decode"]
               / rep.decode_steps,
               "ttft_p50_s": s["ttft_p50_s"], "decode_steps": rep.decode_steps,
               "joins": rep.joins, "evicts": rep.evicts,
               "prefill_calls": rep.prefill_calls,
               "phase_s": rep.phase_s, "wall_s": rep.wall_s,
               "tokens": rep.tokens_total,
               "launches": launches["paged_attention"],
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        print(f"serve {label}: {json.dumps(row)}")
        out[label] = row
        return server, rep, steps

    torch.cuda.reset_peak_memory_stats(dev)
    server, _, _ = run("paged bf16", "on")
    prof = profile_decode(server)
    print(f"serve paged bf16 profile (5 decode steps, 8 slots): "
          f"{json.dumps(prof)}")
    out["profile"] = prof
    del server
    f32 = {"dtype": torch.float32}
    server, prep, psteps = run("paged fp32", "on", f32, record=True)
    _, grep, gsteps = run("gather fp32", "off", f32, record=True)
    out["routes"] = compare_routes("fp32", prep, psteps, grep, gsteps,
                                   server.layout.tokens)
    del server, psteps, gsteps
    for leg, serve_kw, over in ROUTE_LEGS:
        legs = [run(f"{route} fp32 {leg}", mode, {**f32, **over}, record=True,
                    serve_kw=serve_kw, n=ROUTE_LEG_REQUESTS)
                for route, mode in (("paged", "on"), ("gather", "off"))]
        (server, prep, psteps), (_, grep, gsteps) = legs
        got = compare_routes(f"fp32 {leg}", prep, psteps, grep, gsteps,
                             server.layout.tokens)
        if not got["wrapped"]:
            raise AssertionError(f"routes {leg}: no compared token came from "
                                 "a wrapped ring")
        out[f"routes {leg}"] = got
        del legs, server, psteps, gsteps
    run("gather bf16", "off")
    del params
    torch.cuda.empty_cache()
    return out


def paged_entry(timings: dict, serve: dict, errs: dict) -> dict:
    t = timings["paged_attention"]
    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:163",
        "launches": serve["paged bf16"]["launches"],
        "launches_by_run": {k: v["launches"] for k, v in serve.items()
                            if "launches" in v},
        "max_abs_err": errs["fp32"], "max_abs_err_bf16": errs["bf16"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"], "bf16_wrapper_ms": t["bf16_wrapper_ms"]}


# -- phase 9: the train path -------------------------------------------------

# flash_attention, fp32 operands: the kernel's online softmax (a running max
# and rescale per 32-key tile) and the plain version's one-shot softmax
# round differently; outputs are convex combinations of O(1) values.
TOL_FLASH = dict(rtol=1e-5, atol=1e-5)
# bf16 operands: kernel and plain version compute in fp32 from the same
# bf16 values and round the output to bf16 once, so they differ by at most
# one bf16 rounding (one ulp, 2^-7 relative at most).
TOL_FLASH_BF16 = dict(rtol=2 ** -7, atol=1e-5)
# Against the model's own attention (``_attend``) at the model's bf16
# compute: the model rounds the probabilities to bf16 before the weighted
# sum (a relative error <= 2^-9 on each term) and rounds the output to
# bf16, so |kernel - model| <= 2^-8 * max|v| + one output ulp (2^-8 of
# max|out|). The limit is 2^-7 * (max|v| + max|out|).
FLASH_MODEL_REL = 2 ** -7
# (arch, (H, Hkv, hd)): the danube leg's heads, deepseek-7b's MHA and
# qwen3-14b's 40-over-8 GQA.
FLASH_HEADS = (("h2o-danube-1.8b", (32, 8, 80)),
               ("deepseek-7b", (32, 32, 128)),
               ("qwen3-14b", (40, 8, 128)))
# (label, B, Sq, Sk, causal, window): full causal, a window that bites
# (danube's 4096 over 5120 keys), right-aligned queries over a key count
# that is not a multiple of the 32-key tile, and no mask at all.
FLASH_CASES = (("2048 causal", 1, 2048, 2048, True, 0),
               ("5120 window 4096", 1, 5120, 5120, True, 4096),
               ("Sq 1 of Sk 2085", 2, 1, 2085, True, 0),
               ("Sq 17 of Sk 2085", 2, 17, 2085, True, 0),
               ("Sq 128 of Sk 2085", 2, 128, 2085, True, 0),
               ("2048 bidirectional", 1, 2048, 2048, False, 0))

# The train phase. The full-config leg: h2o-danube-1.8b at full width and
# depth (24 layers, ~1.83 B params, fp32 params, bf16 compute, remat on)
# through the train CLI in sync mode with the fused-Adam opt-in. Memory
# (fp32, 7.32 GB a copy of the params): params, Adam m and v (22.0 GB);
# during the update the packed gradient, the zero p, the kernel's p', m',
# v' and the new params (six more copies, 43.9 GB): ~66 GB at the peak,
# under 80 GB. The backward pass holds params, moments, gradients (29.3
# GB) and, with remat, each layer's input (8 x 1024 x 2560 bf16, 42 MB x
# 24) plus one layer's recomputed activations and the logits (8 x 1024 x
# 32000: ~1 GB in fp32 per copy, a few copies): ~40 GB. So batch 8 at
# seq 1024 fits; batch 16 would double the activations only. Measured on
# the H100: a peak of 66.0 GB (PERF.md, PR 15).
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_FULL = dict(batch=8, seq=1024, steps=4, timed=3, profile=2)
# Ring legs: the same width with the depth cut to 4 of 24 layers (~0.44 B
# params, 1.77 GB a copy), P = 2 workers, s = 3: a [3, 2, D] ring of
# 10.6 GB, [2, D] per-worker gradients, packed copies and (compressed)
# residuals and EF operands, under ~50 GB for any leg.
TRAIN_RING = dict(layers=4, workers=2, stale=3, batch=4, seq=256, steps=4,
                  timed=3, profile=2)
# Their packed width (441,735,680 params padded to PACK_ALIGN; train_path
# checks it against the legs' own count) and the coherence leg's probe
# window (the CLI's max(stale, 4)): coherence_dots's LM shape.
LM_WIDTH = 441_737_216
LM_WINDOW = max(TRAIN_RING["stale"], 4)
# (name, CLI flags, launches per step with kernels on, with kernels off).
TRAIN_LEGS = (
    ("stale-psum adam", dict(mode="stale-psum"), dict(fused_update_plain=1),
     {}),
    ("ssp adam", dict(mode="ssp"), dict(fused_update_plain=1), {}),
    ("simulate adam", dict(mode="simulate"),
     dict(stale_accum=1, fused_adam=1), {}),
    ("stale-psum adam topk", dict(mode="stale-psum", compress="topk:0.1"),
     dict(fused_update_ef=1), dict(sparsify_topk=1)),
    ("stale-psum sgd topk+inverse",
     dict(mode="stale-psum", optimizer="sgd", compress="topk:0.1",
          lr_scale="inverse"),
     dict(sparsify_topk=1, stale_accum=1), dict(sparsify_topk=1)),
    ("stale-psum adam coherence", dict(mode="stale-psum", coherence=True),
     dict(fused_update_plain=1, coherence_dots=1), {}),
)
# The MoE leg: qwen2-moe-a2.7b at full width (d_model 2048, 64 experts of
# which 60 are real, top-4, the 5632-wide shared expert, vocab 151,936)
# with 1 of 24 layers (~1.23 B params, 4.9 GB a copy), stale-psum over the
# aggregate ring (one [D] row a slot, s = 2) through make_train_engine.
MOE_ARCH = "qwen2-moe-a2.7b"
TRAIN_MOE = dict(layers=1, workers=2, stale=2, batch=4, seq=256, steps=4)
# Kernels on vs off on the LM legs, over their few steps: the two layouts
# round Adam's update differently, the gradients then part at roundoff
# (bf16 compute, and the embedding's backward accumulates in no fixed
# order), and Adam turns that into up to 2 * lr on elements whose gradient
# lies within that roundoff of zero. How far that takes a leg is measured
# in the same run: its sound witness is the kernels-off leg run again from
# the initial params nudged up by one ulp, held against the kernels-off
# leg. On vs off may part at most WITNESS_FACTOR times as far as the
# witness, in the per-step loss (``loss``) and in the relative L2 distance
# of the two runs' updates (``rel``: params minus the shared init), and
# never less than LM_FLOOR (for legs whose runs agree to the bit). On the
# H100 the witness parts 5-18% in ``rel`` over 4 steps, and on vs off
# reaches at most 0.39 of the witness on any leg and either metric
# (PERF.md), so a factor of 2 leaves 5x room. The limit never exceeds
# LM_CEILING, however far a witness parts. On the H100 on vs off reached
# at most 6e-4 in loss and 0.034 in rel (the MoE leg, whose routing makes
# its witness the most chaotic: 0.177 in rel), 4x and 6x below it. The
# kernels themselves are held at these widths elementwise, at the phase
# 3, 5 and 6 tolerances (``lm_kernels``, ``full_adam_check``); this limit
# checks the legs' wiring end to end.
WITNESS_FACTOR = 2.0
LM_FLOOR = dict(loss=1e-5, rel=1e-5)
LM_CEILING = dict(loss=2.5e-3, rel=0.2)
# The MoE leg's aux loss (~0.012) under the same scheme: the witness parts
# it by 3.5e-5, on vs off by 3e-6 (PERF.md).
AUX_CEILING = 5e-4


def attended_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Query-key pairs a (batch, head) attends over under the masks."""
    if not causal and not window:
        return sq * sk
    pos = [i + sk - sq for i in range(sq)]
    lo = [max(0, p - window + 1) if window else 0 for p in pos]
    return sum(p + 1 - a for p, a in zip(pos, lo))


def flash_inputs(dev, b, sq, sk, heads, dtype, seed):
    import torch
    h, hkv, hd = heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen,
                                     device=dev).to(dtype)
    return rnd(b, sq, h, hd), rnd(b, sk, hkv, hd), rnd(b, sk, hkv, hd)


def flash_kernel_checks(dev) -> dict:
    """flash_attention vs its plain version over FLASH_HEADS x FLASH_CASES,
    fp32 and bf16 operands, two calls bitwise. Returns the max abs errors
    at the danube heads."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    errs = {"fp32": 0.0, "bf16": 0.0}
    for i, (arch, heads) in enumerate(FLASH_HEADS):
        for j, (label, b, sq, sk, causal, window) in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(dev, b, sq, sk, heads, torch.float32,
                                   seed=100 * i + j)
            got = flash_attention(q, k, v, causal=causal, window=window)
            e32 = check_close(f"flash_attention {arch} {label}", got,
                              ref.flash_attention(q, k, v, causal=causal,
                                                  window=window), **TOL_FLASH)
            if not torch.equal(got, flash_attention(q, k, v, causal=causal,
                                                    window=window)):
                raise AssertionError(f"flash_attention {arch} {label}: two "
                                     "calls on the same inputs differ")
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
            got = flash_attention(q, k, v, causal=causal, window=window)
            e16 = check_close(f"flash_attention {arch} {label} bf16",
                              got.float(), ref.flash_attention(
                                  q, k, v, causal=causal,
                                  window=window).float(), **TOL_FLASH_BF16)
            print(f"flash_attention {arch} {heads} {label} (B={b} Sq={sq} "
                  f"Sk={sk}): fp32 max_abs_err={e32!r} (tol {TOL_FLASH}); "
                  f"bf16 {e16!r} (tol {TOL_FLASH_BF16}); bitwise replay ok")
            if i == 0:
                errs["fp32"] = max(errs["fp32"], e32)
                errs["bf16"] = max(errs["bf16"], e16)
            del q, k, v, got
    torch.cuda.synchronize(dev)
    return errs


def flash_timings(dev) -> dict:
    """flash_attention at the danube leg's attention shape (B = 8, 1024
    tokens, 32 heads over 8, hd 80, bf16, causal; danube's window 4096
    exceeds the sequence) and at B = 1, 2048 tokens in fp32: kernel, plain
    version and F.scaled_dot_product_attention with the same mask (a
    cross-check only; the port never calls it). Bound: max(4 * B * H * hd
    * attended pairs / peak for the operand type, (q + k + v + out) bytes
    / 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    rows = {}
    for label, b, s, dtype, peak in (
            ("bf16 B8 S1024", TRAIN_FULL["batch"], TRAIN_FULL["seq"],
             torch.bfloat16, PEAK_BF16_FLOPS),
            ("fp32 B1 S2048", 1, 2048, torch.float32, PEAK_FP32_FLOPS)):
        h, hkv, hd = FLASH_HEADS[0][1]
        sets = [flash_inputs(dev, b, s, s, (h, hkv, hd), dtype, seed=7 + i)
                for i in range(2)]
        lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in qkv)
                    for qkv in sets]
        out = {"ms": time_ms(lambda q, k, v: flash_attention(
                   q, k, v, causal=True, window=4096), sets, reps=20),
               "plain_ms": time_ms(lambda q, k, v: ref.flash_attention(
                   q, k, v, causal=True, window=4096), sets, reps=20),
               "library_ms": time_ms(
                   lambda q, k, v: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True), lib_sets,
                   reps=20)}
        pairs = attended_pairs(s, s, True, 4096)
        n_flops = 4 * b * h * hd * pairs
        n_bytes = (2 * b * s * h * hd + 2 * b * s * hkv * hd) * sets[0][0].element_size()
        out["bound"] = bound_ms(n_bytes, n_flops, peak)
        print(f"flash_attention timing inputs {label}: {pairs} pairs a "
              f"(batch, head), {n_flops} flops, {n_bytes} bytes")
        row = summarize({f"flash_attention {label}": out}, b * s)
        # SDPA rounds its probabilities to the operand type before the
        # weighted sum, as the model's attention does: the same limit.
        q, k, v = sets[0]
        sd = F.scaled_dot_product_attention(*lib_sets[0], is_causal=True,
                                            enable_gqa=True).transpose(1, 2)
        got = flash_attention(q, k, v, causal=True, window=4096).float()
        err = max_abs(got, sd.float())
        lim = (FLASH_MODEL_REL * (float(v.float().abs().max())
                                  + float(sd.float().abs().max()))
               if dtype == torch.bfloat16 else TOL_FLASH["atol"]
               + TOL_FLASH["rtol"] * float(sd.abs().max()))
        print(f"SDPA cross-check {label} vs kernel: max_abs_err={err!r} "
              f"(limit {lim!r})")
        if err > lim:
            raise AssertionError(f"SDPA cross-check {label}: {err!r} > "
                                 f"{lim!r}")
        rows.update(row)
        del sets, lib_sets
    return rows


def cut_arch(arch_id: str, layers: int) -> str:
    """Register ``arch_id`` with its depth cut to ``layers`` (every width
    kept) under a new id, so the train CLI can run it; returns the id."""
    import dataclasses
    from repro_torch import configs as cfglib
    base = cfglib.get(arch_id)
    cut_id = f"{arch_id}-{layers}l"

    def make_config(reduced=False, long_ctx=False):
        return dataclasses.replace(
            base.make_config(reduced=reduced, long_ctx=long_ctx),
            num_layers=layers)

    cfglib.REGISTRY[cut_id] = dataclasses.replace(
        base, arch_id=cut_id, make_config=make_config,
        notes=f"{arch_id} with {layers} layers (depth cut)")
    return cut_id


def cli_argv(arch: str, **flags) -> list:
    argv = ["--arch", arch]
    for key, value in flags.items():
        flag = "--" + key.replace("_", "-")
        argv += [flag] if value is True else [flag, str(value)]
    return argv


def to_host(tree):
    from repro_torch import treemath as tm
    return tm.tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def train_cli(dev, argv: list, *, batch: int, seq: int, workers: int = 0,
              timed: int = 0, profile: int = 0) -> dict:
    """One run of the train CLI (``repro_torch.launch.train.main``) with
    every launch counter zeroed just before and read just after; the
    final params come back on the host. Then ``timed`` more steps on the
    host clock between syncs and ``profile`` steps under the profiler."""
    import gc
    import torch
    from repro_torch.launch import train

    if dev.type == "cpu":             # a rehearsal at reduced size
        argv = argv + ["--cpu"]
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    reset_counters()
    t0 = time.perf_counter()
    ret = train.main(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = counters()
    # Only the local name keeps the final state (at full width a second
    # reference would hold a second copy of params and moments).
    engine, result = ret.pop("engine"), ret.pop("result")
    state, result.state = result.state, None
    out = {"launches": launches, "wall_s": wall,
           "losses": [row["loss"] for row in result.history],
           "history": result.history,
           "params": to_host(engine.params(state)),
           "meta": engine.meta["kernels"], "start_mem_gb": start_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if timed or profile:
        batches = train_batches(argv, batch, seq, workers)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = engine.step(state, next(batches))
        torch.cuda.synchronize(dev)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / max(timed, 1)
        # Hand the state over without keeping a reference here.
        box = [state]
        del state
        out["profile"] = (profile_steps(engine, box.pop(), batches, profile)
                          if profile else None)
    else:
        del state
    del ret, result, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_batches(argv: list, batch: int, seq: int, workers: int):
    """An endless iterator of fresh CLI-style batches (seed 7) for the
    arch named in ``argv``."""
    from repro_torch import configs as cfglib
    from repro_torch.launch import train
    api = cfglib.get(argv[argv.index("--arch") + 1]).api()
    next_batch = train.make_batch_fn(api, batch, seq, 7, workers=workers)
    while True:
        yield next_batch()


def init_params(dev, arch: str, seed: int = 0):
    """The CLI's initial params of ``arch`` (its engine inits from the
    seed on ``dev``), on the host."""
    import torch
    from repro_torch import configs as cfglib
    params, _ = cfglib.get(arch).api().init(seed, device=dev)
    host = to_host(params)
    del params
    torch.cuda.empty_cache()
    return host


def lm_distance(dev, on: dict, off: dict, p0) -> dict:
    """How far two LM runs part: the max per-step loss difference, and the
    relative L2 distance of their updates (params minus the shared init
    ``p0``), leaf by leaf on the card."""
    import torch
    from repro_torch import treemath as tm
    dloss = max(abs(a - b) for a, b in zip(on["losses"], off["losses"]))
    diff = norm = 0.0
    for a, b, c in zip(tm.tree_leaves(on["params"]),
                       tm.tree_leaves(off["params"]), tm.tree_leaves(p0)):
        a, b, c = (x.to(dev).double() for x in (a, b, c))
        diff += float(((a - b) ** 2).sum())
        norm += float(((b - c) ** 2).sum())
        del a, b, c
    torch.cuda.empty_cache()
    return {"loss": dloss, "rel": (diff ** 0.5) / max(norm ** 0.5, 1e-30)}


def nudged(params):
    """Every param moved up by one ulp: a roundoff-sized perturbation."""
    import torch
    from repro_torch import treemath as tm
    return tm.tree_map(
        lambda x: torch.nextafter(x, torch.full_like(x, float("inf"))),
        params)


def witness_run(dev, argv: list, params) -> dict:
    """The kernels-off CLI run of ``argv`` again from ``params`` in place
    of the seeded init: the EngineConfig, optimizer, batches and (with
    ``--coherence``) probe hook that the CLI builds from ``argv``, through
    make_train_engine and ``Trainer.run(params=...)``. Returns its losses
    and final params (on the host)."""
    import gc
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm
    from repro_torch.configs.base import InputShape
    from repro_torch.core import coherence as coh
    from repro_torch.engine import CoherenceHook, EngineConfig, Trainer
    from repro_torch.engine.plan import make_train_engine
    from repro_torch.launch import train

    args = train.parser().parse_args(argv)
    assert args.kernels == "off" and not (args.delay or args.trace
                                          or args.lr or args.reduced), argv
    mode = args.mode
    if mode == "auto":
        mode = "sync" if args.stale == 0 else "stale-psum"
    ecfg = EngineConfig(mode=mode, num_workers=args.workers, s=args.stale,
                        kernels="off", compress=args.compress,
                        lr_scale=args.lr_scale,
                        ssp_steps=max(args.steps, 1), ssp_seed=args.seed)
    shape = InputShape(f"train_cli_{args.seq}", args.seq, args.batch, "train")
    engine = make_train_engine(args.arch, shape, ecfg=ecfg,
                               optimizer_name=args.optimizer, device=dev)
    api = cfglib.get(args.arch).api()
    hooks = []
    if args.coherence:
        hooks.append(CoherenceHook(
            api.loss, train.make_batch_fn(api, args.batch, args.seq,
                                          args.seed + 1)(),
            dim=sum(x.numel() for x in tm.tree_leaves(params)),
            window=max(args.stale, 4), every=args.log_every,
            controller=(coh.CoherenceController(s_max=args.stale)
                        if args.stale else None)))
    res = Trainer(engine, hooks=hooks).run(
        train.make_batch_fn(api, args.batch, args.seq, args.seed,
                            workers=args.workers if mode == "simulate" else 0),
        args.steps, init_seed=args.seed, params=params,
        log_every=args.log_every)
    out = {"losses": [row["loss"] for row in res.history],
           "params": to_host(engine.params(res.state))}
    del engine, res, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_lm_pair(dev, name, on, off, witness, p0, failures: list) -> dict:
    """Holds ``on`` against ``off`` within WITNESS_FACTOR times how far
    ``witness`` (off from nudged params) parts from ``off``; records a
    failure instead of raising, so one run reports every leg."""
    import math
    dist = lm_distance(dev, on, off, p0)
    wit = lm_distance(dev, witness, off, p0)
    limit = {k: min(max(WITNESS_FACTOR * wit[k], LM_FLOOR[k]), LM_CEILING[k])
             for k in dist}
    print(f"train {name}: on vs off {json.dumps(dist)}; witness (off from "
          f"one ulp up) vs off {json.dumps(wit)}; limit {json.dumps(limit)}; "
          f"losses on {on['losses']} off {off['losses']} witness "
          f"{witness['losses']}")
    for run in (on, off, witness):
        if not all(math.isfinite(x) for x in run["losses"]):
            failures.append(f"{name}: non-finite loss")
    over = [key for key in dist if dist[key] > limit[key]]
    if over:
        failures.append(f"{name}: kernels on and off part further than the "
                        f"witness allows ({over})")
    return {"on_vs_off": dist, "witness": wit, "limit": limit}


def check_counts(name, run, want, failures: list) -> None:
    print(f"train {name}: launches {run['launches']} (expected {want}); "
          f"routing {run['meta']}")
    if run["launches"] != want:
        failures.append(f"{name}: launch counts {run['launches']} != {want}")


def flash_route(dev, params, cfg, tokens, failures: list) -> dict:
    """The full-width danube forward (``transformer.forward``) with each
    layer's attention also sent through ``dispatch.flash_attention`` (the
    route the JAX package gives its flash kernel) on the q/k/v the model's
    own attention (``_attend``, bf16 compute) receives, and the launch
    counters zeroed just before and read just after. The model goes on
    with its own attention's output; each layer's kernel output is then
    held against it, and, with the operands cast up, against ``_attend``
    in fp32."""
    import dataclasses
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tr

    window = cfg.swa_window or 0
    b, s = tokens.shape
    layers = []
    attend = tr._attend

    def recording(q, k, v, mask, cfg_):
        want = attend(q, k, v, mask, cfg_)
        got = dispatch.flash_attention(q, k, v, causal=cfg.causal,
                                       window=window)
        layers.append((q, k, v, mask, got, want))
        return want

    with torch.no_grad():
        reset_counters()
        tr._attend = recording
        try:
            tr.forward(params, tokens, cfg)
        finally:
            tr._attend = attend
        torch.cuda.synchronize(dev)
        launches = counters()
        if len(layers) != cfg.num_layers:
            failures.append(f"flash_attention route: the model attended "
                            f"{len(layers)} times, not {cfg.num_layers}")
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        err16 = err32 = 0.0
        for i, (q, k, v, mask, got, want) in enumerate(layers):
            e16 = max_abs(got.float(), want.float())
            lim = FLASH_MODEL_REL * (float(v.float().abs().max())
                                     + float(want.float().abs().max()))
            if e16 > lim:
                failures.append(f"flash_attention vs the model's attention, "
                                f"layer {i}: {e16!r} > {lim!r}")
            q32, k32, v32 = q.float(), k.float(), v.float()
            got32 = flash_attention(q32, k32, v32, causal=cfg.causal,
                                    window=window)
            want32 = attend(q32, k32, v32, mask, cfg32)
            e32 = max_abs(got32, want32)
            if not torch.allclose(got32, want32, **TOL_FLASH):
                failures.append(f"flash_attention vs _attend fp32, layer "
                                f"{i}: max_abs_err {e32!r}")
            err16, err32 = max(err16, e16), max(err32, e32)
    others = {k: n for k, n in launches.items() if k != "flash_attention" and n}
    if launches["flash_attention"] != cfg.num_layers or others:
        failures.append(f"flash_attention route: launches {launches}")
    print(f"flash_attention route: {cfg.num_layers} layers of the trained "
          f"{TRAIN_ARCH} at B={b}, S={s}: launches {launches}; vs the "
          f"model's attention max_abs_err bf16 {err16!r} (limit "
          f"{FLASH_MODEL_REL} x (max|v| + max|out|)), fp32 {err32!r} "
          f"(tol {TOL_FLASH})")
    return {"launches": launches["flash_attention"],
            "model_err_bf16": err16, "model_err_fp32": err32}


def full_config_leg(dev, failures: list) -> dict:
    """The full-config danube leg through the train CLI, kernels on (the
    main path) then off, and the flash_attention route on the trained
    params."""
    import gc
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm

    f = TRAIN_FULL
    flags = dict(steps=f["steps"], batch=f["batch"], seq=f["seq"], stale=0,
                 workers=1, log_every=1, seed=0)
    p0 = init_params(dev, TRAIN_ARCH)
    n_params = sum(x.numel() for x in tm.tree_leaves(p0))
    on = train_cli(dev, cli_argv(TRAIN_ARCH, kernels="on", **flags),
                   batch=f["batch"], seq=f["seq"], timed=f["timed"],
                   profile=f["profile"])
    check_counts("full danube on", on, expect(f["steps"], fused_adam=1),
                 failures)
    print(f"train full danube: {n_params} params, losses {on['losses']}, "
          f"ms_per_step {on['ms_per_step']!r} (mean of {f['timed']} steps "
          f"after {f['steps']}, host clock between syncs), peak memory "
          f"{on['peak_mem_gb']:.1f} GB ({on['start_mem_gb']:.2f} GB "
          f"allocated before the run), CLI wall {on['wall_s']:.1f} s")
    print(f"profile train full danube: {json.dumps(on['profile'])}")
    cfg = cfglib.get(TRAIN_ARCH).api().cfg
    params = tm.tree_map(lambda x: x.to(dev), on["params"])
    tokens = next(train_batches(cli_argv(TRAIN_ARCH), 2, f["seq"], 0))
    tokens = torch.as_tensor(tokens["tokens"][:, :-1], device=dev)
    route = flash_route(dev, params, cfg, tokens, failures)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    off_argv = cli_argv(TRAIN_ARCH, kernels="off", **flags)
    off = train_cli(dev, off_argv, batch=f["batch"], seq=f["seq"])
    check_counts("full danube off", off, expect(f["steps"]), failures)
    witness = witness_run(dev, off_argv, nudged(p0))
    dist = check_lm_pair(dev, "full danube", on, off, witness, p0, failures)
    out = {"n_params": n_params, "losses_on": on["losses"],
           "losses_off": off["losses"], "distance": dist,
           "ms_per_step": on["ms_per_step"], "profile": on["profile"],
           "peak_mem_gb": on["peak_mem_gb"], "launches": on["launches"],
           "route": route}
    del on, off, witness, p0
    gc.collect()
    return out


def ring_legs(dev, tmp: str, failures: list) -> dict:
    """The cut-depth danube legs through the train CLI, each kernels on
    against kernels off; the coherence leg also checkpoints (the snapshot
    restores bit for bit) and records a trace (which then replays)."""
    import gc
    import torch
    from repro_torch import treemath as tm
    from repro_torch.checkpoint import checkpoint as ckpt

    r = TRAIN_RING
    arch = cut_arch(TRAIN_ARCH, r["layers"])
    p0 = init_params(dev, arch)
    n_params = sum(x.numel() for x in tm.tree_leaves(p0))
    print(f"train ring legs: {arch}, {n_params} params, P={r['workers']}, "
          f"s={r['stale']}, batch {r['batch']} x seq {r['seq']}, "
          f"{r['steps']} steps")
    base = dict(steps=r["steps"], batch=r["batch"], seq=r["seq"],
                stale=r["stale"], workers=r["workers"], log_every=1, seed=0)
    out = {"arch": arch, "n_params": n_params}
    for i, (name, flags, per_on, per_off) in enumerate(TRAIN_LEGS):
        runs = {}
        for kernels in ("on", "off"):
            extra = dict(flags)
            if flags.get("coherence") and kernels == "on":
                extra.update(ckpt_dir=os.path.join(tmp, "ckpt"),
                             ckpt_every=r["steps"],
                             trace_out=os.path.join(tmp, "trace.jsonl"))
            timing = (i == 0 and kernels == "on")
            workers = r["workers"] if flags["mode"] == "simulate" else 0
            runs[kernels] = train_cli(
                dev, cli_argv(arch, kernels=kernels, **base, **extra),
                batch=r["batch"], seq=r["seq"], workers=workers,
                timed=r["timed"] if timing else 0,
                profile=r["profile"] if timing else 0)
        on, off = runs["on"], runs["off"]
        runs["witness"] = witness_run(
            dev, cli_argv(arch, kernels="off", **base, **flags), nudged(p0))
        row = {"distance": check_lm_pair(dev, name, on, off, runs["witness"],
                                         p0, failures),
               "launches": on["launches"], "losses_on": on["losses"],
               "peak_mem_gb": on["peak_mem_gb"], "wall_s": on["wall_s"]}
        check_counts(f"{name} on", on, expect(r["steps"], **per_on),
                     failures)
        check_counts(f"{name} off", off, expect(r["steps"], **per_off),
                     failures)
        if "ms_per_step" in on:
            row["ms_per_step"] = on["ms_per_step"]
            row["profile"] = on["profile"]
            print(f"train {name}: ms_per_step {on['ms_per_step']!r} (mean "
                  f"of {r['timed']} steps after {r['steps']}); profile "
                  f"{json.dumps(on['profile'])}")
        if flags.get("coherence"):
            mu_on = [h.get("mu") for h in on["history"]]
            mu_off = [h.get("mu") for h in off["history"]]
            print(f"train {name}: mu on {mu_on} off {mu_off}")
            if None in mu_on or any(abs(a - b) > 1e-3
                                    for a, b in zip(mu_on, mu_off)):
                failures.append(f"{name}: mu on {mu_on} vs off {mu_off}")
            path = ckpt.step_path(os.path.join(tmp, "ckpt"), r["steps"])
            like = on["params"]
            restored, step, _ = ckpt.restore(path, like)
            same = all(torch.equal(a, b.cpu()) for a, b in zip(
                tm.tree_leaves(on["params"]), tm.tree_leaves(restored)))
            print(f"train {name}: checkpoint of step {step} restores bit "
                  f"for bit: {same}")
            if not same or step != r["steps"]:
                failures.append(f"{name}: checkpoint does not restore")
            del restored
            replay = train_cli(dev, cli_argv(
                arch, kernels="on", mode="stale-psum", steps=2,
                batch=r["batch"], seq=r["seq"], stale=r["stale"],
                workers=r["workers"], log_every=1,
                trace=os.path.join(tmp, "trace.jsonl")),
                batch=r["batch"], seq=r["seq"])
            staleness = [h["mean_staleness"] for h in replay["history"]]
            print(f"train {name}: the recorded trace replays through "
                  f"--trace: losses {replay['losses']}, mean staleness "
                  f"{staleness}")
            row["replay_losses"] = replay["losses"]
            del replay
        out[name] = row
        del runs, on, off
        gc.collect()
        torch.cuda.empty_cache()
    del p0
    return out


def moe_leg(dev, failures: list) -> dict:
    """qwen2-moe-a2.7b at full width, depth cut, stale-psum over the
    aggregate ring through make_train_engine, kernels on against off;
    losses and the final params' MoE aux loss finite and close."""
    import gc
    import math
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm
    from repro_torch.configs.base import InputShape
    from repro_torch.engine import Trainer
    from repro_torch.engine.plan import make_train_engine
    from repro_torch.launch import train
    from repro_torch.models import transformer as tr

    m = TRAIN_MOE
    arch = cut_arch(MOE_ARCH, m["layers"])
    api = cfglib.get(arch).api()
    shape = InputShape("train_moe", m["seq"], m["batch"], "train")
    probe = next(train_batches(cli_argv(arch), m["batch"], m["seq"], 0))
    probe = torch.as_tensor(probe["tokens"][:, :-1], device=dev)
    p0 = init_params(dev, arch)
    runs = {}
    for label, kernels, start in (("on", "on", None), ("off", "off", None),
                                  ("witness", "off", nudged(p0))):
        engine = make_train_engine(
            arch, shape, mode="stale-psum", stale_s=m["stale"],
            num_workers=m["workers"], per_worker_delays=False,
            kernels=kernels, megakernel="auto" if kernels == "on" else "off",
            device=dev)
        reset_counters()
        # The Trainer inits the state itself (seed 0, or the nudged
        # params), so no reference here holds the initial state.
        res = Trainer(engine).run(
            train.make_batch_fn(api, m["batch"], m["seq"], 0), m["steps"],
            init_seed=0, params=start, log_every=1)
        torch.cuda.synchronize(dev)
        launches = counters()
        params = engine.params(res.state)
        with torch.no_grad():
            aux = float(tr.forward(params, probe, api.cfg)[1])
        runs[label] = {"losses": [h["loss"] for h in res.history],
                         "params": to_host(params), "aux": aux,
                         "launches": launches, "meta": engine.meta["kernels"],
                         "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                         / 1e9}
        del engine, res, params, start
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    n_params = sum(x.numel() for x in tm.tree_leaves(p0))
    dist = check_lm_pair(dev, f"moe {arch}", on, off, runs["witness"], p0,
                         failures)
    check_counts("moe on", on, expect(m["steps"], fused_update_plain=1),
                 failures)
    check_counts("moe off", off, expect(m["steps"]), failures)
    wit = runs["witness"]["aux"]
    aux_limit = min(max(WITNESS_FACTOR * abs(wit - off["aux"]),
                        LM_FLOOR["loss"]), AUX_CEILING)
    print(f"train moe {arch}: {n_params} params, aux loss on {on['aux']!r} "
          f"off {off['aux']!r} witness {wit!r} (limit on vs off "
          f"{aux_limit!r})")
    if not (math.isfinite(on["aux"]) and on["aux"] > 0
            and abs(on["aux"] - off["aux"]) <= aux_limit):
        failures.append(f"moe: aux loss on {on['aux']!r} off {off['aux']!r}")
    out = {"arch": arch, "n_params": n_params, "distance": dist,
           "losses_on": on["losses"], "aux_on": on["aux"],
           "aux_off": off["aux"], "launches": on["launches"],
           "peak_mem_gb": on["peak_mem_gb"]}
    del runs, on, off, p0
    gc.collect()
    return out


def lm_kernels(dev, width: int, workers: int) -> dict:
    """Kernels 1-5 at the ring legs' LM width (D_pad = ``width``, P =
    ``workers``), each held against its plain version on the inputs it is
    timed on, at the tolerances of phases 3, 5 and 6, then timed beside it:
    stale_accum over the [P, D] ring rows (the SGD top-k leg's aggregate),
    fused_adam over [P * D] (simulate), fused_update plain and ef over P
    rows, sparsify_topk over [P, D], coherence_dots at W = LM_WINDOW (the
    coherence leg's window; ``lm_coherence``). One set each: every call
    reads GBs, past the 50 MB L2. Returns the timings and the max abs
    errors."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.sparsify import sparsify_topk
    from repro_torch.kernels.stale_accum import stale_accum

    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    d, p = width, workers
    out, errs = {}, {}
    sets = [(rnd(d), rnd(p, d), torch.full((p,), 1.0 / p, device=dev))]
    errs["stale_accum"] = check_close(
        f"stale_accum lm S={p} D={d}", stale_accum(*sets[0]),
        ref.stale_accum(*sets[0]), **TOL_ACCUM)
    print(f"stale_accum lm S={p} D={d}: max_abs_err="
          f"{errs['stale_accum']!r} (tol {TOL_ACCUM})")
    out["stale_accum"] = {
        "ms": time_ms(stale_accum, sets, reps=10),
        "plain_ms": time_ms(ref.stale_accum, sets, reps=10),
        "library_ms": time_ms(lambda x, buf, w: torch.addmv(x, buf.t(), w),
                              sets, reps=10),
        "bound": bound_ms((p * d + 2 * d + p) * 4, 2 * p * d)}
    del sets
    n = p * d
    sets = [(rnd(n), 0.1 * rnd(n),
             0.01 * torch.rand(n, generator=gen, device=dev), rnd(n))]
    got = fused_adam(*sets[0], 1e-3, 0.9, 0.999, 1e-8, 10)
    want = ref.fused_adam(*sets[0], 1e-3, 0.9, 0.999, 1e-8, 10)
    errs["fused_adam"] = max(check_close(f"fused_adam lm D={n} {k}", a, b,
                                         **TOL_ADAM)
                             for k, a, b in zip("pmv", got, want))
    print(f"fused_adam lm D={n}: max_abs_err={errs['fused_adam']!r} "
          f"(tol {TOL_ADAM})")
    del got, want
    steps = torch.full((1,), 10.0, device=dev)
    out["fused_adam"] = {
        "ms": time_ms(lambda a, b, c, g: fused_adam(
            a, b, c, g, 1e-3, 0.9, 0.999, 1e-8, 10), sets, reps=10),
        "plain_ms": time_ms(lambda a, b, c, g: ref.fused_adam(
            a, b, c, g, 1e-3, 0.9, 0.999, 1e-8, 10), sets, reps=10),
        "library_ms": time_ms(lambda a, b, c, g: torch._fused_adam_(
            [a], [g], [b], [c], [], [steps], lr=1e-3, beta1=0.9,
            beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
            maximize=False), sets, reps=10),
        "bound": bound_ms(7 * n * 4, 16 * n)}
    del sets
    torch.cuda.empty_cache()
    for label, variant in (("plain", "plain"), ("ef", "ef")):
        ops = update_operands(dev, p, d, seed=300)
        errs[f"fused_update.{label}"] = check_update(
            f"fused_update {variant} lm R={p} D={d}", ops, variant)

        def kernel(ops, variant=variant):
            from repro_torch.kernels.fused_update import fused_update
            args, kw = variant_args(ops, variant, True)
            return fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 10,
                                ops["scale"], **kw)

        def plain(ops, variant=variant):
            args, kw = variant_args(ops, variant, True)
            return ref.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 10,
                                    ops["scale"], **kw)

        out[f"fused_update.{label}"] = {
            "ms": time_ms(kernel, [(ops,)], reps=10),
            "plain_ms": time_ms(plain, [(ops,)], reps=10),
            "library_ms": (None, None),
            "bound": update_bound(ops, variant, True)}
        if label == "ef":
            check_sparsify(f"sparsify_topk lm R={p} D={d}", ops)
            errs["sparsify_topk"] = 0.0
            out["sparsify_topk"] = {
                "ms": time_ms(lambda o: sparsify_topk(o["acc"], o["thr"]),
                              [(ops,)], reps=10),
                "plain_ms": time_ms(lambda o: ref.sparsify_mask(
                    o["acc"], o["thr"]), [(ops,)], reps=10),
                "library_ms": (None, None),
                "bound": bound_ms(3 * p * d * 4 + p * 4, 3 * p * d)}
        del ops
        torch.cuda.empty_cache()
    out["coherence_dots"], errs["coherence_dots"] = lm_coherence(dev, d, rnd)
    return {"timings": {f"{k} lm": v for k, v in summarize(out, d).items()},
            "errs": errs}


def lm_coherence(dev, d: int, rnd) -> tuple:
    """coherence_dots at the coherence leg's window (W = LM_WINDOW) over the
    LM width D: held against fp64 at COHERENCE_C and against its plain
    version, two calls bitwise, then timed beside its bound, its plain
    version and torch.mv (the dots alone). Returns the timing (for
    summarize) and the max abs error against the plain version."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coherence import coherence_dots

    w = LM_WINDOW
    sets = [(rnd(w, d), rnd(d))]
    got, again = coherence_dots(*sets[0]), coherence_dots(*sets[0])
    exc = coherence_excess(got, *sets[0])
    err = max(max_abs(a, b) for a, b in zip(got, ref.coherence_dots(*sets[0])))
    print(f"coherence_dots lm W={w} D={d}: error vs fp64 {exc!r} x eps x "
          f"sum|terms| (tol {COHERENCE_C}); max_abs_err vs plain {err!r}")
    if exc > COHERENCE_C:
        raise AssertionError(f"coherence_dots lm W={w} D={d}: outside the "
                             "fp64 tolerance")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"coherence_dots lm W={w} D={d}: two calls on "
                             "the same inputs differ")
    del got, again
    timing = {
        "ms": time_ms(coherence_dots, sets, reps=10),
        "plain_ms": time_ms(ref.coherence_dots, sets, reps=10),
        "library_ms": time_ms(lambda hh, g: torch.mv(hh, g), sets, reps=10),
        "bound": bound_ms(((w + 1) * d + 2 * w + 1) * 4, (4 * w + 2) * d)}
    del sets
    torch.cuda.empty_cache()
    return timing, err


def full_adam_check(dev, d: int, chunk: int = 1 << 26) -> dict:
    """fused_adam at the full-config leg's D (every param of h2o-danube-1.8b
    in one flat [D]): the kernel runs once over the whole of D, and its
    output is held against the plain version slice by slice (Adam is
    elementwise), at TOL_ADAM; then the kernel is timed beside its bound.
    The plain version's temporaries at this D would not fit beside the
    operands, so its time is the one at the LM width."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_adam import fused_adam

    gen = torch.Generator(device=dev).manual_seed(11)
    ops = (torch.randn(d, generator=gen, device=dev),
           0.1 * torch.randn(d, generator=gen, device=dev),
           0.01 * torch.rand(d, generator=gen, device=dev),
           torch.randn(d, generator=gen, device=dev))
    got = fused_adam(*ops, 1e-3, 0.9, 0.999, 1e-8, 3)
    err = 0.0
    for lo in range(0, d, chunk):
        want = ref.fused_adam(*(x[lo:lo + chunk] for x in ops), 1e-3, 0.9,
                              0.999, 1e-8, 3)
        err = max(err, max(check_close(
            f"fused_adam D={d} [{lo}:{lo + chunk}] {k}", a[lo:lo + chunk], b,
            **TOL_ADAM) for k, a, b in zip("pmv", got, want)))
    del got, want
    torch.cuda.empty_cache()
    ms, eager = time_ms(lambda a, b, c, g: fused_adam(
        a, b, c, g, 1e-3, 0.9, 0.999, 1e-8, 3), [ops], reps=5)
    bound, by = bound_ms(7 * d * 4, 16 * d)
    print(f"fused_adam D={d} (the full-config leg's): max_abs_err={err!r} "
          f"(tol {TOL_ADAM}); kernel {ms!r} ms (device time, CUDA graph "
          f"replay; eager {eager!r} ms), bound {bound!r} ms ({by})")
    del ops
    torch.cuda.empty_cache()
    return {"d": d, "max_abs_err": err, "ms": ms, "bound_ms": bound,
            "bound_by": by}


def train_path(dev, tmp: str) -> dict:
    """Phase 9: flash_attention against its plain version and timed; the
    full-config danube leg (with the flash route); the cut-depth ring legs;
    the MoE leg; kernels 1-5 against their plain versions and timed at the
    LM width, and fused_adam at the full leg's D. Every leg runs before any
    failure is raised (a kernel check raises at once)."""
    import gc
    import torch
    # Full-width training needs the card empty: free whatever earlier
    # phases left to the cyclic collector.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train phase: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          "allocated at its start")
    failures = []
    out = {"flash_errs": flash_kernel_checks(dev)}
    out["flash_timings"] = flash_timings(dev)
    out["full"] = full_config_leg(dev, failures)
    out["ring"] = ring_legs(dev, tmp, failures)
    out["moe"] = moe_leg(dev, failures)
    from repro_torch import treemath as tm
    from repro_torch.kernels import dispatch
    width = tm.padded_size(out["ring"]["n_params"], dispatch.PACK_ALIGN)
    if width != LM_WIDTH:
        failures.append(f"ring legs' D_pad {width} != LM_WIDTH {LM_WIDTH}")
    out["lm"] = lm_kernels(dev, width, TRAIN_RING["workers"])
    out["full_adam"] = full_adam_check(dev, tm.padded_size(
        out["full"]["n_params"], dispatch.PACK_ALIGN))
    if failures:
        raise AssertionError("train phase: " + "; ".join(failures))
    return out


def flash_entry(train: dict) -> dict:
    t = train["flash_timings"]["flash_attention bf16 B8 S1024"]
    t32 = train["flash_timings"]["flash_attention fp32 B1 S2048"]
    route = train["full"]["route"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:101",
        "launches": route["launches"],
        "max_abs_err": train["flash_errs"]["fp32"],
        "max_abs_err_bf16": train["flash_errs"]["bf16"],
        "model_err_bf16": route["model_err_bf16"],
        "model_err_fp32": route["model_err_fp32"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "eager_ms": t["eager_ms"],
        "variants": {"fp32 B1 S2048": {key: t32[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}}


def add_lm_rows(kernels: list, train: dict) -> None:
    """Beside each of kernels 1-5, its times at the LM width and its
    launches on every train-phase leg."""
    legs = {"full danube": train["full"]["launches"],
            f"moe {train['moe']['arch']}": train["moe"]["launches"]}
    legs.update({name: row["launches"] for name, row in train["ring"].items()
                 if isinstance(row, dict) and "launches" in row})
    timings, errs = train["lm"]["timings"], train["lm"]["errs"]
    for entry in kernels:
        name = entry["name"]
        key = {"fused_update": "fused_update.plain"}.get(name, name)
        if f"{key} lm" not in timings:
            continue
        t = timings[f"{key} lm"]
        entry["lm_width"] = {
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "max_abs_err": errs[key],
            "launches_by_leg": {
                leg: sum(n for k, n in c.items() if k.split(".")[0] == name)
                for leg, c in legs.items()}}
        if name == "fused_update":
            ef = timings["fused_update.ef lm"]
            entry["lm_width"]["ef"] = {k: ef[k] for k in (
                "ms", "plain_ms", "bound_ms")}
            entry["lm_width"]["ef"]["max_abs_err"] = errs["fused_update.ef"]
        if name == "fused_adam":
            entry["full_d"] = train["full_adam"]


def blocks_per_sm(regs: int, threads: int = 256) -> int:
    """Blocks of ``threads`` an H100 SM holds at ``regs`` registers a
    thread: 65,536 registers allocated per warp in units of 256, at most
    64 warps."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(65536 // per_warp, 64)
    return warps // (threads // 32)


def print_ptxas(log: str, only: str = "") -> None:
    """Each kernel's registers, spills and static shared memory, as ptxas
    reported them in an ``nvcc -Xptxas -v`` log (the attention kernels'
    shared memory is dynamic, sized by their launchers: flash bf16 at hd
    80, (64 + 4 x 64) rows of 88 bf16, 56,320 B); for coherence_dots's
    kernels (256 threads a block, 1,024 the final sum's) also the blocks an
    SM those registers allow. With ``only``, just the entries whose names
    contain it."""
    import re
    src, entry, spills = "", None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None and only in entry:
            smem = re.search(r"(\d+) bytes smem", line)
            extra = ""
            if "coherence" in entry:
                threads = 1024 if "coherence_final" in entry else 256
                extra = (f"; {blocks_per_sm(int(m.group(1)), threads)} "
                         f"blocks of {threads} threads an SM by registers")
            print(f"  ptxas {src} {entry}: {m.group(1)} registers, spill "
                  f"stores {spills[0] if spills else '?'} B, spill loads "
                  f"{spills[1] if spills else '?'} B, static smem "
                  f"{smem.group(1) if smem else 0} B{extra}")


def print_tensor_core_ops(lib_path) -> None:
    """The count of HMMA (tensor-core) instructions in each flash_attention
    entry's SASS, read with cuobjdump where the toolkit has it."""
    import re
    import shutil
    from repro_torch.kernels import build
    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        exe = shutil.which("cuobjdump")
    if exe is None:
        print("cuobjdump: not found; HMMA count not read")
        return
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    fun, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fun = m.group(1)
            counts[fun] = 0
        elif fun is not None and "HMMA" in line:
            counts[fun] += 1
    for fun, n in counts.items():
        t = re.search(r"flash_mma_kernelILi(\d+)ELi(\d+)E", fun)
        if t:
            print(f"  SASS flash_mma_kernel<hd_pad {t.group(1)}, BK "
                  f"{t.group(2)}> (bf16): {n} HMMA instructions")
        t = re.search(r"flash_attention_kernelILi(\d+)E", fun)
        if t:
            print(f"  SASS flash_attention_kernel<DPL {t.group(1)}> (fp32): "
                  f"{n} HMMA instructions")


def attention_times(src: str) -> int:
    """``--attention-times SRC``: only flash_timings and paged_timings, with
    the ``repro_torch`` package under ``SRC`` (its kernels built from its
    own sources into its checkout's ``build/``). Run on two checkouts in one
    call (parent, change, change, parent), it times both designs with this
    script's time_ms."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(card_line())
    path, _, secs = build.build()
    print(f"build: {path} in {secs:.1f} s")
    rows = flash_timings(dev)
    rows.update(paged_timings(dev))
    print(json.dumps({"attention_times": {"src": src, "rows": rows}}))
    return 0


def dnn_width(dev) -> int:
    """The packed width at the main path's shapes: D = 335,114 padded to
    335,872."""
    from repro_torch import treemath as tm
    from repro_torch.kernels import dispatch
    from repro_torch.models import mlp
    return tm.padded_size(tm.pack_spec(mlp.init(
        0, mlp.MLPConfig(depth=DEPTH), device=dev)).total,
        dispatch.PACK_ALIGN)


def coherence_times(src: str) -> int:
    """``--coherence-times SRC``: only coherence_dots, with the
    ``repro_torch`` package under ``SRC`` (its kernels built from its own
    sources into its checkout's ``build/``): the ptxas lines of its
    coherence kernels, ``coherence_kernel_checks``, ``coherence_timings``
    (W = 8 and 16 at the DNN width), ``lm_coherence`` (W = 4 at the LM
    width) and ``coherence_sweep``. Run on two checkouts in one call
    (parent, change, change, parent), it times both designs with this
    script's time_ms."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(card_line())
    path, log, secs = build.build()
    print(f"build: {path} in {secs:.1f} s")
    print_ptxas(log, only="coherence")
    width = dnn_width(dev)
    coherence_kernel_checks(dev, width)
    rows = coherence_timings(dev, width)
    gen = torch.Generator(device=dev).manual_seed(5)
    lm, _ = lm_coherence(dev, LM_WIDTH, lambda *shape: torch.randn(
        shape, generator=gen, device=dev))
    rows.update({f"{k} lm": v for k, v in summarize(
        {"coherence_dots": lm}, LM_WIDTH).items()})
    sweep = coherence_sweep(dev, width)
    print(json.dumps({"coherence_times": {"src": src, "rows": rows,
                                          "sweep": sweep["fits"]}}))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
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
    print_ptxas(log)
    print_tensor_core_ops(path)

    # The packed width at the main path's shapes, times P = 8 workers.
    width = dnn_width(dev)
    n = WORKERS * width
    print(f"packed width D_pad={width}, N=P*D_pad={n}")
    errs = kernel_checks(dev, n)

    ring_errs = ring_kernel_checks(dev, width)

    runs = main_path(dev)
    sequential_check(dev)

    import numpy as np
    from repro_torch.data import synthetic
    # One [STEPS, P] delay table in [0, s-1], as the simulate path's, for
    # the paper's other models and stale-psum.
    table = np.random.default_rng(0).integers(0, STALENESS, (STEPS, WORKERS))
    table[0, 0] = STALENESS - 1
    paper = paper_path(dev, table)

    # The ring path: the same DNN, data and seeds as the simulate path, and
    # lognormal worker speeds (numpy, seed 0) for ssp's clock schedule.
    params0 = mlp.init(0, mlp.MLPConfig(depth=DEPTH), device=dev)
    speeds = np.random.default_rng(0).lognormal(
        0.0, 0.5, (64, WORKERS)).astype(np.float32)
    data = synthetic.teacher_classification(seed=0)
    ring = ring_path(dev, params0, data, table, speeds)

    timings = kernel_timings(dev, n)
    timings.update(ring_kernel_timings(dev, width))

    # The coherence path: the same DNN, data, seeds and delay table.
    coh_err = coherence_kernel_checks(dev, width)
    with tempfile.TemporaryDirectory() as tmp:
        coh = coherence_path(dev, params0, data, table, tmp)
    cost = hook_cost(dev, params0, data, table)
    timings.update(coherence_timings(dev, width))
    coherence_sweep(dev, width)

    # The serve path: paged_attention against its plain version, its
    # timings, then the full-width danube serve.
    paged_errs = paged_kernel_checks(dev)
    timings.update(paged_timings(dev))
    paged_split_sweep(dev)
    serve = serve_path(dev)

    # The train path: flash_attention, then LM training through the train
    # CLI (full-config danube, cut-depth ring legs) and the MoE leg.
    with tempfile.TemporaryDirectory() as tmp:
        train = train_path(dev, tmp)

    kernels = kernel_entries(timings, runs, ring, {**errs, **ring_errs})
    add_paper_launches(kernels, paper)
    kernels.append(coherence_entry(timings, coh, coh_err))
    kernels.append(paged_entry(timings, serve, paged_errs))
    kernels.append(flash_entry(train))
    add_lm_rows(kernels, train)
    steps_line = {f"{algo}_{k}": runs[algo, k]["ms_per_step"]
                  for algo, k in runs}
    steps_line.update({f"{name} {k}": run["ms_per_step"]
                       for (name, k), run in ring.items()})
    steps_line.update({f"{name} {k}": run["ms_per_step"]
                       for (name, k), run in coh.items()
                       if name == "theorem1"})
    steps_line.update({"gated with hook": cost["with_hook_ms_per_step"],
                       "gated without hooks":
                           cost["without_hooks_ms_per_step"]})
    steps_line.update({f"paper {name} {k}": ms
                       for name, leg in paper["legs"].items()
                       for k, ms in leg["ms_per_step"].items()})
    print(json.dumps({"engine_ms_per_step": steps_line}))
    print(json.dumps({"paper": {name: {k: v for k, v in leg.items()
                                       if k != "profile"}
                                for name, leg in paper["legs"].items()}}))
    print(json.dumps({"serve": {k: v for k, v in serve.items()
                                if k != "profile"}}))
    print(json.dumps({"train": {
        "full": {k: v for k, v in train["full"].items() if k != "profile"},
        "ring": {k: ({kk: vv for kk, vv in v.items() if kk != "profile"}
                     if isinstance(v, dict) else v)
                 for k, v in train["ring"].items()},
        "moe": train["moe"]}}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--attention-times"]:
        sys.exit(attention_times(sys.argv[2]))
    if sys.argv[1:2] == ["--coherence-times"]:
        sys.exit(coherence_times(sys.argv[2]))
    sys.exit(main())
