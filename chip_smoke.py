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
   ``F.scaled_dot_product_attention``; the full-width h2o-danube-1.8b at
   12 of its 24 layers (remat on) trained through the train
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
   and kernels 1-5 timed at the LM width;
10. the state-space families (``ssm_path``): the full-width
   mamba2-1.3b at 6 of its 48 layers (remat on) through the train CLI in
   sync mode, kernels on (profiled) and off, with the one-ulp witness and, as
   its witness parts past LM_CEILING, its step 1 from the shared init held
   elementwise (``first_step_check``); five ring legs of it at 4 layers
   (stale-psum, ssp, simulate, SGD top-k with inverse scaling, and
   ``--coherence`` with a checkpoint and a trace); zamba2-7b cut to 6
   layers through the CLI in stale-psum; both served at full width with
   their depths cut (mamba 6 of 48 layers on the resident route, zamba
   12 of 81 on the gather route, bf16,
   no kernel launched), each holding request 0's greedy tokens against a
   plain token-by-token loop and fp32 prefill + decode logits against one
   full forward over 300 tokens; kernels 1-5 held and timed at the mamba
   ring legs' width, ``fused_adam`` over mamba's full D;
11. cross-attention (``cross_path``): ``paged_attention`` against its
   plain version at whisper-base's (8/8/64) and llama-3.2-vision-11b's
   (32/8/128) self-attention head shapes (8 slots, wrapped rings, fp32 and
   bf16, two calls bitwise) and timed beside its bound, its plain version
   and SDPA; with every cross gate opened at CROSS_GATE: the full-width,
   full-depth whisper-base (~128.6 M params, remat on) through the train
   CLI in sync over 1,500-frame inputs, kernels on (profiled) and off with
   the one-ulp witness, and its six ring legs (danube's legs at 1 + 1 of
   its 6 + 6 layers); llama-3.2-vision-11b at full width with 5 of 40
   layers (one whole group, ~2.35 B params) in sync, on and off with the
   witness; both served at full width on the paged route (whisper at full
   depth, llama at 20 of 40 layers; bf16, each request with its own
   features, ``paged_attention`` once a self layer a decode step), each holding request 0's greedy tokens against a plain loop,
   fp32 prefill + decode against one forward over 300 tokens, and the fp32
   paged and gather routes' tokens against each other (llama at 10 of 40
   layers);
12. the mesh path (``mesh_path``): the DNN's simulate Adam, stale-psum
   Adam, SGD top-k ring and sync legs (P = 8, s = 16, 50 steps, kernels
   on) through ``build_engine(mesh=)``: on a 1x1 ``DeviceMesh`` over a
   one-rank ``nccl`` group, bit for bit as the mesh-less run with the same
   launch counts; and in two processes on the one card over ``gloo`` at
   data = 2 (``--mesh-rank``), each rank's launch counts checked, the
   per-worker legs bit for bit as the one-process run, sync within the
   ring legs' limits, and the collectives' share of a step from the
   profiler on rank 0;
13. serving on a mesh (``serve_mesh_path``): the full-width
   h2o-danube-1.8b at 6 of its 24 layers (bf16 compute over fp32
   params, 8 requests over 8
   slots, paged route) booted from a snapshot through ``restore_params``
   and refreshed to a second snapshot mid-serve, mesh-less (the
   reference: tokens, each token's logits, staleness stamps,
   ``paged_attention`` launches), from both snapshots nudged one ulp
   (the witness, fed the reference's tokens), on a 1x1 ``DeviceMesh``
   over a one-rank ``nccl`` group (bitwise, equal launches) and in two
   processes on the one card over ``gloo`` at 1x2
   (``--serve-mesh-rank``: "auto" resolves to the gather route there;
   ``paged="on"`` overrides it), which serve their model-axis shards
   tensor-parallel (a rank's heads through ``paged_attention``; no
   gather at boot or refresh): unrecorded, its tokens the reference's up
   to a near-tie, and fed the reference's tokens, each token's logits
   within 2x the witness's gap and its picks the reference's past the
   near-ties; then the same ranks with "reduce" dropped (planted), which
   must part past that limit; a rank's served and pool GB, ms a decode
   step (unrecorded), the restores' host wall time and each leg's peak
   memory; then whisper-base at full width and depth, which the model
   axis cannot compute tensor-parallel, mesh-less and on the same ranks
   on the gathered route (each load made whole by an ``all_gather``), booted and
   refreshed the same way, bit for bit the mesh-less run, and booted with
   a gather that delivers nothing (planted), whose tokens must part;
14. the FSDP archs on a mesh (``fsdp_mesh_path``): deepseek-67b at full
   width cut to 1 layer (2.37 B bf16 params, momentum) in two processes on
   the one card over ``gloo`` (``--fsdp-mesh-rank``): rank 0 first trains
   it as one process in ``sync`` and ``stale-psum`` over the aggregate
   ring (2 steps, B 4 x 256) and from one-ulp-nudged params (the
   witness); then both ranks train it at 2x1 (params, momentum and ring
   as data-axis shards, each layer gathered as it runs, its gradient
   reduce-scattered), held within 2x the witness (capped at LM_CEILING),
   the step-1 gradient within 2x its witness's, sync's step-1 params
   elementwise and stale-psum's grad_norm at every step within
   FSDP_NORM_REL; one step with each rank's own half-batch gradient in
   place of the reduce-scatter (planted), which must part; one sync step
   at 1x2, where the model axis computes tensor-parallel, its step-1
   loss, gradient and params held as the 2x1 leg's; one sync step at 2x1
   with 2 layers, where a layer's gathered leaves must be gone before the next layer's gather and the
   peak may grow by the added layer's shard only; ms a step, the
   collectives' share, a step's gathers and reduce-scatters, and each
   rank's peak memory (the stale-psum leg's below the one process's);
15. tensor-parallel compute on the model axis (``tp_mesh_path``): the
   full-width h2o-danube-1.8b at 4 of 24 layers (mixed attention) in
   ``sync`` Adam, ``stale-psum`` Adam and ``stale-psum`` SGD top-k,
   qwen3-14b at 1 of 40 layers (contraction attention; 1.89 B params) in
   ``sync`` SGD and qwen2-moe-a2.7b at 1 of 24 layers (32 of its 64
   experts a rank) over the aggregate ring with SGD and with Adam (whose
   losses after step 1 are printed, not held, beside a second witness and
   the one-process loss from its 1x2 step-1 params), all with kernels on
   (B 4 x 256, 3 steps, qwen3 and the MoE 2), in two processes on the one
   card over ``gloo`` at 1x2 (``--tp-mesh-rank``): rank 0 first trains
   each as one process and from one-ulp-nudged params (the witness); then
   both ranks train it on their model-axis shards, held within 2x the
   witness (capped at LM_CEILING) with step 1 held leaf by leaf and each
   rank's launch counts checked; one step with "reduce" dropped (planted, once
   an arch), which must part; one step on the gathered route
   (``placement.full``), bit for bit the reference's step 1, whose step-1
   gradient's peak (forward and backward) each rank's must fall below; ms
   a step, the gloo share, a step's model-axis bytes; after the qwen3 and
   the MoE SGD legs, 8 greedy requests served from the leg's initial
   params by the script as one process, its witness (both before the
   ranks start) and both ranks on their shards, unrecorded and fed the
   one process's tokens, held as phase 13 holds its 1x2 serve;
   then kernels 1-4 held against their plain versions and timed at a
   rank's packed width of the danube legs, a rank's row-parallel products
   timed with fp32 and bf16 partial sums, and ``paged_attention`` held
   and timed at a rank's heads (danube 16/4, the MoE 8/8, qwen3 40/8).

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.

``python3 chip_smoke.py --attention-times SRC`` runs only the two attention
kernels' timings, with the ``repro_torch`` package under ``SRC`` (see
``attention_times``); ``--coherence-times SRC`` only ``coherence_dots``'s
ptxas lines, checks, timings at the DNN and LM widths and D sweep (see
``coherence_times``). ``--fsdp-only`` and ``--tp-only [WORD ...]`` run
phase 14 or 15 alone (with words, only the legs of phase 15 whose label
holds one); ``--mesh-only [--tree DIR] [PHASE ...]`` the mesh phases 12-15
(or those named) with their laps, of this tree or of the checkout DIR
(``mesh_only``). The mesh phases' rank programs run in two rank processes
the script starts as it starts (``RankPool``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
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
# logits differ by fp32 roundoff carried through the layers (~1e-5 on logits
# of size O(1) at 24); the margin sits 100x above that, and the smoke also fails
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
# The gather route decodes one batch-1 model call a slot (~0.36 s a step at
# 24 layers), so the routes-agree legs and the bf16 gather timing run the
# first ROUTE_LAYERS of the 24 layers (a depth cut, every width kept; the
# paged bf16 serve above them keeps all 24). 4 layers, not 8, so that the
# run with phase 11 fits its time on a slow host.
ROUTE_LAYERS = 4
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


def paged_kernel_checks(dev, grid=PAGED_GRID) -> dict:
    """paged_attention vs its plain version over ``grid`` (PAGED_GRID
    unless named), fp32 and bf16 operands, and two calls bitwise. Returns
    the max abs errors at the grid's first shape (PAGED_GRID: the main
    path's, danube at T = 8), fp32 and bf16, and per grid entry."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    errs = {"by_shape": {}}
    for i, (name, heads, t, tokens, layers, layer, windows) in enumerate(
            grid):
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
            got_i = errs["by_shape"].setdefault(name, {"fp32": 0.0,
                                                       "bf16": 0.0})
            got_i["fp32"] = max(got_i["fp32"], e32)
            got_i["bf16"] = max(got_i["bf16"], e16)
        del pool
    torch.cuda.synchronize(dev)
    return errs


# paged_timings' case: a serve's head shape (H, Hkv, hd), page rows T, ring
# rows, layers, the pages each mid-run slot holds and its position. The
# danube serve cell's: 28 pages (prompt 128 + up to 96 new tokens) at
# position 176 of a 512-row ring.
SERVE_TIMING = dict(heads=(32, 8, 80), t=8, tokens=512, layers=24, held=28,
                    pos=176)


def paged_timing_case(dev, case=SERVE_TIMING):
    """The paged_attention inputs that paged_timings describes (the serve
    cell's unless ``case`` names another): the pool, the wrapper's
    keywords, its positional arguments and one argument set per layer."""
    import torch
    pool, kw = paged_case(dev, heads=case["heads"], t=case["t"],
                          tokens=case["tokens"], layers=case["layers"],
                          seed=3)
    s = pool["tables"].shape[0]
    tables = pool["tables"].clone()
    tables[:, case["held"]:] = pool["pages"].shape[0] - 1
    pool["tables"] = tables.contiguous()
    pool["pos"] = torch.full((s,), case["pos"], dtype=torch.int32, device=dev)
    return pool, kw, _paged_args(pool), [(layer,)
                                         for layer in range(case["layers"])]


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


def paged_timings(dev, case=SERVE_TIMING, name="paged_attention") -> dict:
    """paged_attention at a serve's shapes, by default the serve cell's
    (danube, 8 slots, 8-row pages, 512-row rings): slots 0-6 mid-run at
    position 176 with the 28 pages a request holds (lazy allocation:
    prompt 128 + up to 96 new tokens) and the rest null, slot 7 empty;
    fp32 operands. Sets cycle through the 24 layers' column blocks (6.3 MB
    of K/V read a call, 151 MB a cycle, past the 50 MB L2). Library call:
    F.scaled_dot_product_attention over the already-gathered contiguous
    ring with the boolean mask (gather excluded), a cross-check only. The
    bound counts the bytes of the rows the call attends over, not of every
    row its held pages hold. The row is keyed ``name``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention

    pool, kw, args, sets = paged_timing_case(dev, case)
    s, pps = pool["tables"].shape
    n_layers = case["layers"]

    # SDPA inputs per layer: the gathered ring with the new token written
    # at the cursor, and the validity mask, exactly as the plain version
    # builds them.
    h, hkv, hd = case["heads"]
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
    for layer in range(n_layers):
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
    lib_sets = [(qs,) + rings[layer] for layer in range(n_layers)]

    out = {name: {
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
    out[name]["bound"] = bound_ms(n_bytes, n_flops)
    print(f"{name} timing inputs: H/Hkv/hd {h}/{hkv}/{hd}, S={s}, "
          f"{non_null} non-null pages of {s * pps}, {pool_rows} pool rows "
          f"and {s} new tokens attended, {entries} table entries read, "
          f"{n_bytes} bytes a call, {n_layers} layers' blocks "
          f"({n_layers * n_bytes} bytes a cycle)")
    rows_ = summarize(out, n_bytes)
    row = rows_[name]
    print(f"timing {name}: bf16 operands through the wrapper "
          f"(casts included) {row['bf16_wrapper_ms']!r} ms")
    # the SDPA cross-check computes the same function
    lay = min(7, n_layers - 1)
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


# -- teacher-forced serving ------------------------------------------------------
#
# Two servers whose logits part at roundoff (a tensor-parallel serve beside
# one process, or one process beside its one-ulp witness) sample the same
# tokens until a near-tie, and then serve different streams whose logits
# cannot be compared. ``Forcing``, a context manager around ``Server.run``,
# records for every request the logits of each token it samples (index 0:
# the prefill's; index j: decode step j) over the real vocab, the top-2
# margin of the scores its pick takes the argmax of (``plan.pick_scores``:
# the logits when greedy, the Gumbel-max scores at a temperature) and the
# server's own pick. Given ``tokens`` ({rid: served tokens} of a reference
# run) it replaces every pick by the reference's, so each step's input is
# the reference's token, whatever this server picked: its logits are then
# comparable with the reference's at every step (``logit_gap``), and its
# own picks show where the two streams would part (``parting``). The
# schedule (joins, evictions, refreshes) follows the request budgets and
# the clock, not the tokens, so a forced run meets the same steps as its
# reference. A recorded run copies each step's logits to the host, so its
# decode times are not the server's: time an unrecorded run. The mesh
# tests use these too (``tests/_mesh_workers.py``).


class Forcing:
    """Record (and with ``tokens``, force) ``server``'s picks while the
    context is open, by standing in for ``engine/plan.py::_pick`` and the
    server's ``_sample_first``. ``record()`` gives ``{"logits": {rid:
    [n, V] fp32 on the host}, "margins": {rid: [float]}, "picks": {rid:
    [int]}}``."""

    def __init__(self, server, tokens=None):
        self.server, self.tokens = server, tokens
        self.vocab = server.api.vocab_real
        self.rows, self.margins, self.picks = {}, {}, {}

    def _note(self, logits, scores) -> tuple:
        """``(rows, margins, picks)`` on the host of a block of logits
        ``[S, V]`` and the scores a pick takes the argmax of, in one copy
        each (one device sync a step, whatever the slots)."""
        import torch
        top2 = torch.topk(scores[:, :self.vocab], 2, dim=-1).values
        return (logits[:, :self.vocab].detach().to("cpu", torch.float32,
                                                   copy=True),
                (top2[:, 0] - top2[:, 1]).tolist(),
                torch.argmax(scores, dim=-1).tolist())

    def _keep(self, rid: int, at: int, row, margin: float, own: int) -> int:
        """Record token ``at`` of ``rid``; returns the token to serve."""
        if at != len(self.picks.setdefault(rid, [])):
            raise ValueError(f"request {rid}: token {at} recorded out of "
                             f"order")
        self.rows.setdefault(rid, []).append(row)
        self.margins.setdefault(rid, []).append(margin)
        self.picks[rid].append(own)
        return own if self.tokens is None else int(self.tokens[rid][at])

    def __enter__(self):
        import torch
        from repro_torch.engine import plan as planlib
        server = self.server
        self._planlib, self._pick = planlib, planlib._pick

        def pick(logits, tokens, mask, gen, temp):
            rows, margins, owns = self._note(
                logits, planlib.pick_scores(logits, gen, temp))
            nxt = tokens.tolist()
            for i in torch.nonzero(mask).flatten().tolist():
                st = server.batcher.slots[i]
                nxt[i] = self._keep(st.request.rid, len(st.tokens), rows[i],
                                    margins[i], owns[i])
            return torch.as_tensor(nxt, dtype=tokens.dtype,
                                   device=tokens.device)

        def first(logits, rid):
            rows, margins, owns = self._note(
                logits[0, -1:].float(), server.first_scores(logits, rid)[None])
            return self._keep(rid, 0, rows[0], margins[0], owns[0])
        planlib._pick = pick
        server._sample_first = first
        return self

    def __exit__(self, *exc):
        self._planlib._pick = self._pick
        del self.server._sample_first
        return False

    def record(self) -> dict:
        import torch
        return {"logits": {rid: torch.stack(rows)
                           for rid, rows in self.rows.items()},
                "margins": dict(self.margins), "picks": dict(self.picks)}


def logit_gap(got: dict, ref: dict, keep=None) -> dict:
    """The largest ``|got - ref|`` over every token both records hold
    (with ``keep``, {rid: [bool a token]}, those it marks), the largest
    ``|ref|`` logit there and their ratio ``rel``."""
    import torch
    worst = scale = 0.0
    for rid, want in ref["logits"].items():
        have = got["logits"][rid]
        n = min(len(have), len(want))
        rows = (torch.ones(n, dtype=torch.bool) if keep is None
                else torch.as_tensor(keep[rid][:n], dtype=torch.bool))
        if not rows.any():
            continue
        worst = max(worst, float((have[:n][rows] - want[:n][rows]).abs()
                                 .max()))
        scale = max(scale, float(want[:n][rows].abs().max()))
    return {"max_abs": worst, "scale": scale,
            "rel": worst / scale if scale else float("inf")}


def parting(picks: dict, ref: dict, margin: float) -> dict:
    """Where ``picks`` ({rid: tokens}: a forced run's own picks, or a free
    run's served tokens) part from the reference record's: for each
    request its first near-tie (the first token whose reference top-2
    margin is below ``margin``, or None) and the tokens before it that
    differ (``parted``: they must not). A forced run's every step has the
    reference's inputs, so ``flips`` lists each token, before or after a
    near-tie, whose reference margin is at least ``margin`` and whose pick
    differs (for a forced run, none may)."""
    ties, parted, flips = {}, {}, {}
    for rid, want in ref["picks"].items():
        margins = ref["margins"][rid]
        tie = next((j for j, m in enumerate(margins) if m < margin), None)
        ties[rid] = tie
        upto = len(want) if tie is None else tie
        bad = [j for j, (a, b) in enumerate(zip(picks[rid][:upto],
                                                 want[:upto])) if a != b]
        if bad or len(picks[rid]) < upto:
            parted[rid] = bad or [len(picks[rid])]
        flipped = [j for j, (a, b, m) in enumerate(zip(picks[rid], want,
                                                        margins))
                   if a != b and m >= margin]
        if flipped:
            flips[rid] = flipped
    return {"ties": ties, "parted": parted, "flips": flips}


def serve_requests(vocab: int, n: int = SERVE_REQUESTS,
                   new_tokens=SERVE_NEW_TOKENS, prompt_len=None,
                   features=None):
    """``n`` synthetic requests (seed 1) of ``prompt_len`` tokens (SERVE's
    unless named), all arriving at 0.0, with max_new_tokens drawn in
    ``new_tokens`` (numpy, seed 1). ``features`` ({name: batch-1 shape})
    gives each request its own standard-normal features (numpy, seed 2),
    as the serve CLI draws them."""
    import numpy as np
    from repro_torch.serving import synthetic_requests
    reqs = synthetic_requests(n, prompt_len or SERVE["prompt_len"], 1, vocab,
                              arrivals=[0.0] * n, seed=1)
    lo, hi = new_tokens
    gens = np.random.default_rng(1).integers(lo, hi + 1, n)
    rng = np.random.default_rng(2)
    for r, g in zip(reqs, gens):
        r.max_new_tokens = int(g)
        if features:
            r.features = {name: rng.standard_normal(shape).astype(np.float32)
                          for name, shape in sorted(features.items())}
    return reqs


def profile_decode(server, k: int = 5, features=None) -> dict:
    """Device busy share (the union of the device events' spans) of ``k``
    decode steps of a full batch under torch.profiler (the slots admitted
    and prefilled first, outside the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import AdmissionQueue

    server._admit(AdmissionQueue(serve_requests(
        server.api.vocab_real, server.cfg.slots,
        prompt_len=server.cfg.prompt_len, features=features)), 0.0)
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
    union_ms = busy_union_ms(prof) / k
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    for i in server.batcher.active():
        server._finish(i, [], 0.0, "done")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
            "device_busy_union_ms_per_step": union_ms,
            "idle_share": 1.0 - union_ms / wall_ms if union_ms else None,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / k,
                     e.count / k) for e in top]}


def serve_run(dev, params, *, paged: str, overrides=None, record=False,
              serve_kw=None, n=SERVE_REQUESTS, arch=SERVE_ARCH,
              new_tokens=SERVE_NEW_TOKENS, features=None):
    """One full serve of serve_requests(n, new_tokens, features) of
    ``arch`` on a fresh Server (after a short warm-up serve on another),
    with SERVE changed by ``serve_kw``. Returns the server, the report, the
    launch counters of the measured run and, with ``record``, per request
    the (top-2 margin, logits) of each decode step (``Forcing``'s
    record, the prefill's token left out)."""
    import torch
    from repro_torch.serving import Server, ServingConfig

    cfg = ServingConfig(arch=arch, reduced=False, paged=paged,
                        overrides=overrides, **{**SERVE, **(serve_kw or {})})
    warm = Server(cfg, params=params, device=dev)
    vocab = warm.api.vocab_real
    warm_reqs = serve_requests(vocab, 2, prompt_len=cfg.prompt_len,
                               features=features)
    for r in warm_reqs:
        r.max_new_tokens = 3
    warm.run(warm_reqs)
    del warm
    server = Server(cfg, params=params, device=dev)
    torch.cuda.synchronize()
    reqs = serve_requests(vocab, n, new_tokens, prompt_len=cfg.prompt_len,
                          features=features)
    reset_counters()
    with Forcing(server) if record else contextlib.nullcontext() as rec:
        report = server.run(reqs)
    launches = counters()
    steps = {}
    if record:
        got = rec.record()
        steps = {rid: list(zip(got["margins"][rid][1:], rows[1:]))
                 for rid, rows in got["logits"].items()}
    return server, report, launches, steps


def compare_routes(label, paged_rep, paged_steps, gather_rep, gather_steps,
                   ring: int, prompt_len: int = SERVE["prompt_len"]) -> dict:
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
            wrapped += prompt_len + j >= ring
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
    ROUTE_LEGS) and the bf16 gather route's timing, these last at the
    first ROUTE_LAYERS layers."""
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
        layers = (overrides or {}).get("num_layers", cfg.num_layers)
        want = layers * rep.decode_steps if paged == "on" else 0
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
    cut = {"num_layers": min(ROUTE_LAYERS, cfg.num_layers)}
    f32 = {"dtype": torch.float32, **cut}
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
    run("gather bf16", "off", cut)
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
TRAIN_FULL = dict(layers=12, batch=8, seq=1024, steps=4, timed=3,
                  profile=2)
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
# A full-width leg whose own witness parts past LM_CEILING (mamba2-1.3b:
# 0.77 in rel and 2.0e-2 in loss over 4 steps on the H100, PERF.md): its
# step 1 from the shared init, kernels on against off, held as the CPU
# parity tests hold Adam (``first_step_check``).
TOL_FIRST = dict(rtol=1e-5, atol=2e-5)
FIRST_FLIP_SHARE = 1e-4
# The MoE leg's aux loss (~0.012) under the same scheme: the witness parts
# it by 3.5e-5, on vs off by 3e-6 (PERF.md).
AUX_CEILING = 5e-4
# The coherence legs' mu, on against off: never further apart than this,
# unless the one-ulp witness's mu parts further (ring_legs), and never
# further than MU_CEILING however far the witness parts (the gaps measured
# on the H100 were at most 1.4e-3, PERF.md).
MU_FLOOR = 1e-3
MU_CEILING = 1e-2


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


def nudged(params, toward: float = float("inf")):
    """Every param moved by one ulp toward ``toward`` (up by default): a
    roundoff-sized perturbation."""
    import torch
    from repro_torch import treemath as tm
    return tm.tree_map(
        lambda x: torch.nextafter(x, torch.full_like(x, toward)), params)


def cli_engine(dev, argv: list):
    """The engine the train CLI builds from ``argv`` (its EngineConfig and
    optimizer, through make_train_engine), with the arch's API, the parsed
    arguments and the resolved mode."""
    from repro_torch import configs as cfglib
    from repro_torch.configs.base import InputShape
    from repro_torch.engine import EngineConfig
    from repro_torch.engine.plan import make_train_engine
    from repro_torch.launch import train

    args = train.parser().parse_args(argv)
    assert not (args.delay or args.trace or args.lr or args.reduced), argv
    mode = args.mode
    if mode == "auto":
        mode = "sync" if args.stale == 0 else "stale-psum"
    ecfg = EngineConfig(mode=mode, num_workers=args.workers, s=args.stale,
                        kernels=args.kernels, compress=args.compress,
                        lr_scale=args.lr_scale,
                        ssp_steps=max(args.steps, 1), ssp_seed=args.seed)
    shape = InputShape(f"train_cli_{args.seq}", args.seq, args.batch, "train")
    engine = make_train_engine(args.arch, shape, ecfg=ecfg,
                               optimizer_name=args.optimizer, device=dev)
    return engine, cfglib.get(args.arch).api(), args, mode


def witness_run(dev, argv: list, params) -> dict:
    """The kernels-off CLI run of ``argv`` again from ``params`` in place
    of the seeded init: the engine the CLI builds (``cli_engine``), its
    batches and (with ``--coherence``) probe hook, through
    ``Trainer.run(params=...)``. Returns its losses and final params (on
    the host)."""
    import gc
    import torch
    from repro_torch import treemath as tm
    from repro_torch.core import coherence as coh
    from repro_torch.engine import CoherenceHook, Trainer
    from repro_torch.launch import train

    engine, api, args, mode = cli_engine(dev, argv)
    assert args.kernels == "off", argv
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
           "mu": [row.get("mu") for row in res.history],
           "params": to_host(engine.params(res.state))}
    del engine, res, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def first_step_check(dev, arch: str, flags: dict, p0, failures: list) -> dict:
    """Step 1 of a sync leg, kernels on against off, from the shared seeded
    init ``p0`` on the CLI's first batch: the same params and batch, so the
    same loss and (up to the embedding backward's unordered bf16
    accumulation) the same gradient. The updated params are held as the
    CPU parity tests hold Adam (``test_torch_lm_train.py``): every element
    within 2 x lr of the off run's (Adam moves an element by at most lr a
    step, and a gradient element within roundoff of 0 may flip its sign),
    all but a FIRST_FLIP_SHARE share within TOL_FIRST."""
    import gc
    import torch
    from repro_torch import treemath as tm
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.optim import optimizers as optlib

    got = {}
    for kernels in ("on", "off"):
        engine, api, args, _ = cli_engine(
            dev, cli_argv(arch, kernels=kernels, **flags))
        batch = train.make_batch_fn(api, args.batch, args.seq, args.seed)()
        state = engine.init(args.seed,
                            params=tm.tree_map(lambda x: x.to(dev), p0))
        reset_counters()
        state, metrics = engine.step(state, batch)
        torch.cuda.synchronize(dev)
        # The packed params wait on the host while the other run holds
        # the card (at 2.35 B params a packed copy is 9.4 GB).
        got[kernels] = {"loss": float(metrics["loss"]), "launches": counters(),
                        "params": tm.tree_pack(engine.params(state),
                                               pad_to=dispatch.PACK_ALIGN)
                        .cpu()}
        del engine, state, metrics
        gc.collect()
        torch.cuda.empty_cache()
    lr = optlib.get_optimizer(args.optimizer or "adam").spec["lr"]
    a, b = (got[k].pop("params").to(dev) for k in ("on", "off"))
    err = (a - b).abs_()
    outside = int((err > TOL_FIRST["atol"] + TOL_FIRST["rtol"] * b.abs())
                  .sum())
    out = {"loss_on": got["on"]["loss"], "loss_off": got["off"]["loss"],
           "max_abs_err": float(err.max()), "limit_everywhere": 2 * lr,
           "outside_tol": outside, "elements": b.numel(),
           "share_limit": FIRST_FLIP_SHARE}
    del a, b, err
    torch.cuda.empty_cache()
    print(f"train {arch} step 1 from the shared init, kernels on vs off: "
          f"{json.dumps(out)} (TOL_FIRST {TOL_FIRST})")
    if (abs(out["loss_on"] - out["loss_off"]) > LM_FLOOR["loss"]
            or out["max_abs_err"] > 2 * lr
            or outside > FIRST_FLIP_SHARE * out["elements"]):
        failures.append(f"{arch} step 1: kernels on and off differ {out}")
    if (got["on"]["launches"] != expect(1, fused_adam=1)
            or got["off"]["launches"] != expect(1)):
        failures.append(f"{arch} step 1: launches {got}")
    return out


def check_lm_pair(dev, name, on, off, witness, p0, failures: list,
                  shared_step=None) -> dict:
    """Holds ``on`` against ``off`` within WITNESS_FACTOR times how far
    ``witness`` (off from nudged params) parts from ``off``, capped at
    LM_CEILING; records a failure instead of raising, so one run reports
    every leg. Where the witness alone parts past the ceiling, the
    free-running runs are chaotic within the leg's steps and the cap would
    refuse any sound route: where it does so in every metric,
    ``shared_step()`` (a step-by-step check from a shared state) must
    pass, and the free-running runs are held to WITNESS_FACTOR times the
    witness."""
    import math
    dist = lm_distance(dev, on, off, p0)
    wit = lm_distance(dev, witness, off, p0)
    chaotic = all(wit[k] > LM_CEILING[k] for k in wit)
    limit = {k: max(WITNESS_FACTOR * wit[k], LM_FLOOR[k]) for k in dist}
    step = None
    if chaotic and shared_step is not None:
        step = shared_step()
    else:
        limit = {k: min(v, LM_CEILING[k]) for k, v in limit.items()}
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
    out = {"on_vs_off": dist, "witness": wit, "limit": limit}
    if step is not None:
        out["shared_step"] = step
    return out


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


def full_leg(dev, arch: str, f: dict, label: str, failures: list,
             after_on=None) -> dict:
    """A full-config leg through the train CLI in sync mode: kernels on
    (the main path; timed and profiled), ``after_on(params)`` on the
    trained params (on the card), kernels off, and the one-ulp witness."""
    import gc
    import torch
    from repro_torch import treemath as tm

    flags = dict(steps=f["steps"], batch=f["batch"], seq=f["seq"], stale=0,
                 workers=1, log_every=1, seed=0)
    laps, clock = {}, [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        laps[what] = round(now - clock[0], 1)
        clock[0] = now

    p0 = init_params(dev, arch)
    n_params = sum(x.numel() for x in tm.tree_leaves(p0))
    on = train_cli(dev, cli_argv(arch, kernels="on", **flags),
                   batch=f["batch"], seq=f["seq"], timed=f["timed"],
                   profile=f["profile"])
    check_counts(f"{label} on", on, expect(f["steps"], fused_adam=1),
                 failures)
    print(f"train {label}: {n_params} params, losses {on['losses']}, "
          f"ms_per_step {on['ms_per_step']!r} (mean of {f['timed']} steps "
          f"after {f['steps']}, host clock between syncs), peak memory "
          f"{on['peak_mem_gb']:.1f} GB ({on['start_mem_gb']:.2f} GB "
          f"allocated before the run), CLI wall {on['wall_s']:.1f} s")
    print(f"profile train {label}: {json.dumps(on['profile'])}")
    lap("on")
    extra = {}
    if after_on is not None:
        params = tm.tree_map(lambda x: x.to(dev), on["params"])
        extra = after_on(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    off_argv = cli_argv(arch, kernels="off", **flags)
    lap("after on")
    off = train_cli(dev, off_argv, batch=f["batch"], seq=f["seq"])
    check_counts(f"{label} off", off, expect(f["steps"]), failures)
    lap("off")
    witness = witness_run(dev, off_argv, nudged(p0))
    lap("witness")
    dist = check_lm_pair(
        dev, label, on, off, witness, p0, failures,
        shared_step=lambda: first_step_check(dev, arch, flags, p0, failures))
    lap("checks")
    print(f"train {label}: seconds by part {json.dumps(laps)}")
    out = {"n_params": n_params, "losses_on": on["losses"],
           "losses_off": off["losses"], "distance": dist,
           "ms_per_step": on["ms_per_step"], "profile": on["profile"],
           "peak_mem_gb": on["peak_mem_gb"], "launches": on["launches"],
           **extra}
    del on, off, witness, p0
    gc.collect()
    return out


def full_config_leg(dev, failures: list) -> dict:
    """The full-config danube leg through the train CLI, kernels on (the
    main path) then off, and the flash_attention route on the trained
    params."""
    import torch
    from repro_torch import configs as cfglib

    f = TRAIN_FULL
    arch = cut_arch(TRAIN_ARCH, f["layers"])
    cfg = cfglib.get(arch).api().cfg

    def route(params):
        tokens = next(train_batches(cli_argv(arch), 2, f["seq"], 0))
        tokens = torch.as_tensor(tokens["tokens"][:, :-1], device=dev)
        return {"route": flash_route(dev, params, cfg, tokens, failures)}

    return full_leg(dev, arch, f, f"danube {f['layers']} layers", failures,
                    after_on=route)


def ring_legs(dev, tmp: str, failures: list, arch_id: str = TRAIN_ARCH,
              r: dict = TRAIN_RING, legs=TRAIN_LEGS) -> dict:
    """The cut-depth legs of ``arch_id`` (danube unless named) through the
    train CLI, each kernels on against kernels off; a coherence leg also
    checkpoints (the snapshot restores bit for bit) and records a trace
    (which then replays)."""
    import gc
    import torch
    from repro_torch import treemath as tm
    from repro_torch.checkpoint import checkpoint as ckpt

    arch = cut_arch(arch_id, r["layers"])
    tmp = os.path.join(tmp, arch)
    os.makedirs(tmp, exist_ok=True)
    p0 = init_params(dev, arch)
    n_params = sum(x.numel() for x in tm.tree_leaves(p0))
    print(f"train ring legs: {arch}, {n_params} params, P={r['workers']}, "
          f"s={r['stale']}, batch {r['batch']} x seq {r['seq']}, "
          f"{r['steps']} steps")
    base = dict(steps=r["steps"], batch=r["batch"], seq=r["seq"],
                stale=r["stale"], workers=r["workers"], log_every=1, seed=0)
    out = {"arch": arch, "n_params": n_params}
    for i, (name, flags, per_on, per_off) in enumerate(legs):
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
            mu_wit = runs["witness"]["mu"]
            # mu is read from each run's own gradients, so it parts as the
            # runs part: held to MU_FLOOR, or WITNESS_FACTOR times how far
            # the witness's mu parts from the off run's where that is more,
            # capped at MU_CEILING.
            lim = min(MU_CEILING, max(MU_FLOOR, WITNESS_FACTOR * max(
                abs(a - b) for a, b in zip(mu_wit, mu_off))))
            print(f"train {name}: mu on {mu_on} off {mu_off} witness "
                  f"{mu_wit}; limit {lim!r}")
            if None in mu_on or any(abs(a - b) > lim
                                    for a, b in zip(mu_on, mu_off)):
                failures.append(f"{name}: mu on {mu_on} vs off {mu_off} "
                                f"(limit {lim!r})")
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


def lm_kernels(dev, width: int, workers: int, tag: str = "lm",
               coherence: bool = True) -> dict:
    """Kernels 1-5 (1-4 without ``coherence``) at the ring legs' LM width
    (D_pad = ``width``, P = ``workers``; timings keyed ``"<kernel>
    <tag>"``), each held against its plain version on the inputs it is
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
    if coherence:
        out["coherence_dots"], errs["coherence_dots"] = lm_coherence(dev, d,
                                                                     rnd)
    return {"timings": {f"{k} {tag}": v
                        for k, v in summarize(out, d).items()},
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


# -- phase 10: the state-space families ----------------------------------------

# mamba2-1.3b at full width (d_model 2048, 64 SSD heads of dim 64, state
# 128, chunk 256; vocab 50,288), random weights from seed 0, through the
# train CLI in sync mode with remat and Adam. At full depth (48 layers,
# 1,446,538,240 params) it took ~117 s of the run; since the serving-mesh
# phase joined, its depth is cut to SSM_FULL["layers"] to fit the run's
# limit (24 layers, then 6 since the FSDP mesh phase joined). At full
# depth (the figures below; 6 layers take about an eighth):
# fp32 params, Adam's two moments and the gradients take 4 x 5.79 =
# 23.1 GB; the sync fused tail packs a [D] copy of each of
# params and gradients (~11.6 GB more). With remat a step keeps each
# layer's input (8 x 1024 x 2048 bf16, 33.5 MB x 48 = 1.6 GB) and rebuilds
# one layer at a time: its intra-chunk tensors are [B, NC, H, Q, Q] fp32 =
# 8 x 4 x 64 x 256 x 256 x 4 B = 537 MB each, about six of them live with
# their gradients (~3-5 GB); the logits are 8 x 1024 x 50,288 (0.8 GB bf16,
# 1.6 GB fp32, a few fp32 copies in the loss and its backward, ~6 GB).
# Predicted peak ~45-50 GB of the card's 80.
SSM_ARCH = "mamba2-1.3b"
SSM_FULL = dict(layers=6, batch=8, seq=1024, steps=4, timed=3, profile=2)
SSM_FULL_LABEL = f"mamba {SSM_FULL['layers']} layers"
# Ring legs: every width kept, 4 of 48 layers (~0.31 B params, 1.24 GB a
# copy), P = 2, s = 3 (a [3, 2, D] ring of 7.4 GB): the danube legs' flags.
SSM_RING = dict(TRAIN_RING)
SSM_LEGS = tuple(leg for leg in TRAIN_LEGS
                 if leg[0] != "stale-psum adam topk")
# zamba2-7b: 81 mamba layers (d_model 3,584, 112 SSD heads of dim 64,
# state 64) and one shared attention+MLP block (32 heads of 112, d_ff
# 14,336) after every 6; 6,750,539,856 params (27.0 GB fp32). Training at
# full depth needs params, two moments and gradients, 4 x 27 = 108 GB, which
# no H100 holds: the training leg keeps every width and cuts the depth to 6
# layers (one group of 6 and its shared-block invocation; 7 until the FSDP
# mesh phase joined, with one tail layer, ~0.98 B params).
HYBRID_ARCH = "zamba2-7b"
HYBRID_RING = dict(TRAIN_RING, layers=6)
HYBRID_LEGS = TRAIN_LEGS[:1]                     # stale-psum Adam
# The serves, bf16 compute over fp32 params: mamba on the resident route
# (its cache has no token axis: 48 x 0.54 M fp32 state floats, ~100 MB a
# slot), zamba on the gather route (no decode_paged in either package; a
# 160-row ring of 13 invocations x 32 x 112 x 2 floats a row). Both routes
# decode one batch-1 model call a slot (the JAX package's vmap, written as
# a loop), host-bound at ~0.73 s a decode step on the H100 (PERF.md), so
# the new tokens are cut to fit the run's time: mamba 4-12 (of up to 96),
# zamba 8 (of 32), half what they were before phase 11 joined the run.
# Since the serving-mesh phase joined, the depths are cut too: mamba to 24
# of 48 layers, zamba to 42 of 81; since the FSDP mesh phase joined, to 6
# and 12 (two groups of six, two shared-block invocations).
SSM_SERVE = dict(arch=SSM_ARCH, layers=6, n=16, new_tokens=(4, 12),
                 serve_kw=dict(max_seq=224))
HYBRID_SERVE = dict(arch=HYBRID_ARCH, layers=12, n=8, new_tokens=(8, 8),
                    serve_kw=dict(slots=4, max_seq=160, prefill_batch=4))
# Prefill + decode against one full forward, fp32, over 300 tokens (not a
# multiple of the 256-token chunk): the prefill's 290 logits, then 10 decode
# steps (the T = 1 recurrence; the hybrid's ring attention). The two routes
# sum the same fp32 products in other orders (the chunked scan's carries
# against the recurrence), so the logits agree to roundoff carried through
# 48 or 81 layers; a wrong cache or position moves them by O(1). Held to
# 1e-3 of the largest |logit|.
HOLD_LEN, HOLD_DECODE = 300, 10
HOLD_REL = 1e-3
# A greedy request against a plain token-by-token loop (bf16, the serve's
# prefill batch, then batch-1 decode through the model's own cache): the
# tokens must agree up to the first step where the loop's top-2 margin is
# below this (a near-tie that bf16 roundoff may flip).
GREEDY_MARGIN = 0.05


def narrow_batch(cache, family: str):
    """Batch row 0 of a batched prefill cache (keepdims): every leaf's
    batch axis is 1 ([L, invocations or cross layers, B, ...]), except the
    ring positions (``slot_pos``, the hybrid's ``attn_slot_pos``), which
    have none."""
    from repro_torch import treemath as tm
    if family in ("transformer", "encdec"):
        return {k: (v if k == "slot_pos" else v.narrow(1, 0, 1))
                for k, v in cache.items()}
    if family == "hybrid":
        out = {k: v.narrow(1, 0, 1) for k, v in cache.items()
               if k.startswith("attn_") and k != "attn_slot_pos"}
        out["attn_slot_pos"] = cache["attn_slot_pos"]
        out["mamba"] = tm.tree_map(lambda x: x.narrow(1, 0, 1),
                                   cache["mamba"])
        return out
    return tm.tree_map(lambda x: x.narrow(1, 0, 1), cache)


def grafted(api, cache, max_seq: int, dev):
    """A prefill ring (``clen`` rows) written into an empty ``max_seq``-row
    cache, as the serving plane's admission does; the length-independent
    leaves (the hybrid's mamba states, the cross K/V) carried over."""
    if api.family == "hybrid":
        ring, pos_key = ("attn_k", "attn_v"), "attn_slot_pos"
    else:
        ring, pos_key = ("k", "v"), "slot_pos"
    full = api.init_cache(1, max_seq, device=dev)[0]
    clen = cache[ring[0]].shape[2]
    for key in set(full) - set(ring) - {pos_key}:
        full[key] = cache[key]
    for key in ring:
        full[key][:, :, :clen] = cache[key]
    full[pos_key][:, :clen] = cache[pos_key]
    return full


def greedy_hold(dev, api, params, prompts, served: list, max_seq: int,
                features=None) -> dict:
    """The first request of the serve's first prefill batch (``prompts``,
    [B, prompt_len], with the batch's ``features`` where the family takes
    them) replayed by a plain loop: one prefill of the batch, then the
    model's decode on its own cache, one token at a time (batch 1),
    greedy. Its tokens against ``served`` up to the first near-tie."""
    import torch
    with torch.no_grad():
        logits, cache = api.prefill(params, {"tokens": prompts,
                                             **(features or {})})
        cache = narrow_batch(cache, api.family)
        if api.family != "ssm":
            cache = grafted(api, cache, max_seq, dev)
        row = logits[0, -1].float()
        tokens, margins = [], []
        pos = prompts.shape[1]
        while True:
            top2 = torch.topk(row, 2).values
            margins.append(float(top2[0] - top2[1]))
            tokens.append(int(torch.argmax(row)))
            if len(tokens) == len(served):
                break
            tok = torch.tensor([[tokens[-1]]], dtype=torch.int32, device=dev)
            logits, cache = api.decode(params, tok, cache, pos)
            row = logits[0, -1].float()
            pos += 1
    compared = 0
    for j, (a, b) in enumerate(zip(tokens, served)):
        if a != b:
            if margins[j] >= GREEDY_MARGIN:
                raise AssertionError(
                    f"{api.cfg.name}: served token {j} is {b}, the plain "
                    f"loop's {a} at top-2 margin {margins[j]!r}")
            break
        compared += 1
    return {"compared": compared, "total": len(served),
            "equal": tokens == served, "min_margin": min(margins)}


def model_forward(api, params, tokens, feats, return_cache=False):
    """One forward of any family -> (logits, prefill cache or None);
    ``feats`` holds the cross families' ``frames`` / ``cross_feats``."""
    from repro_torch.models import encdec, hybrid, ssm
    from repro_torch.models import transformer as tr
    if api.family == "ssm":
        out = ssm.lm_forward(params, tokens, api.cfg,
                             return_cache=return_cache)
        return out if return_cache else (out, None)
    if api.family == "hybrid":
        out = hybrid.forward(params, tokens, api.cfg,
                             return_cache=return_cache)
    elif api.family == "encdec":
        out = encdec.forward(params, tokens, feats["frames"], api.cfg,
                             return_cache=return_cache)
    else:
        out = tr.forward(params, tokens, api.cfg,
                         cross_feats=feats.get("cross_feats"),
                         return_cache=return_cache)
    return out[0], (out[2] if return_cache else None)


def full_forward_hold(dev, arch: str, params) -> dict:
    """fp32: prefill over HOLD_LEN - HOLD_DECODE tokens then HOLD_DECODE
    decode steps (on the ring grafted into a HOLD_LEN-row cache, where the
    family has one), against one forward over all HOLD_LEN tokens (seed 3;
    a cross family's features drawn after the tokens)."""
    import numpy as np
    import torch
    from repro_torch import configs as cfglib
    api = cfglib.get(arch).api(overrides={"dtype": torch.float32})
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, api.vocab_real, (1, HOLD_LEN))
                           .astype(np.int32), device=dev)
    feats = {k: torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=dev) for k, shape in cross_features(api).items()}
    n = HOLD_LEN - HOLD_DECODE
    with torch.no_grad():
        full = model_forward(api, params, toks, feats)[0]
        pre, cache = model_forward(api, params, toks[:, :n], feats,
                                   return_cache=True)
        if api.family != "ssm":
            cache = grafted(api, cache, HOLD_LEN, dev)
        got = [pre]
        for pos in range(n, HOLD_LEN):
            logits, cache = api.decode(params, toks[:, pos:pos + 1], cache,
                                       pos)
            got.append(logits)
        got = torch.cat(got, dim=1)[..., :api.vocab_real]
        full = full[..., :api.vocab_real]
        err = float((got - full).abs().max())
        scale = float(full.abs().max())
    out = {"len": HOLD_LEN, "decode_steps": HOLD_DECODE, "max_abs_err": err,
           "max_abs_logit": scale, "limit": HOLD_REL * scale,
           "finite": bool(torch.isfinite(got).all())}
    if not (out["finite"] and err <= HOLD_REL * scale):
        raise AssertionError(f"{arch}: prefill + decode vs full forward "
                             f"{json.dumps(out)}")
    return out


def ssm_serve(dev, spec: dict) -> dict:
    """One full-width serve of ``spec["arch"]`` at ``spec["layers"]``
    layers (bf16 compute over fp32 params from seed 0) with the launch
    counters checked (no kernel runs: the resident and gather routes attend
    through none), its profile, the greedy hold and the fp32 full-forward
    hold."""
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm

    arch = cut_arch(spec["arch"], spec["layers"])
    api = cfglib.get(arch).api()
    t0 = time.perf_counter()
    params, _ = api.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tm.tree_leaves(params))
    print(f"serve {arch}: {api.cfg.num_layers} layers d_model "
          f"{api.cfg.d_model}, {n_params} params fp32 (init "
          f"{time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats(dev)
    server, rep, launches, _ = serve_run(
        dev, params, paged="auto", arch=arch, n=spec["n"],
        new_tokens=spec["new_tokens"], serve_kw=spec["serve_kw"])
    s = rep.summary()
    gens = [r.max_new_tokens for r in serve_requests(
        api.vocab_real, spec["n"], spec["new_tokens"])]
    got = {r.rid: r.tokens for r in rep.completed}
    if [len(got.get(i, ())) for i in range(spec["n"])] != gens:
        raise AssertionError(f"serve {arch}: token counts {got} vs {gens}")
    if any(launches.values()):
        raise AssertionError(f"serve {arch}: kernels launched {launches}")
    row = {"route": server.paged_route, "tokens_per_s": rep.tokens_per_s,
           "ms_per_decode_step": 1e3 * rep.phase_s["decode"]
           / rep.decode_steps,
           "ttft_p50_s": s["ttft_p50_s"], "decode_steps": rep.decode_steps,
           "joins": rep.joins, "prefill_calls": rep.prefill_calls,
           "phase_s": rep.phase_s, "wall_s": rep.wall_s,
           "tokens": rep.tokens_total, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(f"serve {arch} bf16: {json.dumps(row)}")
    row["profile"] = profile_decode(server, k=1)
    print(f"serve {arch} bf16 profile (1 decode step, "
          f"{server.cfg.slots} slots): {json.dumps(row['profile'])}")
    first = serve_requests(api.vocab_real, spec["n"], spec["new_tokens"])
    batch = server.cfg.prefill_batch
    prompts = torch.as_tensor([list(r.prompt) for r in first[:min(
        batch, server.cfg.slots)]], dtype=torch.int32, device=dev)
    row["greedy"] = greedy_hold(dev, api, params, prompts, got[0],
                                server.cfg.max_seq)
    print(f"serve {arch}: request 0 against a plain token-by-token loop "
          f"{json.dumps(row['greedy'])} (near-tie margin {GREEDY_MARGIN})")
    del server
    row["full_forward"] = full_forward_hold(dev, arch, params)
    print(f"serve {arch}: fp32 prefill + decode vs one full forward "
          f"{json.dumps(row['full_forward'])}")
    row["n_params"] = n_params
    if row["route"] != {"mamba2-1.3b": "resident"}.get(spec["arch"],
                                                        "gather"):
        raise AssertionError(f"serve {arch}: route {row['route']}")
    del params
    torch.cuda.empty_cache()
    return row


def ssm_path(dev, tmp: str) -> dict:
    """Phase 10: mamba2-1.3b at full width, SSM_FULL["layers"] deep,
    trained through the CLI (sync, kernels on, off, witness), its 4-layer
    ring legs, the 7-layer zamba2-7b stale-psum leg, both served at full
    width at cut depths (resident and gather routes), and kernels 1-5 held and timed at the
    mamba ring legs' width, fused_adam at the full leg's D."""
    import gc
    import torch
    from repro_torch import treemath as tm
    from repro_torch.kernels import dispatch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"ssm phase: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          "allocated at its start")
    failures = []
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"ssm phase: {what} took {now - clock[0]:.1f} s")
        clock[0] = now

    out = {"full": full_leg(dev, cut_arch(SSM_ARCH, SSM_FULL["layers"]),
                            SSM_FULL, SSM_FULL_LABEL, failures)}
    lap(f"the {SSM_FULL_LABEL} leg")
    out["ring"] = ring_legs(dev, tmp, failures, arch_id=SSM_ARCH, r=SSM_RING,
                            legs=SSM_LEGS)
    lap("the mamba ring legs")
    from repro_torch import configs as cfglib
    r = HYBRID_RING
    n = cfglib.count_params(cfglib.get(cut_arch(HYBRID_ARCH,
                                                r["layers"])).api())
    print(f"zamba leg: {n} params at {r['layers']} layers; the stale-psum "
          f"ring [{r['stale']}, {r['workers']}, D] takes "
          f"{r['stale'] * r['workers'] * n * 4 / 1e9:.1f} GB fp32")
    out["hybrid"] = ring_legs(dev, tmp, failures, arch_id=HYBRID_ARCH, r=r,
                              legs=HYBRID_LEGS)
    lap("the zamba leg")
    for name, spec in (("mamba", SSM_SERVE), ("zamba", HYBRID_SERVE)):
        try:
            out[f"serve {name}"] = ssm_serve(dev, spec)
        except AssertionError as err:
            failures.append(str(err))
        lap(f"the {name} serve")
    width = tm.padded_size(out["ring"]["n_params"], dispatch.PACK_ALIGN)
    out["lm"] = lm_kernels(dev, width, SSM_RING["workers"])
    out["lm"]["width"] = width
    out["full_adam"] = full_adam_check(dev, tm.padded_size(
        out["full"]["n_params"], dispatch.PACK_ALIGN))
    lap("kernels 1-5 at the mamba widths")
    if failures:
        raise AssertionError("ssm phase: " + "; ".join(failures))
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
    legs = {f"danube {TRAIN_FULL['layers']} layers":
            train["full"]["launches"],
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


def without_profiles(node):
    """A copy of a nest of dicts without its "profile" entries (printed
    on their own lines)."""
    if not isinstance(node, dict):
        return node
    return {k: without_profiles(v) for k, v in node.items() if k != "profile"}


def add_ssm_rows(kernels: list, ssm: dict) -> None:
    """Beside each of kernels 1-5, its times at the mamba ring legs' width
    and its launches on every leg of the state-space phase (the serves
    launch none); fused_adam also over the sync mamba leg's D."""
    legs = {SSM_FULL_LABEL: ssm["full"]["launches"]}
    for part in ("ring", "hybrid"):
        legs.update({f"{ssm[part]['arch']} {name}": row["launches"]
                     for name, row in ssm[part].items()
                     if isinstance(row, dict) and "launches" in row})
    timings, errs = ssm["lm"]["timings"], ssm["lm"]["errs"]
    for entry in kernels:
        name = entry["name"]
        key = {"fused_update": "fused_update.plain"}.get(name, name)
        entry["launches_ssm"] = {
            leg: sum(n for k, n in c.items() if k.split(".")[0] == name)
            for leg, c in legs.items()}
        if f"{key} lm" not in timings:
            continue
        t = timings[f"{key} lm"]
        entry["ssm_width"] = {
            "width": ssm["lm"]["width"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "max_abs_err": errs[key]}
        if name == "fused_adam":
            entry["full_d_ssm"] = ssm["full_adam"]


# -- phase 11: cross-attention -------------------------------------------------

# whisper-base (encoder-decoder, arXiv:2212.04356: 6 + 6 layers, d_model
# 512, 8 heads of 64 over 8 kv heads, d_ff 2,048, vocab 51,872 of which
# 51,865 real, 1,500 frames of 512; 128,633,862 params) and
# llama-3.2-vision-11b (hf:meta-llama/Llama-3.2-11B-Vision: 40 layers,
# d_model 4,096, 32 heads of 128 over 8 kv heads, d_ff 14,336, vocab
# 128,256, a gated cross layer after every 5th over 1,601 x 1,280 patch
# features; 11,473,915,912 params), random weights from seed 0, features
# from numpy. Every cross layer's gate starts at 0, where tanh(0) = 0 keeps
# the features from every token, so the phase makes each init set it to
# CROSS_GATE (``open_gates``): the train CLI's, the witness's and the
# serves' alike.
WHISPER_ARCH = "whisper-base"
VISION_ARCH = "llama-3.2-vision-11b"
CROSS_GATE = 0.5
# paged_attention at the two families' self-attention head shapes (GQA
# groups 1 and 4), 8 slots, wrapped rings, no window; fields as PAGED_GRID.
CROSS_PAGED_GRID = (
    ("whisper-base", (8, 8, 64), 8, 448, 6, 5, (0,)),
    ("llama-3.2-vision-11b", (32, 8, 128), 8, 160, 40, 39, (0,)),
)
# Their timing cases (SERVE_TIMING's fields), mid-run in the serves below:
# whisper 16 pages held (prompt 64 + up to 64 new tokens) at position 96 of
# a 448-row ring (6 layers' blocks, 2.4 MB of K/V a call: a cycle of the
# sets fits the 50 MB L2, so its reads come partly from L2); llama every
# page of a 160-row ring at position 144.
CROSS_TIMING = {
    "whisper-base": dict(heads=(8, 8, 64), t=8, tokens=448, layers=6,
                         held=16, pos=96),
    "llama-3.2-vision-11b": dict(heads=(32, 8, 128), t=8, tokens=160,
                                 layers=40, held=20, pos=144),
}
# whisper at full width and depth through the train CLI: sync, remat, B 8 x
# 448 tokens (Whisper's decoder horizon) over 8 x 1,500 x 512 frames. Its
# ring legs are danube's (TRAIN_LEGS, P = 2, s = 3, B 4) at seq 448 with
# the depth cut to 1 + 1 of 6 + 6 layers: host-bound (~0.45 s a step at 6),
# they took 95 s at full depth, 59.7 s at 3 + 3 (cut to 1 + 1 when the
# FSDP mesh phase joined).
WHISPER_FULL = dict(batch=8, seq=448, steps=4, timed=3, profile=2)
WHISPER_RING = dict(TRAIN_RING, layers=1, seq=448)
# llama-3.2-vision-11b at full width with 5 of 40 layers: one whole group
# (5 self layers, then the cross layer), 2,353,582,081 params (9.4 GB a
# copy).
# Full depth needs params, two moments and gradients, 4 x 45.9 GB, which no
# H100 holds. Sync, remat, B 4 x 512 over 4 x 1,601 x 1,280 features.
VISION_TRAIN = dict(layers=5, batch=4, seq=512, steps=4, timed=3, profile=2)
# The serves, bf16 compute over fp32 params, on the paged route (every self
# layer through paged_attention; the cross K/V ride in each slot's resident
# row): whisper 16 requests over 8 slots, prompts of 64, up to 64 new
# tokens in a 448-row ring; llama at 20 of its 40 layers (cut when the
# FSDP mesh phase joined), 8 requests over 4 slots, prompts of 128, 16-32
# new tokens (its resident row per slot: 4 cross layers x 1,601 x 8 x 128
# x 2 fp32 floats, 52 MB, rewritten each step).
WHISPER_SERVE = dict(arch=WHISPER_ARCH, n=16, new_tokens=(16, 64),
                     serve_kw=dict(prompt_len=64, max_seq=448))
VISION_SERVE = dict(arch=VISION_ARCH, layers=20, n=8, new_tokens=(16, 32),
                    serve_kw=dict(slots=4, prompt_len=128, max_seq=160,
                                  prefill_batch=4))
# The fp32 paged and gather routes on one prefill batch of each serve;
# llama's at 10 of its 40 layers (two groups), as ROUTE_LAYERS cuts danube.
VISION_ROUTE_LAYERS = 10


@contextlib.contextmanager
def open_gates():
    """Within the block every cross layer is initialised with its gate at
    CROSS_GATE (each model init reaches ``transformer._init_cross_layers``)."""
    import torch
    from repro_torch.models import transformer as tr
    init = tr._init_cross_layers

    def opened(gen, cfg, dev):
        layers = init(gen, cfg, dev)
        gate = layers["gate"]
        layers["gate"] = gate._replace(
            value=torch.full_like(gate.value, CROSS_GATE))
        return layers

    tr._init_cross_layers = opened
    try:
        yield
    finally:
        tr._init_cross_layers = init


@contextlib.contextmanager
def expandable_segments():
    """Within the block the caching allocator maps new memory into segments
    that grow in place, so blocks freed by the backward pass cannot strand
    memory that a [D] copy needs. At 2.35 B params the vision leg's fused
    sync pass holds 8 [D] copies (70.2 of the card's 79.2 GiB); with
    fixed segments ~9 GiB stayed reserved in split segments and the eighth
    copy did not fit (PERF.md)."""
    import torch
    set_settings = getattr(torch._C, "_accelerator_setAllocatorSettings",
                           None) or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    set_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        set_settings("expandable_segments:False")


def cross_features(api) -> dict:
    """{feature name: batch-1 shape} of a family's prefill batch
    (``frames`` or ``cross_feats``)."""
    from repro_torch.configs.base import InputShape
    spec = api.batch_spec(InputShape("serve", 1, 1, "prefill"))
    return {k: shape for k, (shape, _) in spec.items() if k != "tokens"}


def decoder_layers(api) -> int:
    cfg = api.cfg.decoder_cfg() if api.family == "encdec" else api.cfg
    return cfg.num_layers


def cross_serve(dev, spec: dict) -> dict:
    """One full-width serve of ``spec["arch"]`` on the paged route (bf16
    compute over fp32 params from seed 0, gates open), each request with
    its own features: the launch count (paged_attention once a self layer
    a decode step, no other kernel), its profile, the greedy hold, the
    fp32 full-forward hold, and the fp32 paged and gather routes on one
    prefill batch (llama at VISION_ROUTE_LAYERS layers)."""
    import numpy as np
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm

    arch = (cut_arch(spec["arch"], spec["layers"]) if "layers" in spec
            else spec["arch"])
    api = cfglib.get(arch).api()
    t0 = time.perf_counter()
    params, _ = api.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tm.tree_leaves(params))
    layers = decoder_layers(api)
    feats = cross_features(api)
    print(f"serve {arch}: {layers} decoder layers, {n_params} params fp32 "
          f"(init {time.perf_counter() - t0:.1f} s), features {feats}, "
          f"gates {CROSS_GATE}")
    torch.cuda.reset_peak_memory_stats(dev)
    kw = dict(arch=arch, n=spec["n"], new_tokens=spec["new_tokens"],
              serve_kw=spec["serve_kw"], features=feats)
    server, rep, launches, _ = serve_run(dev, params, paged="auto", **kw)
    s = rep.summary()
    cfg = server.cfg
    reqs = serve_requests(api.vocab_real, spec["n"], spec["new_tokens"],
                          prompt_len=cfg.prompt_len, features=feats)
    gens = [r.max_new_tokens for r in reqs]
    got = {r.rid: r.tokens for r in rep.completed}
    if [len(got.get(i, ())) for i in range(spec["n"])] != gens:
        raise AssertionError(f"serve {arch}: token counts {got} vs {gens}")
    if not all(0 <= t < api.vocab_real for toks in got.values()
               for t in toks):
        raise AssertionError(f"serve {arch}: token outside the vocab")
    others = {k: v for k, v in launches.items()
              if k != "paged_attention" and v}
    want = layers * rep.decode_steps
    if server.paged_route != "paged" or launches["paged_attention"] != want \
            or others:
        raise AssertionError(f"serve {arch}: route {server.paged_route}, "
                             f"launches {launches}, expected "
                             f"paged_attention={want} and no other")
    row = {"route": server.paged_route, "tokens_per_s": rep.tokens_per_s,
           "ms_per_decode_step": 1e3 * rep.phase_s["decode"]
           / rep.decode_steps,
           "ttft_p50_s": s["ttft_p50_s"], "decode_steps": rep.decode_steps,
           "joins": rep.joins, "prefill_calls": rep.prefill_calls,
           "phase_s": rep.phase_s, "wall_s": rep.wall_s,
           "tokens": rep.tokens_total, "launches": launches,
           "resident_floats_per_slot": server.layout.res_width,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print(f"serve {arch} bf16 paged: {json.dumps(row)}")
    row["profile"] = profile_decode(server, k=2, features=feats)
    print(f"serve {arch} bf16 profile (2 decode steps, {cfg.slots} slots): "
          f"{json.dumps(row['profile'])}")
    first = reqs[:min(cfg.prefill_batch, cfg.slots)]
    prompts = torch.as_tensor(np.stack([r.prompt for r in first]),
                              dtype=torch.int32, device=dev)
    spec_b = api.batch_spec(server._pshape)
    batch_feats = {k: torch.as_tensor(np.concatenate(
        [r.features[k] for r in first])).to(dev, spec_b[k][1]) for k in feats}
    row["greedy"] = greedy_hold(dev, api, params, prompts, got[0],
                                cfg.max_seq, features=batch_feats)
    print(f"serve {arch}: request 0 against a plain token-by-token loop "
          f"{json.dumps(row['greedy'])} (near-tie margin {GREEDY_MARGIN})")
    del server, batch_feats
    row["full_forward"] = full_forward_hold(dev, arch, params)
    print(f"serve {arch}: fp32 prefill + decode vs one full forward "
          f"{json.dumps(row['full_forward'])}")
    over = {"dtype": torch.float32}
    if api.family == "transformer":
        over["num_layers"] = VISION_ROUTE_LAYERS
    route_layers = over.get("num_layers", layers)
    route_kw = dict(kw, n=cfg.slots, record=True, overrides=over)
    runs = {}
    for mode in ("on", "off"):
        srv, rrep, rl, steps = serve_run(dev, params, paged=mode, **route_kw)
        want = route_layers * rrep.decode_steps if mode == "on" else 0
        if rl["paged_attention"] != want or any(
                v for k, v in rl.items() if k != "paged_attention"):
            raise AssertionError(f"serve {arch} fp32 paged={mode}: launches "
                                 f"{rl}, expected paged_attention={want}")
        runs[mode] = (srv.layout.tokens, rrep, steps, rl)
        del srv
    row["routes"] = compare_routes(
        f"{arch} fp32, {route_layers} layers", runs["on"][1], runs["on"][2],
        runs["off"][1], runs["off"][2], runs["on"][0],
        prompt_len=cfg.prompt_len)
    row["routes"]["layers"] = route_layers
    row["route_launches"] = {"paged": runs["on"][3],
                             "gather": runs["off"][3]}
    row["n_params"] = n_params
    del params, runs
    torch.cuda.empty_cache()
    return row


def cross_path(dev, tmp: str) -> dict:
    """Phase 11: paged_attention held and timed at the two families' head
    shapes; whisper-base at full width and depth trained through the CLI
    (sync, kernels on, off, witness) and its ring legs; llama-3.2-vision-11b
    at 5 of 40 layers trained in sync; both served at full width on the
    paged route (llama at VISION_SERVE["layers"]). Every cross gate opens
    at CROSS_GATE."""
    import gc
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"cross phase: {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          "allocated at its start")
    failures = []
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"cross phase: {what} took {now - clock[0]:.1f} s")
        clock[0] = now

    out = {"paged_errs": paged_kernel_checks(dev, CROSS_PAGED_GRID)["by_shape"]}
    out["paged_timings"] = {}
    for arch, case in CROSS_TIMING.items():
        out["paged_timings"].update(paged_timings(
            dev, case, name=f"paged_attention {arch}"))
    lap("paged_attention at the two head shapes")
    with open_gates():
        out["whisper full"] = full_leg(dev, WHISPER_ARCH, WHISPER_FULL,
                                       "full whisper", failures)
        lap("the full whisper leg")
        out["whisper ring"] = ring_legs(dev, tmp, failures,
                                        arch_id=WHISPER_ARCH, r=WHISPER_RING,
                                        legs=TRAIN_LEGS)
        lap("the whisper ring legs")
        out["vision"] = vision_leg(dev, failures)
        lap("the vision leg")
        for name, spec in (("whisper", WHISPER_SERVE),
                           ("vision", VISION_SERVE)):
            try:
                out[f"serve {name}"] = cross_serve(dev, spec)
            except AssertionError as err:
                failures.append(str(err))
            lap(f"the {name} serve")
    if failures:
        raise AssertionError("cross phase: " + "; ".join(failures))
    return out


def vision_leg(dev, failures: list) -> dict:
    """llama-3.2-vision-11b at full width, VISION_TRAIN["layers"] deep,
    through the train CLI in sync (``full_leg``)."""
    from repro_torch import configs as cfglib
    vision = cut_arch(VISION_ARCH, VISION_TRAIN["layers"])
    n = cfglib.count_params(cfglib.get(vision).api())
    print(f"vision leg: {n} params at {VISION_TRAIN['layers']} layers "
          f"({n * 4 / 1e9:.1f} GB a fp32 copy)")
    with expandable_segments():
        return full_leg(dev, vision, VISION_TRAIN,
                        f"vision {VISION_TRAIN['layers']} layers", failures)


def add_cross_rows(kernels: list, cross: dict) -> None:
    """Beside each kernel, its launches on every run of the cross phase;
    beside paged_attention, its times and errors at the two head shapes."""
    legs = {"full whisper": cross["whisper full"]["launches"],
            "vision": cross["vision"]["launches"]}
    ring = cross["whisper ring"]
    legs.update({f"{ring['arch']} {name}": row["launches"]
                 for name, row in ring.items()
                 if isinstance(row, dict) and "launches" in row})
    for name in ("whisper", "vision"):
        serve = cross[f"serve {name}"]
        legs[f"serve {name} bf16 paged"] = serve["launches"]
        for route, c in serve["route_launches"].items():
            legs[f"serve {name} fp32 {route}"] = c
    for entry in kernels:
        name = entry["name"]
        entry["launches_cross"] = {
            leg: sum(n for k, n in c.items() if k.split(".")[0] == name)
            for leg, c in legs.items()}
        if name == "paged_attention":
            entry["cross_shapes"] = {
                arch: dict({k: cross["paged_timings"][
                    f"paged_attention {arch}"][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "bf16_wrapper_ms")},
                    max_abs_err=cross["paged_errs"][arch]["fp32"],
                    max_abs_err_bf16=cross["paged_errs"][arch]["bf16"])
                for arch in CROSS_TIMING}


# -- the rank processes of the mesh phases -------------------------------------------

# Phases 12-15 each run a rank program in two processes on the one card
# over gloo (``--mesh-rank``, ``--serve-mesh-rank``, ``--fsdp-mesh-rank``,
# ``--tp-mesh-rank``). A fresh process pays ~7 s for ``import torch`` and
# ~3.5 s more for ``torch.distributed.tensor`` on the H100 machine's host,
# so the script starts POOL_RANKS rank processes once (``--rank-worker``),
# as it starts: they import what the rank programs use while the first
# phases run (touching no CUDA until their first job), then run the
# phases' rank programs one job at a time, each as a process of its own
# would. A job that fails to end in time, or a process that dies, retires
# the pool; the next phase starts another.
POOL_RANKS = 2
GLOO_DEVICES = "lo,lo,lo,lo"
_POOL: list = []


def rank_program(argv: list) -> int:
    """Run the rank program ``argv`` (``[FLAG, R, WORLD, PORT, ...]``) in
    this process."""
    global MESH_SERVE_LAYERS
    flag, args = argv[0], argv[1:]
    ints = list(map(int, args[:3]))
    if flag == "--mesh-rank":
        return mesh_rank(*ints, *args[3:5])
    if flag == "--serve-mesh-rank":
        if args[5:6]:
            MESH_SERVE_LAYERS = int(args[5])        # the parent's depth
        return serve_mesh_rank(*ints, *args[3:5])
    if flag == "--fsdp-mesh-rank":
        return fsdp_mesh_rank(*ints, *args[3:5])
    if flag == "--tp-mesh-rank":
        return tp_mesh_rank(*ints, *args[3:])
    raise ValueError(f"no rank program {flag}")


def rank_worker(rank: int, pool_dir: str) -> int:
    """``--rank-worker R DIR``: process R of the rank pool. Imports what
    the rank programs use, then runs job k = 0, 1, ... as ``DIR/job<k>
    .json`` appears (``{"argvs": [argv a rank], "logs": [path or null a
    rank]}``, ``{"argvs": null}`` to stop; with a log, the job's output
    goes there) and writes ``DIR/done<k>_<R>.json`` (``{"rc": ...}``).
    Every job starts from the torch settings the process started with."""
    import traceback
    import torch
    import torch.distributed.tensor  # noqa: F401 (the imports, ahead)
    import repro_torch.engine.placement  # noqa: F401
    import repro_torch.launch.train  # noqa: F401
    import repro_torch.serving  # noqa: F401
    settings = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cuda.matmul.allow_tf32)
    parent = os.getppid()
    for k in itertools.count():
        path = os.path.join(pool_dir, f"job{k}.json")
        while not os.path.exists(path):
            if os.getppid() != parent:
                return 1                    # the script is gone
            time.sleep(0.02)
        with open(path) as f:
            job = json.load(f)
        if job["argvs"] is None:
            return 0
        log, saved = job["logs"][rank], None
        if log:
            saved = (os.dup(1), os.dup(2))
            fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            os.close(fd)
        try:
            rc = rank_program(job["argvs"][rank])
        except BaseException:           # noqa: BLE001 (reported as rc 1)
            traceback.print_exc()
            rc = 1
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            if saved:
                for fd, old in ((1, saved[0]), (2, saved[1])):
                    os.dup2(old, fd)
                    os.close(old)
            torch.use_deterministic_algorithms(settings[0],
                                               warn_only=settings[1])
            torch.backends.cuda.matmul.allow_tf32 = settings[2]
            if torch.cuda.is_initialized():
                release_memory()
        _write_json(os.path.join(pool_dir, f"done{k}_{rank}.json"),
                    {"rc": rc})


def _write_json(path: str, obj) -> None:
    """``obj`` to ``path`` in one rename, so a reader sees all or none."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


class RankPool:
    """POOL_RANKS ``--rank-worker`` processes and their job directory."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_pool_")
        self.jobs = 0
        # Four gloo devices on the loopback (the ranks share one host):
        # gloo runs the pieces of a large gather on them side by side.
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME",
                                                     GLOO_DEVICES))
        sys.stdout.flush()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             str(r), self.dir], env=env) for r in range(POOL_RANKS)]

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def run(self, argvs: list, timeout: float, capture: bool) -> list:
        """Rank r runs ``argvs[r]``: ``[(returncode, log)]`` a rank (the
        log "" unless ``capture``; the returncode None where the job did
        not end within ``timeout`` seconds or the process died, and the
        pool is then stopped)."""
        if len(argvs) != len(self.procs):
            raise ValueError(f"{len(argvs)} ranks on a pool of "
                             f"{len(self.procs)}")
        k, self.jobs = self.jobs, self.jobs + 1
        logs = [os.path.join(self.dir, f"log{k}_{r}.txt") if capture
                else None for r in range(len(argvs))]
        sys.stdout.flush()
        _write_json(os.path.join(self.dir, f"job{k}.json"),
                    {"argvs": argvs, "logs": logs})
        rcs = [None] * len(argvs)
        deadline = time.monotonic() + timeout
        while None in rcs and time.monotonic() < deadline:
            for r, rc in enumerate(rcs):
                done = os.path.join(self.dir, f"done{k}_{r}.json")
                if rc is None and os.path.exists(done):
                    with open(done) as f:
                        rcs[r] = json.load(f)["rc"]
            if None in rcs and not self.alive():
                break
            time.sleep(0.02)
        if None in rcs:
            self.stop(kill=True)
        texts = []
        for log in logs:
            texts.append("")
            if log and os.path.exists(log):
                with open(log) as f:
                    texts[-1] = f.read()
        return list(zip(rcs, texts))

    def stop(self, kill: bool = False) -> None:
        """Ask the workers to stop (``kill``: kill them), kill any left,
        and drop the pool."""
        _write_json(os.path.join(self.dir, f"job{self.jobs}.json"),
                    {"argvs": None})
        for p in self.procs:
            if not kill:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)
        if self in _POOL:
            _POOL.remove(self)


def rank_pool() -> RankPool:
    """The running pool, started here if there is none or it retired."""
    if _POOL and not _POOL[0].alive():
        _POOL[0].stop(kill=True)
    if not _POOL:
        _POOL.append(RankPool())
    return _POOL[0]


def stop_rank_pool() -> None:
    for pool in list(_POOL):
        pool.stop()


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(flag: str, world: int, *args: str, timeout: float,
              capture: bool = False) -> list:
    """``FLAG R WORLD PORT *args`` on every rank R of the pool, over a
    free port: ``[(returncode, log)]`` a rank (``RankPool.run``)."""
    port = free_port()
    return rank_pool().run([[flag, str(r), str(world), str(port), *args]
                            for r in range(world)], timeout, capture)


# -- phase 12: the mesh path ------------------------------------------------------

# The DNN legs over a DeviceMesh: (name, mode, optimizer, compensation
# knobs, exact, launches a step on every rank). ``exact``: the mesh gathers
# the crossing rows and reduces them in the one-process order, so the run
# must equal the one-process run bit for bit; sync's all-reduce averages
# the two ranks' half-batch gradients in another order than one backward,
# so it is held to MESH_SYNC_TOL.
MESH_LEGS = (
    ("simulate adam", "simulate", "adam", {}, True,
     dict(stale_accum=1, fused_adam=1)),
    ("stale-psum adam", "stale-psum", "adam", {}, True,
     dict(fused_update_plain=1)),
    ("stale-psum sgd topk", "stale-psum", "sgd", dict(compress="topk:0.1"),
     True, dict(sparsify_topk=1, stale_accum=1)),
    ("sync adam", "sync", "adam", {}, False, dict(fused_adam=1)),
)
MESH_RANKS, MESH_TIMED, MESH_PROFILE = 2, 10, 5
# The two-rank sync leg against the one-process run, about 10x its sound
# readings on the H100 (loss 1.19e-7, param 6.67e-6, rel 2.09e-7, the same
# on five runs; PERF.md). The phase also runs the leg with the ranks'
# all_reduce dropped (each rank steps on its own half-batch) and fails
# unless that planted fault parts past this limit.
MESH_SYNC_TOL = dict(loss=1e-6, param=1e-4, rel=2e-6)
MESH_SYNC_LEG = MESH_LEGS[3]
PLANTED = "sync adam, all_reduce dropped"
COLLECTIVES = ("all_gather", "allgather", "all_reduce", "allreduce",
               "broadcast", "reduce_scatter", "all_to_all", "alltoall")


def mesh_run(dev, leg, params0, data, table, mesh=None, *, steps=STEPS,
             timed_steps=MESH_TIMED, profile=0, plant=False) -> dict:
    """One DNN leg through ``build_engine(mesh=)`` with kernels on: the
    launch counters zeroed just before ``steps`` steps and read just after,
    then ``timed_steps`` steps on the host clock and ``profile`` steps
    under the profiler, whose collective ops give their share of a step.
    Every rank calls it alike (the eval view and the gathers are
    collectives). ``plant`` builds the engine with the data ranks' mean
    made the identity (no all_reduce: each rank steps on its own
    half-batch), the fault MESH_SYNC_TOL must catch."""
    import torch
    from repro_torch import delays
    from repro_torch import treemath as tm
    from repro_torch.data import ShardedBatches
    from repro_torch.engine import EngineConfig, build_engine
    from repro_torch.engine.placement import MeshPlacement
    from repro_torch.models import mlp
    from repro_torch.optim import paper_default

    _, mode, algo, knobs = leg[:4]
    delay_kw = {} if mode == "sync" else dict(delay=delays.Schedule(table))
    cfg = EngineConfig(mode=mode, num_workers=WORKERS, s=STALENESS,
                       kernels="on", **delay_kw, **knobs)
    real_mean = MeshPlacement.mean
    if plant:
        # The step binds the placement's mean when it is built.
        MeshPlacement.mean = lambda self, x, split=True: x
    try:
        engine = build_engine(mlp.loss_fn, paper_default(algo), cfg,
                              mesh=mesh, device=dev)
    finally:
        MeshPlacement.mean = real_mean
    src = ShardedBatches([data.x_train, data.y_train], WORKERS, BATCH, seed=0)
    batches = iter(src) if mode == "simulate" else src.flat_iter()
    state = engine.init(0, params=tm.tree_map(torch.clone, params0))
    losses = []
    reset_counters()
    for _ in range(steps):
        state, m = engine.step(state, next(batches))
        losses.append(m["loss"])
    launches = counters()
    out = {"losses": torch.stack(losses).cpu(), "launches": launches,
           "params": tm.tree_map(lambda x: x.detach().cpu(),
                                 engine.params(state))}
    if mode == "simulate":
        caches = state.inner.caches
        if engine.placement is not None:
            caches = engine.placement.gather_tree(caches)
        out["workers"] = tm.tree_map(lambda x: x.detach().cpu(), caches)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, _ = engine.step(state, next(batches))
    sync()
    out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / max(timed_steps, 1)
    if profile:
        out["collectives"] = profile_collectives(engine, state, batches,
                                                 profile, sync)
    return out


def profile_collectives(engine, state, batches, k: int, sync, warm=True,
                        keep=None) -> dict:
    """``k`` steps under the profiler, each collective the placement calls
    inside a ``record_function`` range (``mesh.all_gather`` and so on: the
    call and its wait, which c10d's own ops leave out), after one step that
    warms the profiler up. Each range opens after a device synchronize, so
    it holds the collective alone (gloo's copy of the CUDA tensors to the
    host, the exchange, the copy back), not the drain of the kernels the
    step queued before it. Returns each range's host ms a step and its
    share of the step's wall time, the synchronizes included. The profiler
    traces the host only: gloo blocks the calling thread until a
    collective of CUDA tensors is done, and with CUDA activity traced too
    these ranges read no host time on the H100 (PERF.md). ``warm=False``
    skips the warm-up step (a step of seconds does not feel the profiler's
    start); ``keep`` (a list) gets the last step's state and metrics."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    class Timed:
        """The placement's ``torch.distributed``, its collectives in
        ranges."""

        def __init__(self, dist):
            self.dist = dist

        def __getattr__(self, name):
            fn = getattr(self.dist, name)
            if name not in ("all_gather", "all_reduce", "broadcast",
                            "all_to_all_single"):
                return fn

            def timed(*a, **kw):
                sync()
                with record_function(f"mesh.{name}"):
                    work = fn(*a, **kw)
                return work if work is None else Waited(work, name)
            return timed

    class Waited:
        """An async collective's handle whose wait is a range too."""

        def __init__(self, work, name):
            self.work, self.name = work, name

        def wait(self):
            with record_function(f"mesh.{self.name} wait"):
                return self.work.wait()

    place = engine.placement
    place.dist = Timed(place.dist)
    for axis in (getattr(place, "data_axis", None),
                 getattr(place, "model_axis", None)):
        if axis is not None:
            # The gathers of the FSDP and model axes (and the backward's
            # reduce-scatters) call the axis's torch.distributed.
            axis.dist = Timed(axis.dist)
    acts = [ProfilerActivity.CPU]
    if warm:
        with torch_profile(activities=acts):
            state, _ = engine.step(state, next(batches))
            sync()
    sync()
    t0 = time.perf_counter()
    with torch_profile(activities=acts) as prof:
        for _ in range(k):
            state, m = engine.step(state, next(batches))
        sync()
    wall = (time.perf_counter() - t0) * 1e3 / k
    if keep is not None:
        keep.append((state, m))
    del state
    rows = {}
    for e in prof.key_averages():
        if e.key.startswith("mesh.") or any(c in e.key.lower()
                                            for c in COLLECTIVES):
            ms = e.cpu_time_total / 1e3 / k
            rows[e.key] = {"ms_per_step": ms, "calls_per_step": e.count / k,
                           "share": ms / wall}
    return {"wall_ms_per_step": wall, "ops": rows}


def mesh_rank(rank: int, world: int, port: int, out_dir: str,
              device: str = "cuda") -> int:
    """``--mesh-rank R WORLD PORT DIR [DEVICE]``: one rank of the two-rank
    leg on the one card, over ``gloo`` (NCCL refuses two ranks on one
    device). Runs every MESH_LEGS leg on a ``world x 1`` mesh and saves the
    runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mlp
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        build.library()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(world, 1, device=dev.type)
        table, data = mesh_inputs()
        params0 = mlp.init(0, mlp.MLPConfig(depth=DEPTH), device=dev)
        runs = {}
        for leg in MESH_LEGS:
            try:
                # Every rank profiles too: the ranks must make the same
                # collective calls.
                runs[leg[0]] = mesh_run(dev, leg, params0, data, table, mesh,
                                        profile=MESH_PROFILE)
            except Exception as e:      # noqa: BLE001 (reported, then raised)
                runs[leg[0]] = {"error": f"{type(e).__name__}: {e}"}
                raise
            finally:
                torch.save(runs, os.path.join(out_dir, f"rank{rank}.pt"))
        runs[PLANTED] = mesh_run(dev, MESH_SYNC_LEG, params0, data, table,
                                 mesh, timed_steps=0, plant=True)
        torch.save(runs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def mesh_inputs():
    """The DNN legs' delay table and data (the ring path's)."""
    import numpy as np
    from repro_torch.data import synthetic
    table = np.random.default_rng(0).integers(0, STALENESS, (STEPS, WORKERS))
    table[0, 0] = STALENESS - 1
    return table, synthetic.teacher_classification(seed=0)


def same_bits(a, b) -> bool:
    import torch
    from repro_torch import treemath as tm
    la, lb = tm.tree_leaves(a), tm.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def mesh_path(dev) -> dict:
    """Phase 12: the DNN legs (D = 335,114, P = 8, s = 16, one [50, 8]
    Schedule) through ``build_engine(mesh=)``: (a) on a 1x1 mesh over a
    one-rank ``nccl`` group, bit for bit as the mesh-less run with the same
    launch counts; (b) two ranks on the one card over ``gloo`` at data = 2,
    each rank's launch counts checked, against the one-process run as the
    CPU tests hold it (MESH_LEGS)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for, make_host_mesh
    from repro_torch.models import mlp

    t0 = time.perf_counter()
    if dev.type == "cuda":
        # The two rank processes share the card: hand back what the earlier
        # phases' caching allocator still holds.
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    table, data = mesh_inputs()
    params0 = mlp.init(0, mlp.MLPConfig(depth=DEPTH), device=dev)
    failures, out = [], {}

    plain = {leg[0]: mesh_run(dev, leg, params0, data, table)
             for leg in MESH_LEGS}
    backend = backend_for(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=dev.type)
        for leg in MESH_LEGS:
            name, per_step = leg[0], leg[5]
            one = mesh_run(dev, leg, params0, data, table, mesh)
            ref = plain[name]
            bitwise = (same_bits(one["params"], ref["params"])
                       and torch.equal(one["losses"], ref["losses"])
                       and same_bits(one.get("workers", {}),
                                     ref.get("workers", {})))
            want = expect(STEPS, **per_step)
            print(f"mesh 1x1 {backend} {name}: bitwise {bitwise}; launches "
                  f"{one['launches']} (mesh-less {ref['launches']}); "
                  f"ms_per_step {one['ms_per_step']!r} (mesh-less "
                  f"{ref['ms_per_step']!r})")
            if not bitwise:
                failures.append(f"1x1 {name}: not bitwise")
            if one["launches"] != ref["launches"] or one["launches"] != want:
                failures.append(f"1x1 {name}: launches {one['launches']} vs "
                                f"{ref['launches']} (expected {want})")
            out[f"1x1 {name}"] = {"bitwise": bitwise,
                                  "launches": one["launches"],
                                  "ms_per_step": one["ms_per_step"],
                                  "mesh_less_ms_per_step":
                                      ref["ms_per_step"]}
    finally:
        dist.destroy_process_group()
    print(f"mesh phase: 1x1 legs took {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        done = run_ranks("--mesh-rank", MESH_RANKS, tmp, dev.type,
                         timeout=240, capture=True)
        ranks = []
        for r, (rc, log) in enumerate(done):
            path = os.path.join(tmp, f"rank{r}.pt")
            ranks.append(torch.load(path, weights_only=False)
                         if os.path.exists(path) else {})
            if rc != 0:
                tail = log.strip().splitlines()[-12:]
                print(f"mesh rank {r} exited {rc}:\n  " + "\n  ".join(tail))
                failures.append(f"two-rank gloo leg: rank {r} exited {rc}")
    for leg in MESH_LEGS:
        name, exact, per_step = leg[0], leg[4], leg[5]
        ref = plain[name]
        want = expect(STEPS, **per_step)
        for r, runs in enumerate(ranks):
            run = runs.get(name)
            if run is None or "error" in run:
                msg = run["error"] if run else "no result"
                print(f"mesh 2x1 gloo {name} rank {r}: {msg}")
                failures.append(f"2x1 {name} rank {r}: {msg}")
                continue
            bitwise = (same_bits(run["params"], ref["params"])
                       and torch.equal(run["losses"], ref["losses"])
                       and same_bits(run.get("workers", {}),
                                     ref.get("workers", {})))
            dist_ = run_distance(run, ref)
            print(f"mesh 2x1 gloo {name} rank {r}: bitwise {bitwise}; "
                  f"distance {json.dumps(dist_)}; launches "
                  f"{run['launches']} (expected {want}); ms_per_step "
                  f"{run['ms_per_step']!r}")
            if exact and not bitwise:
                failures.append(f"2x1 {name} rank {r}: not bitwise")
            if not exact and any(dist_[k] > v
                                 for k, v in MESH_SYNC_TOL.items()):
                failures.append(f"2x1 {name} rank {r}: {dist_} over "
                                f"{MESH_SYNC_TOL}")
            if run["launches"] != want:
                failures.append(f"2x1 {name} rank {r}: launches "
                                f"{run['launches']} != {want}")
            if "collectives" in run and r == 0:
                print(f"mesh 2x1 gloo {name} rank {r} profile: "
                      f"{json.dumps(run['collectives'])}")
            out[f"2x1 {name} rank {r}"] = {
                "bitwise": bitwise, "distance": dist_,
                "launches": run["launches"],
                "ms_per_step": run["ms_per_step"],
                "collectives": run.get("collectives")}
    for r, runs in enumerate(ranks):
        run = runs.get(PLANTED)
        if run is None:
            failures.append(f"2x1 {PLANTED} rank {r}: no result")
            continue
        dist_ = run_distance(run, plain[MESH_SYNC_LEG[0]])
        caught = [k for k, v in MESH_SYNC_TOL.items() if dist_[k] > v]
        print(f"mesh 2x1 gloo {PLANTED} rank {r} (planted fault): distance "
              f"{json.dumps(dist_)}; over {MESH_SYNC_TOL} on {caught}")
        if not caught:
            failures.append(f"2x1 {PLANTED} rank {r}: the planted fault "
                            f"stays within {MESH_SYNC_TOL}")
        out[f"2x1 {PLANTED} rank {r}"] = {"distance": dist_, "caught": caught}
    print(f"mesh phase: two-rank legs took {time.perf_counter() - t1:.1f} s; "
          f"the phase {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("mesh phase: " + "; ".join(failures))
    return out


def add_mesh_rows(kernels: list, mesh: dict) -> None:
    """Beside each kernel, its launches on every leg of the mesh phase (the
    planted fault's run is not one)."""
    for entry in kernels:
        name = entry["name"]
        entry["launches_mesh"] = {
            leg: sum(n for k, n in row["launches"].items()
                     if k.split(".")[0] == name)
            for leg, row in mesh.items() if "launches" in row}


# -- phase 13: serving on a mesh --------------------------------------------------

# The full-width danube serve at MESH_SERVE_LAYERS layers (SERVE: 8 slots,
# prompts of 128, bf16 compute over fp32 params, paged route "on") at
# snapshot 1, one warm-up request of MESH_SERVE["warm_tokens"] tokens (its
# decode steps put the server's step count past 0), then MESH_SERVE["n"]
# requests with a refresher polling every MESH_SERVE["every"] decode steps
# of a directory that also holds snapshot 2: the swap lands mid-serve, at
# decode step ``every``. Snapshot k is the arch's init from seed k.
# Legs: mesh-less (the reference), handed snapshot 1's params as the
# publisher made them, its picks recorded (``Forcing``); its one-ulp
# witness, handed both snapshots nudged one ulp up and fed the reference's
# tokens (teacher-forced), whose gap sets the limits below; on a 1x1 mesh
# over a one-rank nccl group, handed snapshot 1 too, with a refresher that
# never swaps (its tokens before the reference's swap are the ones
# compared: a refresh restore there would prove nothing the two ranks do
# not); two gloo ranks on the one card at 1x2, which boot through
# ``restore_params`` (each rank reads its shards of the model axis), serve
# those shards tensor-parallel (mixed attention: a rank's 16 q heads and
# the 4 kv heads they read, its page pool holding those 4) and swap in
# snapshot 2's shards mid-serve: once unrecorded (the readings: ms a decode
# step, tokens equal up to a near-tie) and once teacher-forced with the
# reference's tokens (the logits); then on those ranks the boot's shards
# with the model axis's ``reduce`` dropped (each rank keeps its partial
# sums), whose logits on the snapshot-1 tokens must part past the limit.
# Last, on the same ranks, the gathered route, which a family the model
# axis cannot compute tensor-parallel takes (GATHERED_SERVE): booted and
# refreshed through ``restore_params`` like the danube, each load made
# whole by the placement's ``all_gather``, its tokens and stamps bit for
# bit its mesh-less run's; then booted again with a gather that delivers
# nothing (``NoGather``), whose snapshot-1 tokens must part.
MESH_SERVE = dict(n=8, new_tokens=(16, 32), warm_tokens=3, every=8)
MESH_SERVE_RANKS = 2
# The danube's depth in this phase: 24 (full) until the FSDP mesh phase
# joined, then 6 of 24 to fit the run (every width kept).
MESH_SERVE_LAYERS = 6
# The gathered route's serve: whisper-base at full width and depth
# (phase 11's serve: prompts of 64 beside each request's own frames) on
# the paged route ("on": the model axis's veto overridden, so the ranks
# take the mesh-less run's route), 8 requests of 8-12 new tokens, the swap
# at decode step 4.
GATHERED_SERVE = dict(arch=WHISPER_ARCH, n=8, new_tokens=(8, 12), every=4,
                      paged="on", serve_kw=WHISPER_SERVE["serve_kw"])
# A tensor-parallel serve's limits, from its one-ulp witness as the
# training legs take theirs (WITNESS_FACTOR): its teacher-forced logits
# within WITNESS_FACTOR times the witness's largest gap, both relative to
# the reference's largest |logit|, never below SERVE_FLOOR nor above
# SERVE_CEILING however far the witness parts; its own picks the
# reference's up to the first near-tie, a reference top-2 margin below
# WITNESS_FACTOR times the witness's largest gap in logits (that gap
# capped at SERVE_CEILING of the largest |logit|), and, the run being
# teacher-forced, at every later step whose margin is not a near-tie.
# bf16 logits of size ~4 take steps of 2^-6, so many steps are near-ties.
SERVE_FLOOR, SERVE_CEILING = 1e-5, 0.05


def tp_serve_spec() -> dict:
    """Phase 13's tensor-parallel serve: the danube cut to
    MESH_SERVE_LAYERS (registered in this process, as each rank process
    registers it), on the paged route."""
    return dict(arch=cut_arch(SERVE_ARCH, MESH_SERVE_LAYERS), paged="on",
                n=MESH_SERVE["n"], new_tokens=MESH_SERVE["new_tokens"],
                every=MESH_SERVE["every"], serve_kw={})


def gathered_serve_spec() -> dict:
    """Phase 13's gathered serve (GATHERED_SERVE)."""
    return dict(GATHERED_SERVE)


def serve_dirs(tmp: str, spec: dict) -> dict:
    """Where a spec's snapshots live under ``tmp``: a boot restores the
    latest of ``boot``, the refresher polls ``live``."""
    return {k: os.path.join(tmp, spec["arch"], k) for k in ("boot", "live")}


def publish_snapshots(dev, tmp: str, spec: dict):
    """Snapshots 2 and 1 of the spec's arch in ``live``, snapshot 1 also
    in ``boot`` (a hard link; ``serve_dirs``). Returns the directories and
    both snapshots' params."""
    from repro_torch import configs as cfglib
    from repro_torch.checkpoint import checkpoint as ckpt
    api = cfglib.get(spec["arch"]).api(reduced=False)
    dirs = serve_dirs(tmp, spec)
    os.makedirs(dirs["boot"], exist_ok=True)
    t0 = time.perf_counter()
    params = {}
    for step in (2, 1):
        params[step], _ = api.init(step, device=dev)
        ckpt.save(ckpt.step_path(dirs["live"], step), params[step],
                  step=step, extra={"published_at": time.time()})
    for suffix in (".npz", ".meta.json"):
        os.link(os.path.join(dirs["live"], "step_1" + suffix),
                os.path.join(dirs["boot"], "step_1" + suffix))
    print(f"serve mesh phase: two snapshots of {spec['arch']} written "
          f"in {time.perf_counter() - t0:.1f} s")
    return dirs, params[1], params[2]


class NoGather:
    """``torch.distributed``, but ``all_gather`` delivers nothing: every
    part but the caller's own stays zeros (the planted gather fault)."""

    def __getattr__(self, name):
        import torch.distributed as dist
        return getattr(dist, name)

    def all_gather(self, parts, x, group=None, async_op=False):
        import torch.distributed as dist
        me = dist.get_group_rank(group, dist.get_rank())
        for i, part in enumerate(parts):
            part.copy_(x) if i == me else part.zero_()
        return Done() if async_op else None


class Done:
    """A collective's handle that has nothing left to wait for."""

    def wait(self):
        return True


def mesh_server(dev, spec: dict, mesh=None, params=None):
    from repro_torch.serving import Server, ServingConfig
    return Server(ServingConfig(arch=spec["arch"], reduced=False,
                                paged=spec["paged"],
                                **{**SERVE, **spec["serve_kw"]}),
                  params=params, device=dev, mesh=mesh)


def tree_gb(tree) -> float:
    from repro_torch import treemath as tm
    return sum(x.numel() * x.element_size()
               for x in tm.tree_leaves(tree)) / 1e9


def mesh_serve_stream(server, dev, spec: dict, refresh_dir=None, boot=1,
                      every=None, force=None, load=None,
                      record=True) -> tuple:
    """The warm-up request, then the spec's requests (a refresher on
    ``refresh_dir`` from step ``boot``, polling every ``every`` decode
    steps, the spec's unless named, 0 never swaps; ``load`` in place of
    its snapshot read), with ``record`` under ``Forcing`` (``force``: the
    tokens it feeds): the served run's report, its launch counters, decode
    steps and host seconds, the refresh load's host seconds, and the
    ``Forcing`` record (None unrecorded)."""
    import torch
    vocab, prompt = server.api.vocab_real, server.cfg.prompt_len
    feats = cross_features(server.api) or None
    server.run(serve_requests(vocab, 1, new_tokens=(
        MESH_SERVE["warm_tokens"],) * 2, prompt_len=prompt, features=feats))
    laps = {}
    if refresh_dir is not None:
        refresher = server.make_refresher(
            refresh_dir, every_steps=spec["every"] if every is None
            else every, base_step=boot)
        read = load or refresher.load

        def timed_load(step):
            t = time.perf_counter()
            got = read(step)
            torch.cuda.synchronize(dev)
            laps["refresh_load_s"] = time.perf_counter() - t
            return got
        refresher.load = timed_load
    reqs = serve_requests(vocab, spec["n"], spec["new_tokens"],
                          prompt_len=prompt, features=feats)
    torch.cuda.synchronize(dev)
    before = server.decode_steps            # the warm-up's (a running count)
    reset_counters()
    t0 = time.perf_counter()
    with (Forcing(server, force) if record
          else contextlib.nullcontext()) as rec:
        rep = server.run(reqs)
    laps["run_s"] = time.perf_counter() - t0
    return (rep, counters(), rep.decode_steps - before, laps,
            rec.record() if record else None)


def mesh_serve_leg(dev, dirs: dict, spec: dict, mesh=None, params=None,
                   keep_boot=None, every=None, force=None, load=None,
                   record=True, plant=None) -> dict:
    """One leg: a Server (on ``mesh``) at snapshot 1 (``params`` where
    given, else booted from ``dirs["boot"]`` through ``restore_params``)
    serves the spec's stream with a refresher on ``dirs["live"]``
    (``mesh_serve_stream``; ``every`` 0: it never swaps), recorded and fed
    ``force`` as ``record`` and ``force`` say. ``plant`` is called with
    the server before the boot. Returns the served tokens and staleness
    stamps, the record, the launch counters of the served run, ms a decode
    step, the boot's and the refresh's read seconds, the swap's step, the
    served params' and the page pool's GB, the model axis's route and
    whole gathers and the peak device memory of the leg. ``keep_boot`` (a
    list) receives the booted params."""
    import torch
    torch.cuda.reset_peak_memory_stats(dev)
    given = params is not None
    server = mesh_server(dev, spec, mesh, params)
    del params
    if plant is not None:
        plant(server)
    boot, laps = 1, {}
    if not given:
        t0 = time.perf_counter()
        boot = server.restore_params(dirs["boot"])
        torch.cuda.synchronize(dev)
        laps["boot_s"] = time.perf_counter() - t0
        if keep_boot is not None:
            keep_boot.append(server.params)
    served_gb = tree_gb(server.params)
    rep, launches, steps, more, rec = mesh_serve_stream(
        server, dev, spec, dirs["live"], boot, every, force, load, record)
    laps.update(more)
    out = {"route": (server.paged_route, server._paged_why),
           "model_compute": server.model_compute,
           "tokens": {r.rid: r.tokens for r in rep.completed},
           "stamps": {r.rid: r.staleness for r in rep.completed},
           "record": rec, "report": rep, "launches": launches,
           "decode_steps": steps,
           "ms_per_decode_step": 1e3 * rep.phase_s["decode"] / steps,
           "tokens_per_s": rep.tokens_per_s, "laps": laps,
           "served_gb": served_gb,
           "pool_gb": tree_gb(server.cache.pages),
           "whole_gathers": (server.placement.whole_gathers
                             if server.placement is not None else None),
           "boot": boot, "step": server.refresher.current_step,
           "refreshes": rep.refreshes,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del server
    torch.cuda.empty_cache()
    return out


def planted_leg(dev, spec: dict, mesh, shards, force) -> dict:
    """The boot's ``shards`` served tensor-parallel with the model axis's
    ``reduce`` dropped (each rank keeps its partial sums), as the leg
    serves them but with no refresher, teacher-forced with ``force``: its
    record."""
    import torch
    server = mesh_server(dev, spec, mesh)
    server.model_parallel.reduce = lambda x: x
    server.params = shards
    del shards
    record = mesh_serve_stream(server, dev, spec, force=force)[4]
    del server
    torch.cuda.empty_cache()
    return {"record": record}


def planted_gather_leg(dev, spec: dict, mesh, dirs: dict) -> dict:
    """The gathered route booted from ``dirs["boot"]`` with a gather that
    delivers nothing (``NoGather``), served as the leg serves but with no
    refresher and unrecorded: its tokens."""
    import torch
    server = mesh_server(dev, spec, mesh)
    collectives = server.placement.dist
    server.placement.dist = NoGather()
    server.restore_params(dirs["boot"])
    server.placement.dist = collectives
    rep = mesh_serve_stream(server, dev, spec, record=False)[0]
    del server
    torch.cuda.empty_cache()
    return {"tokens": {r.rid: r.tokens for r in rep.completed}}


def serve_mesh_rank(rank: int, world: int, port: int, out_dir: str,
                    device: str = "cuda") -> int:
    """``--serve-mesh-rank R WORLD PORT DIR [DEVICE [LAYERS]]``: one rank
    of the 1 x WORLD serves on the one card over ``gloo``. Resolves the
    danube's route under "auto" on the mesh, then runs, on the snapshots
    under DIR, its leg unrecorded, its leg teacher-forced with the
    reference's tokens (``DIR/forced.pt``), the planted leg, the gathered
    route's leg and its planted gather, saving them as ``DIR/rank<R>.pt``
    as it goes."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs as cfglib
    from repro_torch.engine import plan as planlib
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import build_layout
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        build.library()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    tp, gathered = tp_serve_spec(), gathered_serve_spec()
    dirs, gdirs = serve_dirs(out_dir, tp), serve_dirs(out_dir, gathered)
    force = torch.load(os.path.join(out_dir, "forced.pt"))
    out = {}
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        mesh = make_host_mesh(1, world, device=dev.type)
        api = cfglib.get(tp["arch"]).api(reduced=False)
        layout = build_layout(api, SERVE["max_seq"], SERVE["page_tokens"],
                              device=dev)
        out["auto"] = planlib.resolve_serve_paged(
            api, layout, tp["arch"], mesh, "auto")
        boot = []
        legs = (("leg", lambda: mesh_serve_leg(dev, dirs, tp, mesh,
                                               record=False)),
                ("forced", lambda: mesh_serve_leg(
                    dev, dirs, tp, mesh, keep_boot=boot, force=force)),
                ("planted", lambda: planted_leg(dev, tp, mesh, boot.pop(),
                                                force)),
                ("gathered", lambda: mesh_serve_leg(
                    dev, gdirs, gathered, mesh, record=False)),
                ("gathered planted", lambda: planted_gather_leg(
                    dev, gathered, mesh, gdirs)))
        for leg, run in legs:
            try:
                out[leg] = run()
            except Exception as e:      # noqa: BLE001 (reported, then raised)
                out[leg] = {"error": f"{type(e).__name__}: {e}"}
                raise
            finally:
                torch.save(out, path)
    finally:
        dist.destroy_process_group()
    return 0


def same_serve(a: dict, b: dict, keep=None, tokens=True) -> bool:
    """Equal tokens (unless ``tokens`` is false) and staleness stamps:
    steps behind equal, and the age present at the same tokens (its value
    is a wall-clock reading). ``keep`` ({rid: [bool a token]}) compares
    only the tokens it marks."""
    def served(x):
        return {rid: [(t if tokens else None, s, age is None)
                      for i, (t, (s, age)) in
                      enumerate(zip(x["tokens"][rid], x["stamps"][rid]))
                      if keep is None or keep[rid][i]]
                for rid in x["tokens"]}
    return (a["tokens"].keys() == b["tokens"].keys()
            and served(a) == served(b))


def snapshot1_tokens(ref: dict) -> dict:
    """{rid: [bool a token]}: the reference's tokens served from snapshot
    1, those stamped a step behind (before the swap)."""
    return {rid: [behind > 0 for behind, _ in st]
            for rid, st in ref["stamps"].items()}


def witness_limits(ref: dict, wit: dict) -> dict:
    """A tensor-parallel serve's limits from the one-ulp witness's record
    (``wit``) against the reference's (``ref``): ``rel``, the logits'
    largest gap relative to the reference's largest |logit|, and
    ``margin``, the near-tie below which a pick may part (module comment
    at SERVE_FLOOR)."""
    gap = logit_gap(wit, ref)
    return {"witness": gap,
            "rel": min(max(WITNESS_FACTOR * gap["rel"], SERVE_FLOOR),
                       SERVE_CEILING),
            "margin": WITNESS_FACTOR * min(gap["max_abs"],
                                           SERVE_CEILING * gap["scale"])}


def held_forced(label: str, got: dict, ref: dict, limits: dict,
                failures: list) -> dict:
    """Hold a teacher-forced record against the reference's within
    ``limits`` (``witness_limits``): the logits' gap, and the picks up to
    each request's first near-tie. Prints both; returns the readings."""
    gap = logit_gap(got, ref)
    part = parting(got["picks"], ref, limits["margin"])
    ties = {rid: j for rid, j in part["ties"].items() if j is not None}
    clear = sum(m >= limits["margin"] for ms in ref["margins"].values()
                for m in ms)
    total = sum(map(len, ref["margins"].values()))
    print(f"{label}: teacher-forced logits part {gap['max_abs']!r} "
          f"({gap['rel']!r} of the largest |logit| {gap['scale']!r}; limit "
          f"{limits['rel']!r}, witness {limits['witness']['rel']!r}); own "
          f"picks part from the reference's before a near-tie (margin < "
          f"{limits['margin']!r}) in {len(part['parted'])} requests "
          f"{part['parted']}; {len(ties)} of {len(part['ties'])} requests "
          f"reach a near-tie, first at tokens {ties}; picks flipped at "
          f"{part['flips']} of the {clear} of {total} tokens past the "
          f"margin")
    if gap["rel"] > limits["rel"]:
        failures.append(f"{label}: logits part {gap['rel']!r} of the "
                        f"largest, over {limits['rel']!r}")
    if part["parted"] or part["flips"]:
        failures.append(f"{label}: picks part before a near-tie "
                        f"{part['parted']} or flip past the margin "
                        f"{part['flips']}")
    return {"logit_gap": gap, "parted": part["parted"], "near_ties": ties,
            "flips": part["flips"], "clear_tokens": clear,
            "tokens": total}


def serve_mesh_path(dev) -> dict:
    """Phase 13: the full-width danube (MESH_SERVE_LAYERS deep) served
    mesh-less, from one-ulp-nudged params (the witness), on a 1x1 nccl
    mesh and on two gloo ranks at 1x2 tensor-parallel (unrecorded,
    teacher-forced, and with the planted dropped ``reduce``), each booted
    from snapshot 1 and refreshed to snapshot 2 mid-serve (MESH_SERVE);
    then GATHERED_SERVE mesh-less and on the two ranks on the gathered
    route (with the planted ``NoGather``)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import configs as cfglib
    from repro_torch.launch.mesh import backend_for, make_host_mesh

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    failures, out = [], {}

    def row(leg: dict) -> dict:
        return {k: leg[k] for k in (
            "decode_steps", "ms_per_decode_step", "tokens_per_s", "laps",
            "served_gb", "pool_gb", "whole_gathers", "boot", "step",
            "refreshes", "peak_mem_gb", "route", "model_compute")} | {
            "launches": leg["launches"]["paged_attention"]}

    def swapped(label: str, leg: dict) -> None:
        if (leg["boot"], leg["step"], leg["refreshes"]) != (1, 2, 1):
            failures.append(f"{label}: boot {leg['boot']}, step "
                            f"{leg['step']}, refreshes {leg['refreshes']}; "
                            "expected one swap from 1 to 2")

    tp, gathered = tp_serve_spec(), gathered_serve_spec()
    api = cfglib.get(tp["arch"]).api(reduced=False)
    whole_gb = tree_gb(api.init(0, device="meta")[0])
    with tempfile.TemporaryDirectory() as tmp:
        dirs, params1, params2 = publish_snapshots(dev, tmp, tp)
        ref = mesh_serve_leg(dev, dirs, tp, params=params1)
        want = api.cfg.num_layers * ref["decode_steps"]
        others = {k: n for k, n in ref["launches"].items()
                  if k != "paged_attention" and n}
        print(f"serve mesh-less (recorded): {json.dumps(row(ref))}")
        if ref["launches"]["paged_attention"] != want or others:
            failures.append(f"mesh-less: launches {ref['launches']}, "
                            f"expected paged_attention={want} only")
        swapped("mesh-less", ref)
        out["mesh-less"] = row(ref)
        torch.save(ref["tokens"], os.path.join(tmp, "forced.pt"))

        t_w = time.perf_counter()
        wit = mesh_serve_leg(
            dev, dirs, tp, params=nudged(params1), force=ref["tokens"],
            load=lambda step: (nudged(params2),
                               {"published_at": time.time()}))
        del params2
        limits = witness_limits(ref["record"], wit["record"])
        print(f"serve witness (both snapshots one ulp up, teacher-forced): "
              f"logits part {json.dumps(limits['witness'])}; limits: "
              f"{limits['rel']!r} of the largest |logit|, near-tie margin "
              f"{limits['margin']!r}; {time.perf_counter() - t_w:.1f} s")
        out["witness"] = dict(row(wit), **{k: limits[k] for k in (
            "witness", "rel", "margin")})

        backend = backend_for(dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{free_port()}", rank=0, world_size=1)
        try:
            one = mesh_serve_leg(dev, dirs, tp, make_host_mesh(
                1, 1, device=dev.type), params=params1, every=0,
                record=False)
        finally:
            dist.destroy_process_group()
        del params1
        pre = snapshot1_tokens(ref)
        ok = same_serve(one, ref, keep=pre)
        print(f"serve mesh 1x1 {backend} (unrecorded): the "
              f"{sum(map(sum, pre.values()))} snapshot-1 tokens bitwise "
              f"{ok}; {json.dumps(row(one))}")
        if not ok:
            failures.append("1x1: snapshot-1 tokens or stamps differ from "
                            "mesh-less")
        if one["refreshes"]:
            failures.append(f"1x1: {one['refreshes']} refreshes, expected "
                            "none")
        if one["launches"] != ref["launches"]:
            failures.append(f"1x1: launches {one['launches']} vs "
                            f"{ref['launches']}")
        out[f"1x1 {backend}"] = dict(row(one), bitwise=ok)

        gdirs, gparams1, _ = publish_snapshots(dev, tmp, gathered)
        gref = mesh_serve_leg(dev, gdirs, gathered, params=gparams1,
                              record=False)
        del gparams1
        gwhole_gb = tree_gb(cfglib.get(gathered["arch"]).api(
            reduced=False).init(0, device="meta")[0])
        print(f"serve {gathered['arch']} mesh-less: {json.dumps(row(gref))}")
        swapped(f"{gathered['arch']} mesh-less", gref)
        out[f"{gathered['arch']} mesh-less"] = row(gref)
        print(f"serve mesh phase: the one-process legs took "
              f"{time.perf_counter() - t0:.1f} s")

        t1 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        done = run_ranks("--serve-mesh-rank", MESH_SERVE_RANKS, tmp,
                         dev.type, str(MESH_SERVE_LAYERS), timeout=300,
                         capture=True)
        ranks = []
        for r, (rc, log) in enumerate(done):
            path = os.path.join(tmp, f"rank{r}.pt")
            ranks.append(torch.load(path, weights_only=False)
                         if os.path.exists(path) else {})
            if rc != 0:
                tail = log.strip().splitlines()[-12:]
                print(f"serve mesh rank {r} exited {rc}:\n  "
                      + "\n  ".join(tail))
                failures.append(f"two-rank serve: rank {r} exited {rc}")
    for r, got in enumerate(ranks):
        auto = got.get("auto")
        if auto != ("gather", f"model axis extent {MESH_SERVE_RANKS}"):
            failures.append(f"1x2 rank {r}: auto resolved to {auto}")
        legs = {k: got.get(k) for k in ("leg", "forced", "planted",
                                         "gathered", "gathered planted")}
        bad = {k: (v or {}).get("error", "none") for k, v in legs.items()
               if v is None or "error" in v}
        if bad:
            failures.append(f"1x2 rank {r}: {bad}")
            continue
        leg, forced = legs["leg"], legs["forced"]
        part = parting(leg["tokens"], ref["record"], limits["margin"])
        ties = {rid: j for rid, j in part["ties"].items() if j is not None}
        stamps = same_serve(leg, ref, tokens=False)
        print(f"serve mesh 1x2 gloo rank {r} (unrecorded): auto {auto}; "
              f"served tokens part from the reference's before a near-tie "
              f"(margin < {limits['margin']!r}) in {len(part['parted'])} "
              f"requests {part['parted']}, {len(ties)} of "
              f"{len(part['ties'])} requests reach a near-tie, first at "
              f"tokens {ties}; stamps the reference's {stamps}; served "
              f"params {leg['served_gb']:.3f} GB against the gathered "
              f"route's {whole_gb:.3f} GB; {json.dumps(row(leg))}")
        if part["parted"]:
            failures.append(f"1x2 rank {r}: tokens part before a near-tie "
                            f"{part['parted']}")
        if not stamps:
            failures.append(f"1x2 rank {r}: stamps differ from mesh-less")
        for name, x in (("leg", leg), ("forced", forced)):
            if x["model_compute"] != ("tensor-parallel", ""):
                failures.append(f"1x2 rank {r} {name}: model axis "
                                f"{x['model_compute']}")
            if x["whole_gathers"]:
                failures.append(f"1x2 rank {r} {name}: {x['whole_gathers']}"
                                " model-axis gathers of whole params")
            if x["launches"] != ref["launches"]:
                failures.append(f"1x2 rank {r} {name}: launches "
                                f"{x['launches']} vs {ref['launches']}")
            swapped(f"1x2 rank {r} {name}", x)
            if x["report"] != ranks[0]["leg" if name == "leg" else
                                       "forced"]["report"]:
                failures.append(f"1x2 rank {r} {name}: its report is not "
                                "rank 0's")
        held = held_forced(f"serve mesh 1x2 gloo rank {r} (teacher-forced)",
                           forced["record"], ref["record"], limits, failures)
        if not same_serve(forced, ref):
            failures.append(f"1x2 rank {r}: forced tokens or stamps differ "
                            "from mesh-less")
        first = ranks[0]["forced"]["record"]["logits"]
        if not all(torch.equal(x, first[rid])
                   for rid, x in forced["record"]["logits"].items()):
            failures.append(f"1x2 rank {r}: its logits are not rank 0's")
        out[f"1x2 gloo rank {r}"] = dict(
            row(leg), auto=auto, whole_gb=whole_gb,
            unrecorded={"parted": part["parted"], "near_ties": ties},
            forced=row(forced), **held)
        gap = logit_gap(legs["planted"]["record"], ref["record"], keep=pre)
        print(f"serve mesh 1x2 gloo rank {r} (planted fault, reduce "
              f"dropped): logits on the snapshot-1 tokens part "
              f"{gap['rel']!r} of the largest (limit {limits['rel']!r})")
        if not gap["rel"] > limits["rel"]:
            failures.append(f"1x2 planted rank {r}: parts only "
                            f"{gap['rel']!r}")
        out[f"1x2 planted rank {r}"] = {"logit_gap": gap}

        g, gp = legs["gathered"], legs["gathered planted"]
        ok = same_serve(g, gref)
        print(f"serve {gathered['arch']} mesh 1x2 gloo rank {r}: "
              f"{g['model_compute']}; tokens and stamps bitwise the "
              f"mesh-less run's {ok}; served params {g['served_gb']:.3f} GB "
              f"(whole {gwhole_gb:.3f}); {g['whole_gathers']} model-axis "
              f"gathers; {json.dumps(row(g))}")
        if not ok:
            failures.append(f"1x2 gathered rank {r}: tokens or stamps "
                            "differ from mesh-less")
        if g["model_compute"][0] != "gathered" or not g["whole_gathers"]:
            failures.append(f"1x2 gathered rank {r}: {g['model_compute']}, "
                            f"{g['whole_gathers']} whole gathers")
        if abs(g["served_gb"] - gwhole_gb) > 1e-9:
            failures.append(f"1x2 gathered rank {r}: serves "
                            f"{g['served_gb']} GB, not the whole "
                            f"{gwhole_gb}")
        if g["launches"] != gref["launches"]:
            failures.append(f"1x2 gathered rank {r}: launches "
                            f"{g['launches']} vs {gref['launches']}")
        swapped(f"1x2 gathered rank {r}", g)
        if g["report"] != ranks[0]["gathered"]["report"]:
            failures.append(f"1x2 gathered rank {r}: its report is not "
                            "rank 0's")
        gpre = snapshot1_tokens(gref)
        parted = sum(a != b and early for rid in gref["tokens"]
                     for a, b, early in zip(gp["tokens"][rid],
                                            gref["tokens"][rid], gpre[rid]))
        print(f"serve {gathered['arch']} mesh 1x2 gloo rank {r} (planted "
              f"fault, a gather that delivers nothing): {parted} of the "
              f"{sum(map(sum, gpre.values()))} snapshot-1 tokens part from "
              f"the mesh-less run's")
        if not parted:
            failures.append(f"1x2 gathered planted rank {r}: no token "
                            "parts")
        out[f"1x2 gathered rank {r}"] = dict(row(g), bitwise=ok,
                                             planted_parted=parted)
    print(f"serve mesh phase: two-rank legs took "
          f"{time.perf_counter() - t1:.1f} s; the phase "
          f"{time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("serve mesh phase: " + "; ".join(failures))
    return out


def add_serve_mesh_rows(kernels: list, serve_mesh: dict) -> None:
    """Beside paged_attention, its launches on every leg of phase 13 (the
    witness's and the planted fault's runs are not main-path runs)."""
    for entry in kernels:
        if entry["name"] == "paged_attention":
            entry["launches_serve_mesh"] = {
                leg: row["launches"] for leg, row in serve_mesh.items()
                if "launches" in row and leg != "witness"}


# -- phase 14: the FSDP archs trained on a mesh ------------------------------------

# deepseek-67b at full width (d_model 8192, 64 heads, kv 8, d_ff 22,016,
# vocab 102,400; bf16 params, momentum) cut to FSDP_LEG["layers"] layer:
# 2.37 B params, 4.74 GB. Legs of FSDP_LEG["steps"] steps on B 4 x 256
# (3 until the tensor-parallel phase joined: a step after the first, in
# fp32, takes 23-30 s over gloo): ``sync``, and ``stale-psum`` over the
# aggregate ring (two slots) with the deterministic delays FSDP_DELAYS,
# which deliver the aggregate one step late from step 2. Two gloo ranks on the one card run them at 2x1
# (params, momentum and the ring as data-axis shards; each layer gathered
# as it runs, its gradient reduce-scattered), after rank 0 has run them as
# one process (the reference) and from one-ulp-nudged params (the witness).
# Then one sync step with each rank's own half-batch gradient in place of
# the reduce-scatter (the planted fault), and one sync step at 1x2, where
# deepseek-67b computes tensor-parallel on its model-axis shards (phase 15
# holds the gathered route bit for bit on the card). The phase runs under
# deterministic algorithms (the embedding's backward accumulates bf16 rows
# in a fixed order), so two runs of one computation agree bit for bit.
FSDP_ARCH = "deepseek-67b"
FSDP_LEG = dict(layers=1, batch=4, seq=256, steps=2, workers=2, stale=2)
FSDP_DELAYS = (0, 1, 1)
FSDP_RANKS = 2
# The stale-psum leg's grad_norm at each step, two ranks against one
# process: ~6e-6 relative on the H100 (PERF.md), where the aggregate of a
# neighbouring step parts by ~4.5e-3 (the one process's norms 9.9208,
# 9.9208, 9.8762).
FSDP_NORM_REL = 1e-4
# One more sync step at 2x1 with this many layers: each layer's gathered
# leaves must be gone before the next layer's are gathered, and the peak
# grows by the added layer's shard at the update, not by a gathered layer.
FSDP_MEM_LAYERS = 2
# The bytes an element of a rank's shard holds at step 1's optimizer
# update, where a sync step peaks: the bf16 params and momentum, the new
# bf16 momentum, the fp32 delta and the fp32 new params (C.8). On the
# H100 a rank's step-1 peak is 14 B times its shard's elements at 1 and 2
# layers (16.59 and 21.43 GB, PERF.md).
FSDP_UPDATE_BYTES = 14
# Step 1 from the shared init, two ranks against one process, held as
# ``first_step_check`` holds a step: all but this share of the elements
# within TOL_FIRST, and every element within TOL_FIRST or one ulp of the
# reference's value (a bf16 param moves by far less than its ulp in a
# step, so a gradient that differs in roundoff can only flip a rounding).
FSDP_FLIP_SHARE = 1e-3
# Last, the ranks serve the phase's deepseek-67b (FSDP_LEG["layers"] deep,
# bf16, seed 0) at 2x1 from their data blocks (ROADMAP A.18.1): a Server
# that inits its own params cuts each value to its block as it is drawn,
# and prefill and decode gather one layer (or ``embed``, ``final_ln``,
# ``head``) at a time as the model reads it, dropping it after use. The
# stream: FSDP_SERVE["n"] greedy requests of FSDP_SERVE["prompt_len"]
# tokens, FSDP_SERVE["new_tokens"] new tokens each, over as many slots (one
# prefill call, new_tokens - 1 decode steps, each reading every param
# once: ``transformer.decode_slots``). Held against the same stream served
# by one process (the script's, before the ranks get the leg): tokens and
# counts bit for bit, no model-axis gather, a rank's served bytes its data
# blocks', its peak below its blocks plus twice the largest read plus the
# cache and FSDP_SERVE_SLACK_GB (``all_gather_dim`` holds a read's parts
# and their concatenation at once), the bytes allocated before each read
# and after each step within the blocks plus the cache and
# FSDP_SERVE_SLACK_GB (every read is dropped after use), and each decode
# step's data-axis gathers one a data-sharded leaf. Then the same stream
# with the data fetch's gather delivering nothing (``NoGather``, planted),
# whose tokens must part.
FSDP_SERVE = dict(n=2, prompt_len=32, new_tokens=4)
FSDP_SERVE_SLACK_GB = 0.5


def tree_stats(dev, got, ref, p0=None) -> dict:
    """``piece_stats`` of two whole trees (and ``p0``), leaf by leaf."""
    from repro_torch import treemath as tm
    bases = tm.tree_leaves(p0) if p0 is not None else None
    return piece_stats(dev, [
        (a, b, None if bases is None else bases[i], i) for i, (a, b) in
        enumerate(zip(tm.tree_leaves(got), tm.tree_leaves(ref)))])


def leaf_names(tree, at: str = "") -> list:
    """Each leaf's path, in ``treemath.tree_leaves``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{at}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, c in enumerate(tree) for n in leaf_names(c,
                                                                 f"{at}/{i}")]
    return [at or "/"]


def piece_stats(dev, pieces, chunk: int = 1 << 26) -> dict:
    """Pieces ``(got, ref, base or None, leaf)`` (tensors on the host or
    the card; a leaf's pieces share its index) held against each other in
    chunks on the card: ``rel`` = |got - ref| / |ref - base| (|ref|
    without bases), the share of elements outside TOL_FIRST, whether every
    element lies within TOL_FIRST or one ulp of ``ref``'s value (a bf16
    param moves by far less than its ulp in a step, so a gradient that
    differs in roundoff can only flip a rounding), whether they are equal
    bit for bit, the largest element's distance, and under ``leaves``
    each leaf's ``rel`` and share."""
    import torch
    d2 = n2 = worst = 0.0
    outside = total = 0
    within = bitwise = True
    leaves = {}
    for a, b, c, leaf in pieces:
        a, b = a.reshape(-1), b.reshape(-1)
        c = None if c is None else c.reshape(-1)
        mine = leaves.setdefault(leaf, [0.0, 0.0, 0, 0])
        for lo in range(0, b.numel(), chunk):
            x = a[lo:lo + chunk].to(dev)
            y = b[lo:lo + chunk].to(dev)
            bitwise = bitwise and torch.equal(x, y)
            err = (x.float() - y.float()).abs()
            if err.numel():
                worst = max(worst, float(err.max()))
            e2 = float(err.double().square().sum())
            base = y.float() if c is None else (
                y.float() - c[lo:lo + chunk].to(dev).float())
            b2 = float(base.double().square().sum())
            tol = err <= TOL_FIRST["atol"] + TOL_FIRST["rtol"] * y.float().abs()
            ulp = (torch.nextafter(y.abs(), torch.full_like(y, float("inf")))
                   .float() - y.abs().float())
            out = int((~tol).sum())
            within = within and bool((tol | (err <= ulp)).all())
            for i, v in enumerate((e2, b2, out, y.numel())):
                mine[i] += v
            d2, n2, outside, total = (d2 + e2, n2 + b2, outside + out,
                                      total + y.numel())
            del x, y, err, base, tol, ulp
    torch.cuda.empty_cache()
    return {"rel": (d2 ** 0.5) / max(n2 ** 0.5, 1e-30),
            "max_abs_err": worst, "outside_tol": outside, "elements": total,
            "share": outside / max(total, 1), "within_tol_or_ulp": within,
            "bitwise": bitwise,
            "leaves": {leaf: {"rel": (e2 ** 0.5) / max(b2 ** 0.5, 1e-30),
                              "share": out / max(n, 1), "elements": n}
                       for leaf, (e2, b2, out, n) in leaves.items()}}


def block_of(place, rank: int, x, dims, shape):
    """Rank ``rank``'s block of a whole leaf ``x`` (a view): its data
    block and its ``torch.chunk`` part of the model dim, as
    ``MeshPlacement.shard_params`` cuts."""
    from repro_torch.engine.placement import chunk_span
    coords = (place.mesh.mesh == rank).nonzero()[0].tolist()
    at = dict(zip(place.mesh.mesh_dim_names, coords))
    dd, md = dims
    if dd is not None:
        c = shape[dd] // place.n
        x = x.narrow(dd, at["data"] * c, c)
    if md is not None:
        x = x.narrow(md, *chunk_span(shape[md], place.m, at["model"]))
    return x


def fsdp_engine(dev, arch: str, mode: str, mesh=None):
    """The leg's engine through ``make_train_engine`` (kernels auto, which
    the FSDP placement vetoes)."""
    import numpy as np
    from repro_torch import delays
    from repro_torch.configs.base import InputShape
    from repro_torch.engine.plan import make_train_engine
    f = FSDP_LEG
    shape = InputShape("train_fsdp", f["seq"], f["batch"], "train")
    kw = {} if mode == "sync" else dict(
        stale_s=f["stale"], per_worker_delays=False,
        delay=delays.Schedule(np.asarray(FSDP_DELAYS)))
    return make_train_engine(arch, shape, mesh, mode=mode,
                             num_workers=f["workers"], device=dev, **kw)


def fsdp_run(dev, arch: str, mode: str, mesh=None, *, start=None,
             steps=None, after=None, profile=False, record_step=None,
             say=print) -> dict:
    """One leg: ``steps`` steps on the CLI's batches (seed 0; every rank
    draws the same global batch), each step's wall time between device
    syncs, the launch counters zeroed just before and read just after, and
    the peak memory above what was allocated at the start. After each
    step ``after(t, params, momentum, placement)`` (every rank calls it).
    With ``profile`` the last step runs under ``profile_collectives``.
    ``record_step``: the data axis's gathers and reduce-scatters of that
    step."""
    import gc
    import torch
    from repro_torch import configs as cfglib
    from repro_torch.launch import train

    steps = steps or FSDP_LEG["steps"]
    engine = fsdp_engine(dev, arch, mode, mesh)
    api = cfglib.get(arch).api()
    nb = train.make_batch_fn(api, FSDP_LEG["batch"], FSDP_LEG["seq"], 0)
    batches = iter(nb, None)
    place = engine.placement
    axis = getattr(place, "data_axis", None)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    box = [engine.init(0, params=start)]
    del start
    out = {"losses": [], "grad_norms": [], "wall_s": [], "peak_by_step": [],
           "meta": engine.meta["kernels"],
           "model_compute": engine.meta.get("model_compute")}
    reset_counters()
    for t in range(1, steps + 1):
        if t == record_step and axis is not None:
            axis.record = MemoryRecord()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if profile and t == steps:
            last = []
            out["collectives"] = profile_collectives(
                engine, box.pop(), batches, 1,
                lambda: torch.cuda.synchronize(dev), warm=False, keep=last)
            state, m = last.pop()
        else:
            state, m = engine.step(box.pop(), next(batches))
        torch.cuda.synchronize(dev)
        out["wall_s"].append(time.perf_counter() - t0)
        if t == record_step and axis is not None:
            out["traffic"], axis.record = list(axis.record), None
        out["peak_by_step"].append(
            (torch.cuda.max_memory_allocated(dev) - base) / 1e9)
        out["losses"].append(float(m["loss"]))
        if "grad_norm" in m:
            out["grad_norms"].append(float(m["grad_norm"]))
        say(f"{mode} step {t}: loss {out['losses'][-1]!r}, "
            f"{out['wall_s'][-1]:.2f} s")
        del m
        if after is not None:
            after(t, state.inner.params, state.inner.opt_state["m"], place)
        box.append(state)
        del state
        if place is not None:
            out["host_pinned_gb"] = max(out.get("host_pinned_gb", 0.0),
                                        host_pinned_gb())
            if t == 1:
                # gloo's pinned staging of a bf16 and an fp32 step's sizes
                # (the params turn fp32 in step 1's update), in two ranks,
                # beside rank 0's reference copies, does not fit the host.
                release_memory()
    out["launches"] = counters()
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    box.clear()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


class MemoryRecord(list):
    """An ``Axis.record`` that also notes the bytes allocated on the card
    as each entry is made (a gather's just after its output exists)."""

    def append(self, entry):
        import torch
        super().append(tuple(entry) + (torch.cuda.memory_allocated(),))


def fsdp_reference(dev, arch: str, mode: str, p0, say=print) -> dict:
    """Rank 0's one-process run of one leg from the seeded init ``p0``,
    its params after the steps the mesh legs are held at (and the momentum
    after step 1, which holds that step's gradient, the aggregate the ring
    delivers at delay 0 in stale-psum) kept on the host, and, as its
    witness, from the init nudged one ulp up, held against them as it
    runs; the witness's distances set the two-rank legs' limits."""
    import gc
    from repro_torch import treemath as tm
    steps = FSDP_LEG["steps"]
    kept = {}
    keep = (1, steps) if mode == "sync" else (steps,)

    def store(t, params, m, _place):
        if t in keep:
            kept[t] = to_host(params)
        if t == 1:
            kept["m1"] = to_host(m)

    run = fsdp_run(dev, arch, mode, after=store, say=say)
    run["kept"] = kept
    wit = {}

    def against(t, params, m, _place):
        if t == steps:
            wit["params"] = tree_stats(dev, params, kept[steps], p0)
        if t == 1:
            wit["grad"] = tree_stats(dev, m, kept["m1"])

    wrun = fsdp_run(dev, arch, mode, start=nudged(
        tm.tree_map(lambda x: x.to(dev), p0)), after=against, say=say)
    run["witness"] = {
        "loss": max(abs(a - b) for a, b in zip(wrun["losses"],
                                               run["losses"])),
        "rel": wit["params"]["rel"], "grad_rel": wit["grad"]["rel"],
        "losses": wrun["losses"]}
    del wrun
    gc.collect()
    return run


def release_memory() -> None:
    """Free the card's cached blocks and the pinned host blocks gloo
    staged its CUDA collectives through (the host allocator keeps them
    for reuse: a bf16 and an fp32 step's sizes together, in two ranks,
    beside rank 0's reference copies, ran the host's 96 GiB out)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def host_pinned_gb() -> float:
    """The pinned host bytes the allocator holds (cached and in use)."""
    import torch
    stats = torch.cuda.memory.host_memory_stats()
    return stats.get("allocated_bytes.current", 0) / 1e9


def fsdp_serve_leg(dev, arch: str, mesh=None) -> dict:
    """FSDP_SERVE's stream served greedy on the gather route by a Server
    that inits ``arch`` from seed 0 (on ``mesh``, each rank's data blocks),
    the launch counters zeroed just before the run and read just after:
    its tokens, report counts and ms a decode step, the served and cache
    GB, the model axis's whole gathers, the init's peak (``boot_peak_gb``)
    and the serve's peak (``peak_gb``) above the start; on a
    mesh also each decode step's data-axis gathers ``(name, GB)``, the GB
    allocated above the start before each read (``(name, GB)``) and after
    each step, the largest read's GB, the blocks' and the whole params' GB
    by the specs, and the planted run's tokens (``NoGather``)."""
    import torch
    from repro_torch.serving import Server, ServingConfig
    f = FSDP_SERVE
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    server = Server(ServingConfig(
        arch=arch, reduced=False, slots=f["n"], prompt_len=f["prompt_len"],
        max_seq=f["prompt_len"] + f["new_tokens"], page_tokens=8,
        prefill_batch=f["n"], temperature=0.0, seed=0, paged="auto"),
        device=dev, mesh=mesh)
    reqs = lambda: serve_requests(server.api.vocab_real, f["n"],
                                  (f["new_tokens"],) * 2,
                                  prompt_len=f["prompt_len"])
    pl = server.placement
    sharded = pl is not None and pl.data_axis is not None
    torch.cuda.synchronize(dev)
    out = {"route": (server.paged_route, server._paged_why),
           "served_gb": tree_gb(server.params),
           "cache_gb": tree_gb((server.cache.pages, server.cache.resident)),
           "boot_peak_gb": (torch.cuda.max_memory_allocated(dev) - base)
           / 1e9}
    torch.cuda.reset_peak_memory_stats(dev)
    gb = lambda: (torch.cuda.memory_allocated(dev) - base) / 1e9
    if sharded:
        out.update(data_blocks_gb(pl, server.params))
        steps, before, after = [], [], []
        fetch, plan, axis = server._fetch, server.splan, pl.data_axis

        def read(tree, name):
            before.append((name, gb()))
            return fetch(tree, name)

        def step(*args):
            axis.record = []
            try:
                return plan(*args)
            finally:
                steps.append([(name, nbytes / 1e9)
                              for _, name, _, nbytes in axis.record])
                axis.record = None
                torch.cuda.synchronize(dev)
                after.append(gb())
        server._fetch, server.splan = read, step
        out.update(reads=steps, before_read_gb=before, after_step_gb=after)
    torch.cuda.synchronize(dev)
    reset_counters()
    rep = server.run(reqs())
    out["launches"] = counters()
    torch.cuda.synchronize(dev)
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    out.update(
        tokens={r.rid: r.tokens for r in rep.completed},
        counts=(rep.decode_steps, rep.joins, rep.evicts, rep.prefill_calls),
        ms_per_decode_step=1e3 * rep.phase_s["decode"] / rep.decode_steps,
        whole_gathers=None if pl is None else pl.whole_gathers)
    if sharded:
        # A read: embed, one layer (its leaves' gathers), final_ln, head.
        layers = server.api.cfg.num_layers
        by_name = {}
        for name, g in steps[0]:
            by_name[name] = by_name.get(name, 0.0) + g
        out["largest_read_gb"] = max(g / (layers if name == "layers" else 1)
                                     for name, g in by_name.items())
        server._fetch, server.splan = fetch, plan
        collectives, pl.dist = pl.dist, NoGather()
        try:
            out["planted_tokens"] = {r.rid: r.tokens
                                     for r in server.run(reqs()).completed}
        finally:
            pl.dist = collectives
    del server
    release_memory()
    return out


def data_blocks_gb(pl, params) -> dict:
    """By the serve placement ``pl``'s specs, of served ``params`` (a dict
    whose ``layers`` leaves stack the layers): the GB of a rank's blocks
    (a leaf whose spec puts a dim that the data extent N divides on
    ``data`` holds 1/N of its bytes), of the whole params, of the whole
    data-sharded leaves (what a pass over every layer gathers), and the
    gathers of such a pass (one a data-sharded leaf, a stacked leaf's one
    a layer)."""
    import torch
    from repro_torch import treemath as tm
    from repro_torch.sharding.rules import _names
    out = dict(blocks_gb=0.0, whole_gb=0.0, sharded_gb=0.0, gathers=0)
    leaves = [(x, key) for key in sorted(params)
              for x in tm.tree_leaves(params[key])]
    for (x, key), spec, shape in zip(leaves, pl.specs, pl.shapes):
        gb = torch.Size(shape).numel() * x.element_size() / 1e9
        on = [d for d, part in enumerate(spec) if "data" in _names(part)]
        cut = bool(on) and shape[on[0]] % pl.n == 0
        out["whole_gb"] += gb
        out["blocks_gb"] += gb / pl.n if cut else gb
        if cut:
            out["sharded_gb"] += gb
            out["gathers"] += shape[0] if key == "layers" else 1
    return out


def fsdp_mesh_rank(rank: int, world: int, port: int, out_dir: str,
                   device: str = "cuda") -> int:
    """``--fsdp-mesh-rank R WORLD PORT DIR [DEVICE]``: one rank of phase
    14 on the one card over ``gloo``. For each leg rank 0 runs the
    one-process reference while rank 1 waits, then both run it at 2x1
    (after sync, the planted step); last the
    FSDP_MEM_LAYERS-deep sync step. Rank 0 holds each against the
    reference (rank 1's shards read through CUDA IPC); each rank saves
    its readings as ``DIR/rank<R>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.engine import placement as placement_lib
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    arch = cut_arch(FSDP_ARCH, FSDP_LEG["layers"])
    out = {}
    path = os.path.join(out_dir, f"rank{rank}.pt")
    steps = FSDP_LEG["steps"]
    t_start = time.perf_counter()

    def say(msg):
        print(f"fsdp rank {rank} +{time.perf_counter() - t_start:.1f} s: "
              f"{msg}", flush=True)

    def save():
        torch.save(out, path)

    def reading(run):
        return {k: run[k] for k in (
            "losses", "grad_norms", "wall_s", "peak_mem_gb", "peak_by_step",
            "host_pinned_gb", "launches", "meta", "model_compute",
            "traffic", "collectives", "witness")
            if k in run}

    def holder(at: tuple, m1: bool, want=None, p0=None):
        """An ``after`` that holds this step's shards of the params (after
        the steps in ``at``) and, with ``m1``, of the momentum after step 1
        against the reference's ``want``, on rank 0: rank 1 shares its
        shards through CUDA IPC (the two ranks share the card), rank 0
        reads them in place and compares each rank's block. Every rank
        makes the same calls."""
        from torch.multiprocessing.reductions import reduce_tensor
        from repro_torch import treemath as tm
        got = {}

        def after(t, params, m, place):
            trees = {"params": params} if t in at else {}
            if m1 and t == 1:
                trees["m1"] = m
            for name, tree in trees.items():
                mine = tm.tree_leaves(tree)
                box = [[reduce_tensor(x) for x in mine] if rank else None]
                dist.broadcast_object_list(box, src=1)
                if rank == 0:
                    other = [fn(*args) for fn, args in box[0]]
                    ref_leaves = tm.tree_leaves(
                        want["m1" if name == "m1" else t])
                    bases = (tm.tree_leaves(p0) if name == "params"
                             and p0 is not None else None)
                    pieces = []
                    for i, (dims, shape) in enumerate(zip(
                            place._dims, place.full_shapes)):
                        for r, x in ((0, mine[i]), (1, other[i])):
                            pieces.append((x, block_of(
                                place, r, ref_leaves[i], dims, shape),
                                None if bases is None else block_of(
                                    place, r, bases[i], dims, shape), i))
                    got[f"{name}@{t}"] = piece_stats(dev, pieces)
                    del other, pieces
                dist.barrier()
        return after, got

    def planted_step(ref_sync, mesh21) -> float:
        """After the 2x1 sync leg: the planted step, held against the sync
        reference (rank 0); returns its seconds."""
        t1 = time.perf_counter()
        kept = ref_sync["kept"] if rank == 0 else None
        # The planted fault: each rank's own half-batch gradient (its
        # chunk of the local gradient, times N so the step's / N leaves it
        # whole) in place of the reduce-scatter.
        real = placement_lib.reduce_scatter_dim

        def own(dist_, g, d, n, group):
            c = g.shape[d] // n
            r = dist_.get_rank(group)
            return g.narrow(d, r * c, c).contiguous() * n
        placement_lib.reduce_scatter_dim = own
        after, got = holder((), True, kept)
        try:
            run = fsdp_run(dev, arch, "sync", mesh21, steps=1, after=after,
                           say=say)
        finally:
            placement_lib.reduce_scatter_dim = real
        out["2x1 planted"] = reading(run) | {"stats": got}
        del run
        release_memory()
        save()
        return time.perf_counter() - t1

    def tp_step(ref_sync, p0) -> float:
        """After the planted step: one sync step at 1x2, where the model
        axis computes tensor-parallel on its shards, held against the sync
        reference's step 1 (rank 0); returns its seconds."""
        t1 = time.perf_counter()
        kept = ref_sync["kept"] if rank == 0 else None
        mesh12 = make_host_mesh(1, world, device=dev.type)
        after, got = holder((1,), True, kept, p0)
        run = fsdp_run(dev, arch, "sync", mesh12, steps=1, after=after,
                       say=say)
        out["1x2 sync"] = reading(run) | {"stats": got}
        del run
        release_memory()
        save()
        return time.perf_counter() - t1

    try:
        p0 = init_params(dev, arch) if rank == 0 else None
        out["reference"], out["reference_s"] = {}, 0.0
        mesh21 = make_host_mesh(world, 1, device=dev.type)
        mesh_s = 0.0
        ref = {}
        for mode in ("sync", "stale-psum"):
            # Rank 0 runs the leg's reference while rank 1 waits, then both
            # run it at 2x1; only one leg's reference copies are on the
            # host at a time.
            if rank == 0:
                t0 = time.perf_counter()
                ref[mode] = fsdp_reference(dev, arch, mode, p0, say=say)
                out["reference"][mode] = reading(ref[mode])
                out["reference_s"] += time.perf_counter() - t0
                release_memory()
                save()
            dist.barrier()
            t1 = time.perf_counter()
            sync_leg = mode == "sync"
            after, got = holder((1, steps) if sync_leg else (steps,),
                                True, ref[mode]["kept"] if rank == 0
                                else None, p0)
            run = fsdp_run(dev, arch, mode, mesh21, after=after,
                           profile=sync_leg, record_step=2,
                           say=say)
            leg = reading(run)
            if rank == 0:
                leg["loss"] = max(abs(a - b) for a, b in zip(
                    run["losses"], ref[mode]["losses"]))
                leg["stats"] = got
            out[f"2x1 {mode}"] = leg
            del run, after, got
            if rank == 0:
                # What the planted and 1x2 steps still read: sync's
                # step-1 momentum and params.
                ref[mode]["kept"] = {k: v for k, v in ref[mode]["kept"].items()
                                     if sync_leg and k in ("m1", 1)}
            release_memory()
            save()
            mesh_s += time.perf_counter() - t1
            if sync_leg:
                mesh_s += planted_step(ref.get("sync"), mesh21)
                mesh_s += tp_step(ref.get("sync"), p0)
                if rank == 0:
                    ref["sync"]["kept"] = {}
                release_memory()
        del ref, p0
        release_memory()
        t1 = time.perf_counter()
        # One sync step FSDP_MEM_LAYERS deep: the bytes allocated as each
        # layer's gathers end, and the step's peak.
        run = fsdp_run(dev, cut_arch(FSDP_ARCH, FSDP_MEM_LAYERS), "sync",
                       mesh21, steps=1, record_step=1, say=say)
        out[f"2x1 sync {FSDP_MEM_LAYERS} layers"] = reading(run)
        out["mesh_s"] = mesh_s + time.perf_counter() - t1
        del run
        save()
        t1 = time.perf_counter()
        say("2x1 serve")
        out["2x1 serve"] = fsdp_serve_leg(dev, arch, mesh21)
        out["serve_s"] = time.perf_counter() - t1
        save()
    except Exception as e:      # noqa: BLE001 (reported, then raised)
        out["error"] = f"{type(e).__name__}: {e}"
        save()
        raise
    finally:
        dist.destroy_process_group()
    return 0


def fsdp_mesh_path(dev) -> dict:
    """Phase 14: deepseek-67b at full width, 1 layer, FSDP over two gloo
    ranks on the one card (FSDP_LEG): rank 0's one-process reference and
    witness, the 2x1 sync and aggregate-ring legs within 2x the witness
    (capped at LM_CEILING) with the step-1 gradient held to 2x its
    witness, sync's step-1 params elementwise and stale-psum's grad_norms
    to FSDP_NORM_REL, the planted step parting past the step-1 gradient's
    limit, the 2-layer step's memory
    (``memory_check``), and each rank's stale-psum peak below the
    one-process peak. The ranks print their progress as they go."""
    import gc
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    failures, out = [], {}
    serve_ref = fsdp_serve_reference(dev)
    with tempfile.TemporaryDirectory() as tmp:
        done = run_ranks("--fsdp-mesh-rank", FSDP_RANKS, tmp, dev.type,
                         timeout=600)
        ranks = []
        for r, (rc, _) in enumerate(done):
            path = os.path.join(tmp, f"rank{r}.pt")
            ranks.append(torch.load(path, weights_only=False)
                         if os.path.exists(path) else {})
            if rc != 0 or "error" in ranks[-1]:
                failures.append(f"fsdp mesh rank {r} exited {rc}: "
                                f"{ranks[-1].get('error')}")
    zero = expect(1)
    ref = ranks[0].get("reference", {})
    limits = {}
    for mode, run in ref.items():
        wit = run["witness"]
        limits[mode] = {k: min(max(WITNESS_FACTOR * wit[k], LM_FLOOR[k]),
                               LM_CEILING[k]) for k in ("loss", "rel")}
        print(f"fsdp one process {mode}: losses {run['losses']} grad_norms "
              f"{run['grad_norms']}; ms a step {ms_after_first(run)!r}; "
              f"peak {run['peak_mem_gb']:.2f} GB; witness "
              f"{json.dumps(wit)}; limit {json.dumps(limits[mode])}")
        out[f"one process {mode}"] = dict(
            reading_row(run), ms_per_step=ms_after_first(run), witness=wit,
            limit=limits[mode])
        if run["launches"] != zero:
            failures.append(f"one process {mode}: launches {run['launches']}")
    # The step-1 gradient (the momentum after step 1) of each leg: 2x its
    # witness's distance, within LM_FLOOR and LM_CEILING.
    grad_limit = {mode: min(max(WITNESS_FACTOR * run["witness"]["grad_rel"],
                                LM_FLOOR["rel"]), LM_CEILING["rel"])
                  for mode, run in ref.items()}
    steps = FSDP_LEG["steps"]
    mem_label = f"2x1 sync {FSDP_MEM_LAYERS} layers"
    for r, got in enumerate(ranks):
        for label in ("2x1 sync", "2x1 stale-psum", "2x1 planted",
                      "1x2 sync", mem_label):
            leg = got.get(label)
            if leg is None:
                failures.append(f"{label} rank {r}: no result")
                continue
            moved = traffic_summary(leg.get("traffic", []))
            row = dict(reading_row(leg), ms_per_step=ms_after_first(leg),
                       traffic=moved)
            print(f"fsdp {label} rank {r}: losses {leg['losses']} grad_norms "
                  f"{leg['grad_norms']}; ms a step {row['ms_per_step']!r}; "
                  f"peak {leg['peak_mem_gb']:.2f} GB; pinned host "
                  f"{leg.get('host_pinned_gb', 0.0):.2f} GB"
                  + (f"; a step's data-axis traffic {json.dumps(moved)}"
                     if moved else ""))
            if leg["launches"] != zero:
                failures.append(f"{label} rank {r}: launches "
                                f"{leg['launches']}")
            if "collectives" in leg:
                print(f"fsdp {label} rank {r} profile: "
                      f"{json.dumps(leg['collectives'])}")
            if label == "2x1 stale-psum" and "stale-psum" in ref and not (
                    leg["peak_mem_gb"] < ref["stale-psum"]["peak_mem_gb"]):
                failures.append(f"{label} rank {r}: peak "
                                f"{leg['peak_mem_gb']:.2f} GB not below the "
                                "one process's "
                                f"{ref['stale-psum']['peak_mem_gb']:.2f}")
            stats = leg.get("stats", {})
            if r == 0 and label in ("2x1 sync", "2x1 stale-psum"):
                mode = label.split()[1]
                dist_ = {"loss": leg["loss"],
                         "rel": stats[f"params@{steps}"]["rel"]}
                over = [k for k in dist_ if dist_[k] > limits[mode][k]]
                print(f"fsdp {label}: vs one process {json.dumps(dist_)} "
                      f"(limit {json.dumps(limits[mode])})")
                row["distance"] = dist_
                if over:
                    failures.append(f"{label}: {dist_} over {limits[mode]} "
                                    f"on {over}")
            if r == 0 and label in ("2x1 sync", "2x1 stale-psum"):
                mode = label.split()[1]
                gr = stats["m1@1"]["rel"]
                print(f"fsdp {label} step-1 gradient rel {gr!r} (limit "
                      f"{grad_limit[mode]!r})")
                row["grad_rel"] = gr
                if gr > grad_limit[mode]:
                    failures.append(f"{label} step-1 gradient rel {gr} over "
                                    f"{grad_limit[mode]}")
            if r == 0 and label == "2x1 sync":
                s1 = stats["params@1"]
                print(f"fsdp 2x1 sync step 1: params "
                      f"{json.dumps(without_leaves(s1))} (share limit "
                      f"{FSDP_FLIP_SHARE})")
                row["step1"] = without_leaves(s1)
                if not (s1["within_tol_or_ulp"]
                        and s1["share"] <= FSDP_FLIP_SHARE):
                    failures.append(f"2x1 sync step 1: {s1}")
            if label == "2x1 stale-psum" and "stale-psum" in ref:
                want = ref["stale-psum"]["grad_norms"]
                rels = [abs(a - b) / abs(b)
                        for a, b in zip(leg["grad_norms"], want)]
                print(f"fsdp {label} rank {r}: grad_norm rel a step {rels} "
                      f"(limit {FSDP_NORM_REL})")
                row["grad_norm_rel"] = rels
                if len(rels) != steps or max(rels) > FSDP_NORM_REL:
                    failures.append(f"{label} rank {r}: grad_norms "
                                    f"{leg['grad_norms']} against {want}")
            if r == 0 and label == "1x2 sync" and "sync" in ref:
                # Tensor-parallel: the row-parallel sums and the
                # vocab-parallel cross-entropy add in another order, so
                # step 1 is held as the 2x1 batch split's is.
                s1, gr = stats["params@1"], stats["m1@1"]["rel"]
                dloss = abs(leg["losses"][0] - ref["sync"]["losses"][0])
                print(f"fsdp 1x2 sync ({leg.get('model_compute')}): step-1 "
                      f"loss {dloss!r} (limit {limits['sync']['loss']!r}), "
                      f"gradient rel {gr!r} (limit {grad_limit['sync']!r}), "
                      f"params {json.dumps(without_leaves(s1))} (share "
                      f"limit {FSDP_FLIP_SHARE})")
                row.update(step1=without_leaves(s1), grad_rel=gr, loss=dloss)
                if not (leg.get("model_compute") == "tensor-parallel"
                        and dloss <= limits["sync"]["loss"]
                        and gr <= grad_limit["sync"]
                        and s1["within_tol_or_ulp"]
                        and s1["share"] <= FSDP_FLIP_SHARE):
                    failures.append(f"1x2 sync: {leg.get('model_compute')}, "
                                    f"loss {dloss}, gradient rel {gr}, "
                                    f"step 1 {s1}")
            if r == 0 and label == "2x1 planted":
                gr = stats["m1@1"]["rel"]
                print(f"fsdp 2x1 planted (each rank's own half-batch "
                      f"gradient for the reduce-scatter): step-1 gradient "
                      f"rel {gr!r} (limit {grad_limit['sync']!r})")
                row["grad_rel"] = gr
                if not gr > grad_limit["sync"]:
                    failures.append(f"planted: gradient rel {gr} within "
                                    f"{grad_limit['sync']}")
            if label == mem_label and "2x1 sync" in got:
                row["memory"] = memory_check(
                    leg, got["2x1 sync"], f"{label} rank {r}", failures)
            out[f"{label} rank {r}"] = row
    out["one process serve"] = {k: serve_ref[k] for k in (
        "served_gb", "cache_gb", "boot_peak_gb", "peak_gb",
        "ms_per_decode_step", "counts")}
    for r, got in enumerate(ranks):
        out[f"2x1 serve rank {r}"] = check_fsdp_serve(
            got.get("2x1 serve"), serve_ref, r, failures)
    for r, got in enumerate(ranks):
        print(f"fsdp mesh rank {r}: reference "
              f"{got.get('reference_s', 0.0):.1f} s, mesh legs "
              f"{got.get('mesh_s', 0.0):.1f} s, serve "
              f"{got.get('serve_s', 0.0):.1f} s")
    print(f"fsdp mesh phase: {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("fsdp mesh phase: " + "; ".join(failures))
    return out


def fsdp_serve_reference(dev) -> dict:
    """The FSDP serve's one-process run (``fsdp_serve_leg`` with no mesh),
    here before the ranks get the leg, under the ranks' settings
    (deterministic algorithms, no TF32)."""
    import torch
    settings = (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        ref = fsdp_serve_leg(dev, cut_arch(FSDP_ARCH, FSDP_LEG["layers"]))
    finally:
        torch.use_deterministic_algorithms(settings[0],
                                           warn_only=settings[1])
        torch.backends.cuda.matmul.allow_tf32 = settings[2]
    print(f"fsdp serve one process: {ref['served_gb']:.3f} GB served, "
          f"{ref['ms_per_decode_step']!r} ms a decode step, init peak "
          f"{ref['boot_peak_gb']:.3f} GB, serve peak "
          f"{ref['peak_gb']:.3f} GB, counts {ref['counts']}, "
          f"{time.perf_counter() - t0:.1f} s")
    return ref


def check_fsdp_serve(leg, ref: dict, r: int, failures: list) -> dict:
    """Hold rank ``r``'s 2x1 FSDP serve (``fsdp_serve_leg``) against the
    one-process run ``ref`` (FSDP_SERVE's checks); prints its readings and
    returns them."""
    label = f"fsdp 2x1 serve rank {r}"
    if leg is None:
        failures.append(f"{label}: no result")
        return {}
    slack = FSDP_SERVE_SLACK_GB
    rest = leg["served_gb"] + leg["cache_gb"] + slack
    peak_limit = rest + 2 * leg["largest_read_gb"]
    steps = leg["reads"]
    step_gb = [sum(g for _, g in reads) for reads in steps]
    held = max([g for _, g in leg["before_read_gb"]] + leg["after_step_gb"])
    row = {k: leg[k] for k in (
        "served_gb", "blocks_gb", "whole_gb", "cache_gb", "boot_peak_gb",
        "peak_gb",
        "largest_read_gb", "ms_per_decode_step", "counts", "whole_gathers")}
    row.update(gathered_gb_a_step=step_gb, held_between_reads_gb=held,
               peak_limit_gb=peak_limit)
    same = leg["tokens"] == ref["tokens"]
    parted = leg["planted_tokens"] != ref["tokens"]
    print(f"{label}: tokens {'equal' if same else 'DIFFER from'} "
          f"the one process's; {leg['served_gb']:.3f} of "
          f"{leg['whole_gb']:.3f} GB served (its blocks "
          f"{leg['blocks_gb']:.3f}), cache {leg['cache_gb']:.4f} GB; "
          f"{leg['ms_per_decode_step']!r} ms a decode step (one process "
          f"{ref['ms_per_decode_step']!r}); {step_gb} GB gathered a decode "
          f"step ({[len(x) for x in steps]} gathers, a pass "
          f"{leg['gathers']}, {leg['sharded_gb']:.3f} GB); init peak "
          f"{leg['boot_peak_gb']:.3f} GB (one process "
          f"{ref['boot_peak_gb']:.3f}); serve peak "
          f"{leg['peak_gb']:.3f} GB (limit {peak_limit:.3f}: the largest "
          f"read {leg['largest_read_gb']:.3f} twice); allocated before a "
          f"read or after a step at most {held:.3f} GB (limit "
          f"{rest:.3f}); whole gathers {leg['whole_gathers']}; planted "
          f"tokens {'part' if parted else 'EQUAL'}")
    checks = {
        "tokens": same,
        "counts": leg["counts"] == ref["counts"],
        "route": leg["route"] == ref["route"] == ("gather", "FSDP placement"),
        "launches": leg["launches"] == expect(1),
        "whole gathers": leg["whole_gathers"] == 0,
        "served blocks": abs(leg["served_gb"] - leg["blocks_gb"]) < 1e-9
        and leg["served_gb"] < leg["whole_gb"],
        "peak": leg["peak_gb"] <= peak_limit,
        "reads dropped": held <= rest,
        "gathers a step": len(steps) == leg["counts"][0] and all(
            len(reads) == leg["gathers"]
            and abs(g - leg["sharded_gb"]) < 1e-6
            for reads, g in zip(steps, step_gb)),
        "planted": parted,
    }
    failures.extend(f"{label}: {k} ({json.dumps(row, default=str)})"
                    for k, ok in checks.items() if not ok)
    return row


def memory_check(leg: dict, one_layer: dict, label: str,
                 failures: list) -> dict:
    """Phase 14's memory leg against the one-layer sync leg of the same
    rank: the bytes allocated as each layer's forward gathers end may not
    grow by half a gathered layer from the first layer's (a layer's
    gathered leaves are gone before the next layer's gather), and the
    step-1 peak may grow by at most the added layer's shard at the
    update (FSDP_UPDATE_BYTES an element) plus half a gathered layer."""
    from repro_torch import configs as cfglib
    gathers = [e for e in leg.get("traffic", [])
               if e[0] == "data.gather" and e[1] == "layers"]
    n = FSDP_MEM_LAYERS
    # Under remat the backward pass gathers each layer again.
    passes = 2 if cfglib.get(FSDP_ARCH).api().cfg.remat else 1
    if not gathers or len(gathers) % (passes * n):
        failures.append(f"{label}: {len(gathers)} layer gathers, not "
                        f"{passes} passes over {n} layers")
        return {}
    k = len(gathers) // (passes * n)     # leaves a layer, each gathered
    ends = [gathers[(i + 1) * k - 1][4] / 1e9 for i in range(passes * n)]
    layer = sum(e[3] for e in gathers[:k]) / 1e9
    forward = max(ends[:n]) - ends[0]
    # The gathered layer is bf16 at step 1: its shard's elements (G).
    state = FSDP_UPDATE_BYTES * layer / 2 / FSDP_RANKS
    growth = leg["peak_by_step"][0] - one_layer["peak_by_step"][0]
    out = {"layer_gb": layer, "forward_ends_gb": ends[:n],
           "backward_ends_gb": ends[n:], "forward_growth_gb": forward,
           "peak_gb": leg["peak_by_step"][0],
           "one_layer_peak_gb": one_layer["peak_by_step"][0],
           "peak_growth_gb": growth, "added_update_gb": state}
    print(f"fsdp {label}: a gathered layer {layer:.3f} GB; allocated as "
          f"each layer's forward gathers end {ends[:n]} GB (growth "
          f"{forward:.3f}, limit {layer / 2:.3f}), in the backward pass "
          f"{ends[n:]}; step-1 peak {leg['peak_by_step'][0]:.3f} GB against "
          f"{one_layer['peak_by_step'][0]:.3f} at one layer: growth "
          f"{growth:.3f} GB (the added layer's shard at the update "
          f"{state:.3f}, limit "
          f"{state + layer / 2:.3f})")
    if not forward < layer / 2:
        failures.append(f"{label}: the forward gathers grow {forward} GB, a "
                        f"gathered layer is {layer} GB")
    if not growth <= state + layer / 2:
        failures.append(f"{label}: the peak grows {growth} GB over one "
                        f"layer's, the added shard at the update is {state} "
                        "GB")
    return out


def reading_row(run: dict) -> dict:
    return {k: run.get(k) for k in ("losses", "grad_norms", "wall_s",
                                    "peak_mem_gb", "collectives")}


def ms_after_first(run: dict) -> float:
    """Host ms a step after the first (which warms the allocator up)."""
    rest = run["wall_s"][1:] or run["wall_s"]
    return 1e3 * sum(rest) / len(rest)


def traffic_summary(traffic: list) -> dict:
    """{kind: [count, GB]} of one step's data-axis collectives."""
    out = {}
    for kind, _name, _shape, nbytes, *_ in traffic:
        row = out.setdefault(kind, [0, 0.0])
        row[0] += 1
        row[1] += nbytes / 1e9
    return out


# -- phase 15: tensor-parallel compute on the model axis ---------------------------

# Full-width transformers, their depth cut, at 1x2 over two gloo ranks on
# the one card: each rank holds its model-axis shards and computes on them
# (``meta["model_compute"] == "tensor-parallel"``): danube in ``mixed``
# attention (32 q heads, 8 kv heads at tp 16), qwen3-14b in
# ``contraction`` (40 heads), qwen2-moe-a2.7b's 64 experts 32 a rank. B 4 x
# 256, bf16 compute over fp32 params, remat on, a leg's "steps" steps,
# kernels on, the delays of TP_DELAYS. A leg: its label, arch, depth,
# steps, mode, optimizer, engine settings (``kw``) and launches a step on
# the mesh run. qwen3 at one layer holds 1.89 B params (7.6 GB in fp32):
# its one-process reference trains with SGD, which keeps no moments. The
# danube legs' witness parts as far as a 1x2 run only after a few steps:
# at 2 layers and 2 steps its loss parted 1.7e-4, the 1x2 stale-psum
# run's step 1 3.6e-4 (the H100), so they run 4 layers and 3 steps. Per
# leg, rank 0 runs it as one process (the reference) and from
# one-ulp-nudged params (the witness; the MoE leg also from params nudged
# one ulp down, a second witness it prints) while rank 1 waits; both ranks
# run it at 1x2, held within 2x the witness (capped at LM_CEILING) and
# step 1 leaf by leaf (``step1_leaves``); one step with "reduce" dropped
# (each rank keeps its partial sums: planted, once an arch), which must
# part; one step on the gathered route (the shards made whole for the
# loss by ``placement.full``'s c10d gather), bit for bit the reference's
# step 1, whose step-1 gradient's peak (the forward and backward pass)
# each rank's tensor-parallel one must fall below.
TP_RANKS = 2
TP_LEG = dict(batch=4, seq=256, workers=2, stale=2)
TP_DELAYS = ((0, 0), (1, 0), (1, 1))     # [step, worker]; aggregate: [:, 1]
# ``on_card``: the reference's copies (the init, step 1's and the last
# step's params) stay on the card, where they fit beside two ranks' runs
# (qwen3: 3 x 7.6 GB beside 16 GB a rank); the MoE's Adam reference peaks
# at 68.7 GB, so its copies wait on the host.
TP_DANUBE = dict(arch="h2o-danube-1.8b", layers=4, steps=3, on_card=True)
TP_LEGS = (
    dict(TP_DANUBE, label="danube sync adam", mode="sync", opt="adam",
         kw={}, launches=dict(fused_adam=1), planted=True),
    dict(TP_DANUBE, label="danube stale-psum adam", mode="stale-psum",
         opt="adam", kw={}, launches=dict(fused_update_plain=1)),
    dict(TP_DANUBE, label="danube stale-psum sgd topk", mode="stale-psum",
         opt="sgd", kw=dict(compress="topk:0.01"),
         launches=dict(sparsify_topk=1, stale_accum=1)),
    dict(label="qwen3 sync sgd", arch="qwen3-14b", layers=1, steps=2,
         mode="sync", opt="sgd", kw={}, launches={}, planted=True,
         on_card=True, serve=True),
    dict(label="moe stale-psum sgd", arch="qwen2-moe-a2.7b", layers=1,
         steps=2, mode="stale-psum", opt="sgd",
         kw=dict(per_worker_delays=False), launches=dict(stale_accum=1),
         planted=True, on_card=True, serve=True),
    # The MoE under Adam: its 1x2 loss parts 2.5e-3 from one process at
    # step 2, 2.8x its witness's, though its step-1 params lie closer than
    # the witness's in every leaf (PERF.md section 7). Held in params, in
    # step 1 (loss and leaves) and in all but its later losses, which are
    # printed beside a second witness and ``probe``: the one-process loss
    # of step 2's batch from the 1x2 run's step-1 params.
    dict(label="moe stale-psum adam", arch="qwen2-moe-a2.7b", layers=1,
         steps=2, mode="stale-psum", opt="adam",
         kw=dict(per_worker_delays=False),
         launches=dict(fused_update_plain=1), witnesses=2, probe=True,
         loss_held_steps=1),
)
# The planted step must part from the reference's step 1 by more than this
# (in loss and in the step's params, relative to their move).
TP_PLANTED = dict(loss=LM_CEILING["loss"], rel=LM_CEILING["rel"])
# The legs marked ``serve`` (qwen3-14b, contraction: whole heads on every
# rank; the MoE, head mode: 8 of 16 heads a rank, 32 of 64 experts) then
# serve TP_SERVE_REQUESTS greedy requests (SERVE, paged route) from the
# leg's initial params: the script as one process and from them nudged
# one ulp up (the witness), before the ranks start; then after the leg
# both ranks on their shards at 1x2, unrecorded and teacher-forced with
# the one process's tokens, held to the witness's limits as phase 13
# holds its 1x2 serve (``witness_limits``).
TP_SERVE_REQUESTS, TP_SERVE_NEW_TOKENS = 8, (16, 32)
# paged_attention at a rank's heads on the tensor-parallel serves (phase
# 13's danube: 16 q over 4 kv heads; the MoE 8 / 8; qwen3 40 / 8, whole
# heads), held against its plain version and timed on a rank's pool at
# the arch's full depth (as SERVE_TIMING: 28 pages held, position 176).
TP_PAGED_GRID = (
    ("tp danube", (16, 4, 80), 8, 512, 24, 23, (4096, 16, 0)),
    ("tp qwen2-moe", (8, 8, 128), 8, 512, 24, 11, (0, 16)),
    ("tp qwen3", (40, 8, 128), 8, 512, 40, 39, (0, 16)),
)
TP_TIMING = {name: dict(heads=heads, t=t, tokens=tokens, layers=layers,
                        held=28, pos=176)
             for name, heads, t, tokens, layers, _, _ in TP_PAGED_GRID}


def tp_engine(dev, leg, mesh=None):
    """A phase-15 leg's engine through ``make_train_engine``."""
    import numpy as np
    from repro_torch import delays
    from repro_torch.configs.base import InputShape
    from repro_torch.engine.plan import make_train_engine
    arch, layers, mode, kw = leg["arch"], leg["layers"], leg["mode"], leg["kw"]
    f = TP_LEG
    shape = InputShape("train_tp", f["seq"], f["batch"], "train")
    kw = dict(kw)
    if mode != "sync":
        table = np.asarray(TP_DELAYS)
        if not kw.get("per_worker_delays", True):
            table = table[:, 1]
        kw.update(stale_s=f["stale"], delay=delays.Schedule(table))
    return make_train_engine(cut_arch(arch, layers), shape, mesh, mode=mode,
                             num_workers=f["workers"], kernels="on",
                             optimizer_name=leg["opt"], device=dev, **kw)


def tp_run(dev, leg, mesh=None, *, start=None, steps=None, after=None,
           record_step=None, profile=False, keep_init=False,
           say=print) -> dict:
    """One phase-15 leg: ``steps`` steps on the CLI's batches (seed 0),
    each step's wall time between device syncs, the launch counters zeroed
    just before the steps and read just after, the peak memory above what
    was allocated at the start (by step, and of each step's gradient),
    this rank's packed width, and after each step ``after(t, params,
    placement)``. ``keep_init``: the initial params on the host
    (``out["init"]``). ``record_step``: the
    model axis's collectives of that step; ``profile``: the last step under
    ``profile_collectives``."""
    import gc
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train

    from repro_torch.core import stale_sync

    steps = steps or leg["steps"]
    engine = tp_engine(dev, leg, mesh)
    api = cfglib.get(cut_arch(leg["arch"], leg["layers"])).api()
    batches = iter(train.make_batch_fn(api, TP_LEG["batch"], TP_LEG["seq"],
                                       0), None)
    place = engine.placement
    axis = getattr(place, "model_axis", None)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    box = [engine.init(0, params=start)]
    del start
    out = {"losses": [], "grad_norms": [], "sparsity": [], "wall_s": [],
           "peak_by_step": [], "grad_peak_by_step": [],
           "meta": engine.meta["kernels"],
           "model_compute": engine.meta.get("model_compute"),
           "width": tm.padded_size(tm.pack_spec(box[0].inner.params).total,
                                   dispatch.PACK_ALIGN)}
    if keep_init:
        out["init"] = ref_copy(leg, box[0].inner.params)
    # The gradient's peak (the forward and backward pass, where the two
    # routes differ): the peak counter is reset as it starts and read as
    # it ends; the optimizer's update, the same on both routes, follows.
    real_grad = stale_sync.value_and_grad

    def measured_grad(*args):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = real_grad(*args)
        torch.cuda.synchronize(dev)
        out["grad_peak_by_step"].append(
            (torch.cuda.max_memory_allocated(dev) - base) / 1e9)
        return got
    stale_sync.value_and_grad = measured_grad
    try:
        tp_steps(dev, leg, engine, box, batches, out, base, steps, after,
                 record_step, profile, say)
    finally:
        stale_sync.value_and_grad = real_grad
    out["peak_mem_gb"] = max(out["peak_by_step"])
    box.clear()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_steps(dev, leg, engine, box, batches, out: dict, base: int,
             steps: int, after, record_step, profile, say) -> None:
    """``tp_run``'s steps, each read into ``out`` (a step's peak counts
    from its gradient's start, above ``base`` bytes)."""
    import torch
    place = engine.placement
    axis = getattr(place, "model_axis", None)
    reset_counters()
    for t in range(1, steps + 1):
        if t == record_step and axis is not None:
            axis.record = []
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if profile and t == steps:
            last = []
            out["collectives"] = profile_collectives(
                engine, box.pop(), batches, 1,
                lambda: torch.cuda.synchronize(dev), warm=False, keep=last)
            state, m = last.pop()
        else:
            state, m = engine.step(box.pop(), next(batches))
        torch.cuda.synchronize(dev)
        out["wall_s"].append(time.perf_counter() - t0)
        if t == record_step and axis is not None:
            out["traffic"], axis.record = list(axis.record), None
        out["peak_by_step"].append(
            (torch.cuda.max_memory_allocated(dev) - base) / 1e9)
        for key, into in (("loss", "losses"), ("grad_norm", "grad_norms"),
                          ("sparsity", "sparsity")):
            if key in m:
                out[into].append(float(m[key]))
        say(f"{leg['label']} step {t}: loss {out['losses'][-1]!r}, "
            f"{out['wall_s'][-1]:.2f} s")
        del m
        if after is not None:
            after(t, state.inner.params, place)
        box.append(state)
        del state
    out["launches"] = counters()


def ref_copy(leg, params):
    """A copy of ``params`` kept for the comparisons: on the card for a
    leg marked ``on_card``, else on the host."""
    from repro_torch import treemath as tm
    if leg.get("on_card"):
        return tm.tree_map(lambda x: x.detach().clone(), params)
    return to_host(params)


def tp_reference(dev, leg, say=print) -> tuple:
    """Rank 0's one-process run of a leg (its initial params ``p0`` and
    its params after step 1 and the last step kept, ``ref_copy``) and its
    witness from ``p0`` nudged one ulp up (with ``witnesses=2`` a second,
    ``witness2``, nudged one ulp down), held against them as it runs.
    Returns ``(run, p0)``."""
    import gc
    from repro_torch import treemath as tm
    steps = leg["steps"]
    kept = {}

    def store(t, params, _place):
        if t in (1, steps):
            kept[t] = ref_copy(leg, params)

    run = tp_run(dev, leg, after=store, keep_init=True, say=say)
    p0 = run.pop("init")
    run["kept"] = kept
    run["names"] = leaf_names(p0)
    for key, toward in (("witness", float("inf")),
                        ("witness2", float("-inf")))[:leg.get("witnesses",
                                                              1)]:
        wit = {}

        def against(t, params, _place):
            if t in (1, steps):
                wit[t] = tree_stats(dev, params, kept[t], p0)

        wrun = tp_run(dev, leg, start=nudged(
            tm.tree_map(lambda x: x.to(dev), p0), toward),
            after=against, say=say)
        run[key] = {
            "loss": max(abs(a - b) for a, b in zip(wrun["losses"],
                                                   run["losses"])),
            "rel": wit[steps]["rel"], "step1": wit[1], "last": wit[steps],
            "losses": wrun["losses"]}
        del wrun, wit
        gc.collect()
    return run, p0


def ipc_holder(rank: int, dev, at: tuple, want, p0, whole: bool = False):
    """An ``after`` that holds this step's shards of the params (after the
    steps in ``at``) against the whole params ``want[t]`` on rank 0 (with
    ``p0`` as the base of ``rel``): rank 1 shares its shards through CUDA
    IPC (the two ranks share the card), rank 0 reads them in place and
    compares each rank's block (``piece_stats``). With ``whole`` rank 0
    also keeps step 1's params made whole on the host (``got["whole"]``).
    Every rank makes the same calls. Returns ``(after, got)``, ``got``
    filled on rank 0."""
    import torch
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    from repro_torch import treemath as tm
    got = {}

    def after(t, params, place):
        if t not in at:
            return
        mine = tm.tree_leaves(params)
        box = [[reduce_tensor(x) for x in mine] if rank else None]
        dist.broadcast_object_list(box, src=1)
        if rank == 0:
            other = [fn(*args) for fn, args in box[0]]
            ref_leaves = tm.tree_leaves(want[t])
            bases = tm.tree_leaves(p0)
            pieces = []
            for i, (dims, shape) in enumerate(zip(place._dims,
                                                  place.full_shapes)):
                for r, x in ((0, mine[i]), (1, other[i])):
                    pieces.append((x, block_of(place, r, ref_leaves[i], dims,
                                               shape),
                                   block_of(place, r, bases[i], dims, shape),
                                   i))
            got[t] = piece_stats(dev, pieces)
            if whole and t == 1:
                got["whole"] = tm.tree_unflatten(
                    tm.tree_flatten(want[t])[1],
                    [(a if dims[1] is None else torch.cat([a, b], dims[1]))
                     .cpu() for a, b, dims in zip(mine, other, place._dims)])
            del other, pieces
        dist.barrier()
    return after, got


def without_leaves(stats: dict) -> dict:
    """A ``piece_stats`` reading without its per-leaf part."""
    return {k: v for k, v in stats.items() if k != "leaves"}


def leaf_table(stats: dict, names: list) -> str:
    """A ``piece_stats`` reading leaf by leaf: ``name rel/share``."""
    return "; ".join(f"{names[i]} {v['rel']:.3g}/{v['share']:.3g}"
                     for i, v in sorted(stats["leaves"].items()))


def step1_leaves(s1: dict, wit1: dict, names: list) -> list:
    """The leaves whose step-1 reading ``s1`` parts past its limit: a
    leaf's ``rel`` and its share outside TOL_FIRST may each be
    WITNESS_FACTOR times the larger of the witness's (``wit1``) for that
    leaf and for the whole tree (the share at least FIRST_FLIP_SHARE). A
    leaf whose gradient misses its sum over the ranks (a dropped
    ``copy``; 0.83 in rel and 57% of the elements of the MoE router's on
    the CPU) parts past that however small it is."""
    bad = []
    for i, got in sorted(s1["leaves"].items()):
        w = wit1["leaves"][i]
        rel = WITNESS_FACTOR * max(w["rel"], wit1["rel"])
        share = max(FIRST_FLIP_SHARE,
                    WITNESS_FACTOR * max(w["share"], wit1["share"]))
        if got["rel"] > rel or got["share"] > share:
            bad.append({"leaf": names[i], "rel": got["rel"],
                        "rel_limit": rel, "share": got["share"],
                        "share_limit": share})
    return bad


# A rank's row-parallel products in phase 15 (name, contracted width,
# output width; B 4 x 256 rows): danube's ``w_down`` (6912 / 2) and
# mixed-mode ``wo`` (16 of 32 heads of 80), qwen3's ``w_down``
# (17408 / 2).
TP_PRODUCTS = (("danube w_down", 3456, 2560), ("danube wo", 1280, 2560),
               ("qwen3 w_down", 8704, 5120))


def tp_product_timings(dev) -> dict:
    """Each of TP_PRODUCTS, forward and backward as autograd runs it, in
    three ways: an fp32 result from bf16 operands on the tensor cores
    (``models.layers.contract_f32``, the port's), both operands cast to
    fp32 first (fp32 CUDA cores, TF32 off), and a bf16 result (the partial
    rounded before its sum over the ranks). ms by ``time_ms`` (the
    device's, graph replay). ``contract_f32`` is first held against the
    fp32 product through autograd: forward and both gradients."""
    import torch
    from repro_torch.models import layers as L
    t = TP_LEG["batch"] * TP_LEG["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    out = {}
    for name, k, n in TP_PRODUCTS:
        a = torch.randn(t, k, generator=gen, device=dev).to(bf)
        w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(bf)
        g = torch.randn(t, n, generator=gen, device=dev).to(bf)
        g32 = g.float()
        errs = {}
        for way, fn in (("port", lambda x, y: L.contract_f32(x, y, 1)),
                        ("fp32", lambda x, y: x.float() @ y.float())):
            x, y = (v.clone().requires_grad_(True) for v in (a, w))
            r = fn(x, y)
            r.backward(g32)
            errs[way] = (r.detach(), x.grad, y.grad)
        err = [max_abs(u, v) for u, v in zip(errs["port"], errs["fp32"])]
        scale = [float(v.float().abs().max()) for v in errs["fp32"]]
        # fp32 sums of k terms in two orders: each within k units of
        # roundoff of the sum of the terms' sizes.
        worst = float(((errs["port"][0] - errs["fp32"][0]).abs()
                       / (a.float().abs() @ w.float().abs())).max())
        ways = {
            "port": (lambda: torch.mm(a, w, out_dtype=torch.float32),
                     lambda: (g @ w.t(), a.t() @ g)),
            "fp32 operands": (lambda: a.float() @ w.float(),
                              lambda: ((g32 @ w.float().t()).to(bf),
                                       (a.float().t() @ g32).to(bf))),
            "bf16 result": (lambda: a @ w,
                            lambda: (g @ w.t(), a.t() @ g)),
        }
        row = {"max_abs_err": err, "scale": scale, "forward_rel": worst}
        for way, (fwd, bwd) in ways.items():
            f_ms = time_ms(lambda: fwd(), [()], reps=30)[0]
            b_ms = time_ms(lambda: bwd(), [()], reps=30)[0]
            row[way] = {"forward_ms": f_ms, "backward_ms": b_ms,
                        "ms": f_ms + b_ms}
        out[name] = row
        print(f"tp product {name} [{t}, {k}] @ [{k}, {n}]: port vs fp32 "
              f"product max_abs_err (out, da, dw) {err} of {scale} (out "
              f"{worst!r} of the terms' sizes); ms "
              f"forward + backward: " + ", ".join(
                  f"{way} {row[way]['ms']:.4f} ({row[way]['forward_ms']:.4f}"
                  f" + {row[way]['backward_ms']:.4f})" for way in ways))
        # The bf16 gradients round once, from sums in another order: one
        # bf16 ulp of the largest element.
        if not (worst <= k * 2 ** -24
                and all(e <= 2 ** -7 * sc for e, sc in zip(err[1:],
                                                           scale[1:]))):
            raise AssertionError(f"contract_f32 {name}: {err} of {scale}, "
                                 f"forward {worst} of the terms' sizes")
        del a, w, g, g32, errs
    torch.cuda.empty_cache()
    return out


def probe_losses(dev, leg, trees: dict) -> dict:
    """The one-process loss (``ModelAPI.loss``, forward only) of the leg's
    second batch from each tree of params in ``trees``; from the
    reference's params after step 1 it is the reference's step-2 loss
    again (the aggregate ring takes the loss of the whole batch)."""
    import torch
    from repro_torch import configs as cfglib
    from repro_torch import treemath as tm
    from repro_torch.launch import train
    api = cfglib.get(cut_arch(leg["arch"], leg["layers"])).api()
    batches = train.make_batch_fn(api, TP_LEG["batch"], TP_LEG["seq"], 0)
    batches()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batches().items()}
    out = {}
    for name, params in trees.items():
        params = tm.tree_map(lambda x: x.to(dev), params)
        with torch.no_grad():
            out[name] = float(api.loss(params, batch))
        del params
        release_memory()
    return out


def forced_serve(dev, arch: str, params, mesh=None, force=None,
                 probe=None) -> dict:
    """TP_SERVE_REQUESTS greedy requests of ``arch`` (SERVE, the paged
    route) on ``mesh`` from whole ``params`` (None: the server's own init
    from seed 0), after a one-request warm-up: once unrecorded (its served
    tokens, launch counters and ms a decode step) and once under
    ``Forcing`` (``force``: the tokens it feeds), its record; the served
    params' and the pool's GB, the model axis's route and whole gathers,
    and ``probe(server)``'s reading where given."""
    import torch
    from repro_torch.serving import Server, ServingConfig
    server = Server(ServingConfig(arch=arch, reduced=False, paged="on",
                                  **SERVE), params=params, device=dev,
                    mesh=mesh)
    del params
    vocab = server.api.vocab_real
    server.run(serve_requests(vocab, 1, new_tokens=(2, 2)))
    torch.cuda.synchronize(dev)
    before = server.decode_steps
    reset_counters()
    rep = server.run(serve_requests(vocab, TP_SERVE_REQUESTS,
                                    TP_SERVE_NEW_TOKENS))
    steps = rep.decode_steps - before
    out = {"launches": counters(),
           "tokens": {r.rid: r.tokens for r in rep.completed},
           "decode_steps": steps,
           "ms_per_decode_step": 1e3 * rep.phase_s["decode"] / steps,
           "served_gb": tree_gb(server.params),
           "pool_gb": tree_gb(server.cache.pages),
           "model_compute": server.model_compute,
           "whole_gathers": (server.placement.whole_gathers
                             if server.placement is not None else None),
           "probe": None if probe is None else probe(server)}
    with Forcing(server, force) as rec:
        server.run(serve_requests(vocab, TP_SERVE_REQUESTS,
                                  TP_SERVE_NEW_TOKENS))
    out["record"] = rec.record()
    del server
    release_memory()
    return out


def tp_serve_reference(dev, leg) -> dict:
    """A ``serve`` leg's one-process reference (``forced_serve`` of its
    cut arch from the seeded init, the leg's initial params) and its
    witness (those params nudged one ulp up, teacher-forced): the
    reference's readings and record, the limits (``witness_limits``) and
    the seconds both took."""
    from repro_torch import configs as cfglib
    arch = cut_arch(leg["arch"], leg["layers"])
    t0 = time.perf_counter()
    p0 = cfglib.get(arch).api().init(0, device=dev)[0]
    ref = forced_serve(dev, arch, p0)
    wit = forced_serve(dev, arch, nudged(p0), force=ref["record"]["picks"])
    del p0
    limits = witness_limits(ref["record"], wit["record"])
    del wit
    release_memory()
    return dict(ref, limits={k: limits[k] for k in ("witness", "rel",
                                                   "margin")},
                reference_s=time.perf_counter() - t0)


def serve_record_path(out_dir: str, label: str) -> str:
    return os.path.join(out_dir, f"serve_record_{label.replace(' ', '_')}.pt")


def tp_serve_leg(dev, leg, mesh, rank: int, p0, force: dict, out_dir: str,
                 say=print) -> dict:
    """A ``serve`` leg's serve on the ranks: each serves its shards of the
    server's own seeded init at 1x2 (rank 0 checks they are its shards of
    the leg's initial params ``p0``), unrecorded and then teacher-forced
    with the one-process reference's tokens ``force`` (``forced_serve``).
    Rank 0 saves its record (``serve_record_path``); every rank returns
    its readings and its logits' checksum."""
    import torch
    from repro_torch import treemath as tm
    arch = cut_arch(leg["arch"], leg["layers"])

    def shards_of_p0(server):
        if rank != 0:
            return None
        want = server.placement.from_whole(
            tm.tree_map(lambda x: x.to(dev), p0))
        return all(torch.equal(a, b) for a, b in zip(
            tm.tree_leaves(server.params), tm.tree_leaves(want)))

    t1 = time.perf_counter()
    tp = forced_serve(dev, arch, None, mesh, force=force,
                      probe=shards_of_p0)
    record = tp.pop("record")
    out = {"tp": tp, "tp_s": time.perf_counter() - t1,
           "checksum": float(sum(x.double().sum()
                                 for x in record["logits"].values()))}
    if rank == 0:
        torch.save(record, serve_record_path(out_dir, leg["label"]))
    say(f"{leg['label']} serve: 1x2 {out['tp_s']:.1f} s")
    return out


def check_tp_serve(label: str, ref: dict, legs: list, record,
                   failures: list) -> dict:
    """Phase 15's serve of one leg: ``ref`` (``tp_serve_reference``) and
    each rank's ``tp_serve_leg``, rank 0's teacher-forced ``record`` held
    to the witness's limits (``held_forced``), each rank's unrecorded
    tokens equal to the reference's up to a near-tie, and every rank's
    route (no model-axis gather), launches (a layer a decode step) and
    logits (their checksum) the same; prints and returns the readings."""
    serves = [leg.get("serve") for leg in legs]
    if not all(serves) or record is None:
        failures.append(f"{label} serve: no result")
        return {}
    first = serves[0]
    limits = ref["limits"]
    layers = next(leg for leg in TP_LEGS if leg["label"] == label)["layers"]
    want = expect(ref["decode_steps"], paged_attention=layers)
    keys = ("decode_steps", "ms_per_decode_step", "served_gb", "pool_gb",
            "model_compute", "whole_gathers")
    held = held_forced(f"tp {label} serve 1x2 rank 0 (teacher-forced)",
                       record, ref["record"], limits, failures)
    row = {"one process": {k: ref[k] for k in keys}, **limits, **held,
           "reference_s": ref["reference_s"], "tp_s": first["tp_s"]}
    if not first["tp"]["probe"]:
        failures.append(f"{label} serve: rank 0's shards are not those of "
                        "the leg's initial params")
    if ref["launches"] != want:
        failures.append(f"{label} serve one process: launches "
                        f"{ref['launches']} != {want}")
    for r, serve in enumerate(serves):
        got = serve["tp"]
        part = parting(got["tokens"], ref["record"], limits["margin"])
        print(f"tp {label} serve rank {r} (unrecorded): "
              f"{got['model_compute']}; served tokens part from the "
              f"reference's before a near-tie in {len(part['parted'])} "
              f"requests {part['parted']}; served params "
              f"{got['served_gb']:.3f} GB against one process's "
              f"{ref['served_gb']:.3f}; pool {got['pool_gb']:.3f} GB (one "
              f"process {ref['pool_gb']:.3f}); "
              f"{got['ms_per_decode_step']:.2f} ms a decode step (one "
              f"process {ref['ms_per_decode_step']:.2f}); launches "
              f"{got['launches']['paged_attention']} over "
              f"{got['decode_steps']} decode steps")
        row[f"rank {r}"] = {k: got[k] for k in keys} | {
            "launches": got["launches"]["paged_attention"],
            "parted": part["parted"]}
        if part["parted"]:
            failures.append(f"{label} serve rank {r}: tokens part before a "
                            f"near-tie {part['parted']}")
        if got["model_compute"] != ("tensor-parallel", "") or \
                got["whole_gathers"]:
            failures.append(f"{label} serve rank {r}: "
                            f"{got['model_compute']}, whole gathers "
                            f"{got['whole_gathers']}")
        if got["launches"] != want:
            failures.append(f"{label} serve rank {r}: launches "
                            f"{got['launches']} != {want}")
        if serve["checksum"] != first["checksum"]:
            failures.append(f"{label} serve rank {r}: its logits are not "
                            "rank 0's")
    return row


def tp_legs(only=()) -> tuple:
    """The TP_LEGS whose label holds one of the words ``only`` (all of
    them without words)."""
    return tuple(leg for leg in TP_LEGS
                 if not only or any(w in leg["label"] for w in only))


def tp_mesh_rank(rank: int, world: int, port: int, out_dir: str,
                 device: str = "cuda", *only: str) -> int:
    """``--tp-mesh-rank R WORLD PORT DIR DEVICE [WORD ...]``: one rank of
    phase 15 on the one card over ``gloo``, leg by leg (``tp_legs``): rank
    0's
    reference and witness while rank 1 waits, then on both ranks the 1x2
    run, the planted step and the gathered route's step, each held on rank
    0 against the reference through ``ipc_holder``. Saves its readings as
    ``DIR/rank<R>.pt`` after each leg."""
    import torch
    import torch.distributed as dist
    from repro_torch.engine import placement as placement_lib
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    # The gathered route's step is held bit for bit: the embedding's
    # backward accumulates bf16 rows in a fixed order.
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out = {}
    path = os.path.join(out_dir, f"rank{rank}.pt")
    t_start = time.perf_counter()

    def say(msg):
        print(f"tp rank {rank} +{time.perf_counter() - t_start:.1f} s: "
              f"{msg}", flush=True)

    def reading(run):
        return {k: run[k] for k in (
            "losses", "grad_norms", "sparsity", "wall_s", "peak_mem_gb",
            "peak_by_step", "grad_peak_by_step", "launches", "meta",
            "model_compute", "traffic", "collectives", "witness",
            "witness2", "width", "names") if k in run}

    def patched(obj, name, value, fn):
        real = getattr(obj, name)
        setattr(obj, name, value)
        try:
            return fn()
        finally:
            setattr(obj, name, real)

    try:
        mesh = make_host_mesh(1, world, device=dev.type)
        path_refs = os.path.join(out_dir, "serve_refs.pt")
        serve_refs = (torch.load(path_refs) if os.path.exists(path_refs)
                      else {})
        for leg in tp_legs(only):
            label = leg["label"]
            row = out[label] = {}
            t0 = time.perf_counter()
            ref = p0 = None
            if rank == 0:
                ref, p0 = tp_reference(dev, leg, say=say)
                row["reference"] = reading(ref)
            release_memory()
            dist.barrier()
            row["reference_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            kept = ref["kept"] if rank == 0 else None
            after, got = ipc_holder(rank, dev, (1, leg["steps"]), kept, p0,
                                    whole=leg.get("probe", False))
            run = tp_run(dev, leg, mesh, after=after, record_step=2,
                         profile=True, say=say)
            mine = got.pop("whole", None)
            row["tp"] = reading(run) | {"stats": got}
            del run
            release_memory()
            if mine is not None:
                row["probe"] = probe_losses(dev, leg, {"reference": kept[1],
                                                       "1x2": mine})
                del mine
                say(f"{label} probe: {row['probe']}")
            dist.barrier()
            if leg.get("planted"):
                # Once an arch: each runs its own attention mode's (and
                # the MoE's) reduces.
                after, got = ipc_holder(rank, dev, (1,), kept, p0)
                run = patched(placement_lib.ModelParallel, "reduce",
                              lambda self, x: x,
                              lambda: tp_run(dev, leg, mesh, steps=1,
                                             after=after, say=say))
                row["planted"] = reading(run) | {"stats": got}
                del run
                release_memory()
            after, got = ipc_holder(rank, dev, (1,), kept, p0)
            run = patched(placement_lib, "tensor_parallel_verdict",
                          lambda *a: (False, "the gathered route, forced"),
                          lambda: tp_run(dev, leg, mesh, steps=1,
                                         after=after, say=say))
            row["gathered"] = reading(run) | {"stats": got}
            row["mesh_s"] = time.perf_counter() - t1
            del run, ref, kept, after, got
            release_memory()
            if leg.get("serve"):
                row["serve"] = tp_serve_leg(dev, leg, mesh, rank, p0,
                                            serve_refs[label], out_dir,
                                            say=say)
            del p0
            release_memory()
            torch.save(out, path)
    except Exception as e:      # noqa: BLE001 (reported, then raised)
        out["error"] = f"{type(e).__name__}: {e}"
        torch.save(out, path)
        raise
    finally:
        dist.destroy_process_group()
    return 0


def tp_mesh_path(dev, only=()) -> dict:
    """Phase 15: the TP_LEGS (``tp_legs(only)``) at 1x2 over two gloo
    ranks on the one card (``--tp-mesh-rank``), held on rank 0 against the
    reference and its witness (module comment above), each rank's
    launches, model-axis traffic (no gather but the MoE router's logits)
    and step-1 peak against the gathered route's; then, with every leg,
    kernels 1-4 held against their plain versions and timed at a rank's
    packed width of the danube legs (``lm_kernels``) and the row-parallel
    products timed (``tp_product_timings``). The ranks print their
    progress as they go."""
    import gc
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    failures, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        # The serves' one-process references and witnesses first, in this
        # process: the ranks are fed their tokens.
        refs = {leg["label"]: tp_serve_reference(dev, leg)
                for leg in tp_legs(only) if leg.get("serve")}
        for label, ref in refs.items():
            print(f"tp {label} serve: reference and witness "
                  f"{ref['reference_s']:.1f} s")
        torch.save({label: ref["record"]["picks"]
                    for label, ref in refs.items()},
                   os.path.join(tmp, "serve_refs.pt"))
        done = run_ranks("--tp-mesh-rank", TP_RANKS, tmp, dev.type, *only,
                         timeout=600)
        ranks = []
        for r, (rc, _) in enumerate(done):
            path = os.path.join(tmp, f"rank{r}.pt")
            ranks.append(torch.load(path, weights_only=False)
                         if os.path.exists(path) else {})
            if rc != 0 or "error" in ranks[-1]:
                failures.append(f"tp mesh rank {r} exited {rc}: "
                                f"{ranks[-1].get('error')}")
        records = {}
        for label in refs:
            path = serve_record_path(tmp, label)
            records[label] = (torch.load(path, weights_only=False)
                              if os.path.exists(path) else None)
    for spec in tp_legs(only):
        label, steps = spec["label"], spec["steps"]
        legs = [got.get(label, {}) for got in ranks]
        if not all("gathered" in leg for leg in legs):
            failures.append(f"{label}: no result")
            continue
        ref = legs[0]["reference"]
        wit = ref["witness"]
        limit = {k: min(max(WITNESS_FACTOR * wit[k], LM_FLOOR[k]),
                        LM_CEILING[k]) for k in ("loss", "rel")}
        brief = {k: without_leaves(v) if isinstance(v, dict) else v
                 for k, v in wit.items()}
        print(f"tp {label} one process: losses {ref['losses']} grad_norms "
              f"{ref['grad_norms']}; ms a step {ms_after_first(ref)!r}; peak "
              f"{ref['peak_mem_gb']:.2f} GB; witness {json.dumps(brief)}; "
              f"limit {json.dumps(limit)}")
        row = {"one process": dict(reading_row(ref),
                                   ms_per_step=ms_after_first(ref),
                                   witness=brief, limit=limit)}
        want = expect(steps, **spec["launches"])
        for r, leg in enumerate(legs):
            tp, gathered = leg["tp"], leg["gathered"]
            moved = traffic_summary(tp.get("traffic", []))
            share = sum(op["share"] for key, op in tp.get(
                "collectives", {}).get("ops", {}).items()
                if key.startswith("mesh."))
            # The step-1 gradient's peak: the optimizer's update (the same
            # on both routes) sets the step's peak on the Adam and top-k
            # legs.
            peak = tp["grad_peak_by_step"][0]
            gpeak = gathered["grad_peak_by_step"][0]
            print(f"tp {label} rank {r}: {tp['model_compute']}; losses "
                  f"{tp['losses']} grad_norms {tp['grad_norms']} sparsity "
                  f"{tp['sparsity']}; ms a step {ms_after_first(tp)!r}; "
                  f"gloo share of the profiled step {share!r}; a step's "
                  f"model-axis traffic {json.dumps(moved)}; step-1 "
                  f"gradient's peak {peak:.2f} GB against the gathered "
                  f"route's {gpeak:.2f} GB (steps' peaks "
                  f"{tp['peak_by_step']}, gathered "
                  f"{gathered['peak_by_step']}); launches "
                  f"{tp['launches']}; width {tp['width']}")
            print(f"tp {label} rank {r} profile: "
                  f"{json.dumps(tp.get('collectives'))}")
            row[f"rank {r}"] = dict(
                reading_row(tp), ms_per_step=ms_after_first(tp),
                gloo_share=share, traffic=moved, grad_peak_gb=peak,
                gathered_grad_peak_gb=gpeak,
                step_peaks_gb=tp["peak_by_step"],
                gathered_step_peak_gb=gathered["peak_by_step"][0],
                launches=tp["launches"],
                width=tp["width"])
            if tp["model_compute"] != "tensor-parallel" or \
                    gathered["model_compute"] != "gathered":
                failures.append(f"{label} rank {r}: routes "
                                f"{tp['model_compute']}, "
                                f"{gathered['model_compute']}")
            if tp["launches"] != want:
                failures.append(f"{label} rank {r}: launches "
                                f"{tp['launches']} != {want}")
            gathers = {name for kind, name, *_ in tp.get("traffic", [])
                       if kind == "model.gather"}
            if not gathers <= {"router"} or not moved:
                failures.append(f"{label} rank {r}: model-axis gathers "
                                f"{gathers}, traffic {moved}")
            if not peak < gpeak:
                failures.append(f"{label} rank {r}: step-1 gradient's peak "
                                f"{peak} GB not below the gathered route's "
                                f"{gpeak}")
            if tp["losses"] != legs[0]["tp"]["losses"]:
                failures.append(f"{label} rank {r}: losses differ from rank "
                                "0's")
        tp = legs[0]["tp"]
        stats = tp["stats"]
        gaps = [abs(a - b) for a, b in zip(tp["losses"], ref["losses"])]
        held = spec.get("loss_held_steps", steps)
        dist_ = {"loss": max(gaps[:held]), "rel": stats[steps]["rel"]}
        if held < steps:
            print(f"tp {label}: loss gap by step {gaps} (held over the "
                  f"first {held}; witness {wit['losses']}, one process "
                  f"{ref['losses']}, 1x2 {tp['losses']})")
            row["loss_gaps"] = gaps
        if "probe" in legs[0]:
            probe = legs[0]["probe"]
            print(f"tp {label}: the one-process loss of step 2's batch from "
                  f"the reference's step-1 params {probe['reference']!r} "
                  f"(its step 2 {ref['losses'][1]!r}), from the 1x2 run's "
                  f"{probe['1x2']!r} (the 1x2 run's step 2 "
                  f"{tp['losses'][1]!r})")
            row["probe"] = probe
        s1 = stats[1]
        # In bf16 compute roundoff flips the Adam step of a share of
        # elements whose gradient is near 0: the witness shows how large
        # (0.46% of danube's, 1.3% of the MoE's on the H100).
        share_limit = max(FIRST_FLIP_SHARE,
                          WITNESS_FACTOR * wit["step1"]["share"])
        bad = step1_leaves(s1, wit["step1"], ref["names"])
        first_ok = not bad and s1["share"] <= share_limit
        for key in ("witness", "witness2"):
            if key in ref:
                print(f"tp {label}: {key} step 1 by leaf "
                      f"{leaf_table(ref[key]['step1'], ref['names'])}; "
                      f"step {steps} by leaf "
                      f"{leaf_table(ref[key]['last'], ref['names'])}")
        print(f"tp {label}: 1x2 step 1 by leaf "
              f"{leaf_table(s1, ref['names'])}; step {steps} by leaf "
              f"{leaf_table(stats[steps], ref['names'])}")
        if "witness2" in ref:
            w2 = ref["witness2"]
            print(f"tp {label}: second witness (nudged down) loss "
                  f"{w2['loss']!r} rel {w2['rel']!r} losses {w2['losses']}; "
                  f"first {wit['loss']!r} / {wit['rel']!r}; 1x2 "
                  f"{dist_['loss']!r} / {dist_['rel']!r}")
        planted = legs[0].get("planted")
        pdist = planted and {
            "loss": abs(planted["losses"][0] - ref["losses"][0]),
            "rel": planted["stats"][1]["rel"]}
        gstats = legs[0]["gathered"]["stats"][1]
        gbit = (gstats["bitwise"]
                and legs[0]["gathered"]["losses"][0] == ref["losses"][0])
        print(f"tp {label}: 1x2 vs one process {json.dumps(dist_)} (limit "
              f"{json.dumps(limit)}); step 1 {json.dumps(without_leaves(s1))} "
              f"(share limit {share_limit}; leaves past their limit "
              f"{bad}); planted "
              f"(reduce dropped) step 1 {json.dumps(pdist)} (must exceed "
              f"{json.dumps(TP_PLANTED)}, once an arch); gathered route "
              f"step 1 bitwise {gbit}")
        row.update(distance=dist_, step1=without_leaves(s1),
                   step1_leaves_over=bad, planted=pdist,
                   gathered_bitwise=gbit)
        if "witness2" in ref:
            row["witness2"] = {k: ref["witness2"][k]
                               for k in ("loss", "rel", "losses")}
        over = [k for k in dist_ if dist_[k] > limit[k]]
        if over:
            failures.append(f"{label}: {dist_} over {limit} on {over}")
        if not first_ok:
            failures.append(f"{label} step 1: {without_leaves(s1)}, "
                            f"leaves {bad}")
        if spec.get("planted") and not (
                pdist and all(pdist[k] > TP_PLANTED[k] for k in pdist)):
            failures.append(f"{label} planted: parts only {pdist}")
        if not gbit:
            failures.append(f"{label}: the gathered route's step 1 is not "
                            f"the reference's bit for bit ({gstats})")
        print(f"tp {label}: reference {legs[0]['reference_s']:.1f} s, mesh "
              f"legs {legs[0]['mesh_s']:.1f} s")
        if spec.get("serve"):
            row["serve"] = check_tp_serve(label, refs[label], legs,
                                          records[label], failures)
        out[label] = row
    first = TP_LEGS[0]["label"]
    width = max((got[first]["tp"]["width"] for got in ranks if first in got),
                default=0)
    if width and not only:
        out["kernels"] = lm_kernels(dev, width, TP_LEG["workers"],
                                    tag="tp", coherence=False)
        out["products"] = tp_product_timings(dev)
    if not only:
        out["paged_errs"] = paged_kernel_checks(dev, TP_PAGED_GRID)
        out["paged_timings"] = {}
        for name, case in TP_TIMING.items():
            out["paged_timings"].update(paged_timings(
                dev, case, name=f"paged_attention {name}"))
    print(f"tp mesh phase: {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("tp mesh phase: " + "; ".join(failures))
    return out


def add_tp_rows(kernels: list, tp: dict, serve_mesh: dict) -> None:
    """Beside each of kernels 1-4, its times at a rank's packed width of
    phase 15's danube legs and its launches on rank 0's tensor-parallel
    run of every leg; beside paged_attention, its times and errors at a
    rank's heads (TP_PAGED_GRID) and its launches on rank 0's
    tensor-parallel serves (phase 13's and phase 15's)."""
    timings, errs = tp["kernels"]["timings"], tp["kernels"]["errs"]
    for entry in kernels:
        name = entry["name"]
        if name == "paged_attention":
            entry["tp_heads"] = {
                cut: dict({k: tp["paged_timings"][f"paged_attention {cut}"][k]
                           for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "bf16_wrapper_ms")},
                          heads=TP_TIMING[cut]["heads"],
                          max_abs_err=tp["paged_errs"]["by_shape"][cut][
                              "fp32"],
                          max_abs_err_bf16=tp["paged_errs"]["by_shape"][cut][
                              "bf16"])
                for cut in TP_TIMING}
            entry["launches_serve_tp"] = {
                "tp danube (phase 13, rank 0)":
                    serve_mesh["1x2 gloo rank 0"]["launches"]} | {
                f"{label} (phase 15, rank 0)": row["serve"]["rank 0"][
                    "launches"]
                for label, row in tp.items()
                if isinstance(row, dict) and "serve" in row}
        key = {"fused_update": "fused_update.plain"}.get(name, name)
        if f"{key} tp" not in timings:
            continue
        t = timings[f"{key} tp"]
        entry["tp_width"] = {
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "max_abs_err": errs[key],
            "launches_by_leg": {
                label: sum(n for k, n in row["rank 0"]["launches"].items()
                           if k.split(".")[0] == name)
                for label, row in tp.items() if "rank 0" in row}}


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


def card_setup():
    """The card with TF32 off, as every phase runs (None without CUDA)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(card_line())
    return dev


def tp_only(only=()) -> int:
    """``--tp-only [WORD ...]``: phase 15 alone (with the kernels' build,
    for its kernel checks and timings), or only its legs whose label holds
    one of the words (then without the kernels' checks and timings)."""
    dev = card_setup()
    if dev is None:
        return 2
    from repro_torch.kernels import build
    build.build()
    build.library()
    t0 = time.perf_counter()
    tp_mesh_path(dev, only)
    print(f"phase tp mesh path alone: {time.perf_counter() - t0:.1f} s")
    return 0


# The mesh phases by number: (the lap's name, the phase's function).
MESH_PHASES = {"12": ("mesh path", "mesh_path"),
               "13": ("serve mesh path", "serve_mesh_path"),
               "14": ("fsdp mesh path", "fsdp_mesh_path"),
               "15": ("tp mesh path", "tp_mesh_path")}


def mesh_only(args: list) -> int:
    """``--mesh-only [--tree DIR] [PHASE ...]``: the mesh phases (12-15,
    or those named) alone, after the kernels' build, each with its lap,
    then one JSON line ``{"tree", "laps", "failures"}``. With ``--tree
    DIR`` they are DIR's phases (a checkout of another commit unpacked
    into an ignored directory, e.g. the parent's), run by DIR's
    ``chip_smoke.py`` on DIR's ``src/`` in a process of their own, so
    two commits' phases can be timed in one call."""
    if args[:1] == ["--tree"]:
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mesh-only-in",
             os.path.abspath(args[1]), *args[2:]]).returncode
    return mesh_phases(sys.modules[__name__], ROOT, args)


def mesh_phases(mod, tree: str, phases: list) -> int:
    """``mesh_only``'s run of the module ``mod`` (a tree's
    ``chip_smoke``)."""
    dev = mod.card_setup()
    if dev is None:
        return 2
    if hasattr(mod, "rank_pool"):
        mod.rank_pool()         # warming up during the build, as in main
    from repro_torch.kernels import build
    build.build()
    build.library()
    laps, failures = {}, {}
    try:
        for n in phases or list(MESH_PHASES):
            name, fn = MESH_PHASES[n]
            t0 = time.perf_counter()
            try:
                getattr(mod, fn)(dev)
            except AssertionError as e:
                failures[n] = str(e)[:4000]
            laps[n] = time.perf_counter() - t0
            print(f"phase {name}: {laps[n]:.1f} s", flush=True)
    finally:
        if hasattr(mod, "stop_rank_pool"):
            mod.stop_rank_pool()
    print(json.dumps({"tree": tree, "laps": laps, "failures": failures}))
    return 1 if failures else 0


def mesh_only_in(tree: str, phases: list) -> int:
    """``--mesh-only-in DIR [PHASE ...]``: ``mesh_only``'s process for
    DIR, which imports DIR's ``chip_smoke`` (and through it DIR's
    ``src/``) before anything of the port."""
    import importlib
    sys.path.insert(0, tree)
    sys.modules.pop("chip_smoke", None)
    return mesh_phases(importlib.import_module("chip_smoke"), tree, phases)


def fsdp_only() -> int:
    """``--fsdp-only``: phase 14 alone (it launches no kernel, so nothing
    is built)."""
    dev = card_setup()
    if dev is None:
        return 2
    t0 = time.perf_counter()
    fsdp_mesh_path(dev)
    print(f"phase fsdp mesh path alone: {time.perf_counter() - t0:.1f} s")
    return 0


# Each depth cut made to fit the run (PERF.md section 4), and one not
# taken (the vision leg at 3 layers holds no cross layer: one comes after
# every 5th): the setting it changes, its key (None: the setting is the
# depth), the depth it cuts to, the depth before the cut, whether the leg
# runs with the cross gates open (phase 11), and the leg.
CUTS = (
    ("phase 9: the danube training leg", "TRAIN_FULL", "layers", 12, 24,
     False, lambda dev, tmp, f: full_config_leg(dev, f)),
    ("phase 10: the mamba sync leg", "SSM_FULL", "layers", 6, 24, False,
     lambda dev, tmp, f: full_leg(dev, cut_arch(
         SSM_ARCH, SSM_FULL["layers"]), SSM_FULL, "mamba", f)),
    ("phase 10: the mamba serve", "SSM_SERVE", "layers", 6, 24, False,
     lambda dev, tmp, f: ssm_serve(dev, SSM_SERVE)),
    ("phase 10: the zamba ring leg", "HYBRID_RING", "layers", 6, 7, False,
     lambda dev, tmp, f: ring_legs(dev, tmp, f, arch_id=HYBRID_ARCH,
                                   r=HYBRID_RING, legs=HYBRID_LEGS)),
    ("phase 10: the zamba serve", "HYBRID_SERVE", "layers", 12, 42, False,
     lambda dev, tmp, f: ssm_serve(dev, HYBRID_SERVE)),
    ("phase 11: the whisper ring legs", "WHISPER_RING", "layers", 1, 3,
     True, lambda dev, tmp, f: ring_legs(dev, tmp, f, arch_id=WHISPER_ARCH,
                                         r=WHISPER_RING, legs=TRAIN_LEGS)),
    ("phase 11: the vision leg", "VISION_TRAIN", "layers", 3, 5, True,
     lambda dev, tmp, f: vision_leg(dev, f)),
    ("phase 11: the llama serve", "VISION_SERVE", "layers", 20, 40, True,
     lambda dev, tmp, f: cross_serve(dev, VISION_SERVE)),
    ("phase 13: the served danube", "MESH_SERVE_LAYERS", None, 6, 24,
     False, lambda dev, tmp, f: serve_mesh_path(dev)),
)


def time_cuts(only=()) -> int:
    """``--time-cuts [WORD ...]``: each leg of ``CUTS`` (those whose label
    holds one of the words, if any are given) at its cut depth and then at
    the depth before the cut, on one host, with its wall seconds (the
    first run of a leg also pays its one-time costs, so the saving printed
    is if anything low). A leg's failures are printed, not raised: the
    depths are timed here, not held."""
    import contextlib
    import gc
    import torch
    dev = card_setup()
    if dev is None:
        return 2
    from repro_torch.kernels import build
    build.build()
    build.library()
    g = globals()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, name, key, cut, before, gates, leg in CUTS:
            if only and not any(word in label for word in only):
                continue
            kept = g[name]
            secs = {}
            for depth in (cut, before):
                g[name] = depth if key is None else dict(kept, **{key: depth})
                failures = []
                t0 = time.perf_counter()
                try:
                    with (open_gates() if gates
                          else contextlib.nullcontext()):
                        leg(dev, tmp, failures)
                except Exception as e:      # noqa: BLE001 (printed)
                    failures.append(f"{type(e).__name__}: {e}")
                secs[depth] = time.perf_counter() - t0
                g[name] = kept
                gc.collect()
                torch.cuda.empty_cache()
                print(f"cut {label} at {depth} layers: {secs[depth]:.1f} s"
                      + (f"; failures {failures}" if failures else ""),
                      flush=True)
            rows[label] = {"cut": cut, "before": before, "seconds": secs,
                           "saved_s": secs[before] - secs[cut]}
            print(f"cut {label}: {cut} layers for {before} saves "
                  f"{rows[label]['saved_s']:.1f} s", flush=True)
    print(json.dumps({"cuts": rows}))
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
    rank_pool()             # the mesh phases' rank processes, warming up

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    clock = [t_start]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"phase {what}: {now - clock[0]:.1f} s")
        clock[0] = now

    path, log, secs = build.build()
    build.library()
    print(f"build: {path.name} in {secs:.1f} s")
    print_ptxas(log)
    print_tensor_core_ops(path)
    lap("build")

    # The packed width at the main path's shapes, times P = 8 workers.
    width = dnn_width(dev)
    n = WORKERS * width
    print(f"packed width D_pad={width}, N=P*D_pad={n}")
    errs = kernel_checks(dev, n)

    ring_errs = ring_kernel_checks(dev, width)
    lap("kernel checks")

    runs = main_path(dev)
    sequential_check(dev)
    lap("main path")

    import numpy as np
    from repro_torch.data import synthetic
    # One [STEPS, P] delay table in [0, s-1], as the simulate path's, for
    # the paper's other models and stale-psum.
    table = np.random.default_rng(0).integers(0, STALENESS, (STEPS, WORKERS))
    table[0, 0] = STALENESS - 1
    paper = paper_path(dev, table)
    lap("paper path")

    # The ring path: the same DNN, data and seeds as the simulate path, and
    # lognormal worker speeds (numpy, seed 0) for ssp's clock schedule.
    params0 = mlp.init(0, mlp.MLPConfig(depth=DEPTH), device=dev)
    speeds = np.random.default_rng(0).lognormal(
        0.0, 0.5, (64, WORKERS)).astype(np.float32)
    data = synthetic.teacher_classification(seed=0)
    ring = ring_path(dev, params0, data, table, speeds)
    lap("ring path")

    timings = kernel_timings(dev, n)
    timings.update(ring_kernel_timings(dev, width))

    # The coherence path: the same DNN, data, seeds and delay table.
    coh_err = coherence_kernel_checks(dev, width)
    with tempfile.TemporaryDirectory() as tmp:
        coh = coherence_path(dev, params0, data, table, tmp)
    cost = hook_cost(dev, params0, data, table)
    timings.update(coherence_timings(dev, width))
    coherence_sweep(dev, width)
    lap("kernel timings, coherence path")

    # The serve path: paged_attention against its plain version, its
    # timings, then the full-width danube serve.
    paged_errs = paged_kernel_checks(dev)
    timings.update(paged_timings(dev))
    paged_split_sweep(dev)
    serve = serve_path(dev)
    lap("serve path")

    # The train path: flash_attention, then LM training through the train
    # CLI (full-config danube, cut-depth ring legs) and the MoE leg.
    with tempfile.TemporaryDirectory() as tmp:
        train = train_path(dev, tmp)
    lap("train path")

    # The state-space families: mamba2-1.3b trained at full width and
    # depth and served on the resident route, zamba2-7b served at full
    # width and depth on the gather route and trained at 7 layers.
    with tempfile.TemporaryDirectory() as tmp:
        ssm = ssm_path(dev, tmp)
    lap("ssm path")

    # Cross-attention: paged_attention at whisper's and llama-vision's head
    # shapes, whisper-base trained at full width and depth (sync and the
    # ring legs) and llama-3.2-vision-11b at 5 of 40 layers, both served at
    # full width on the paged route (llama at 20 of 40 layers).
    with tempfile.TemporaryDirectory() as tmp:
        cross = cross_path(dev, tmp)
    lap("cross path")

    # The mesh path: the DNN legs through build_engine(mesh=) on a 1x1
    # nccl mesh and over two gloo ranks on the one card.
    mesh = mesh_path(dev)
    lap("mesh path")

    # Serving on a mesh: the danube served mesh-less, on a 1x1 nccl
    # mesh and on two gloo ranks at 1x2, refreshed mid-serve.
    serve_mesh = serve_mesh_path(dev)
    lap("serve mesh path")

    # The FSDP archs on a mesh: deepseek-67b at full width, one layer,
    # params as data-axis shards over two gloo ranks on the one card.
    fsdp_mesh = fsdp_mesh_path(dev)
    lap("fsdp mesh path")

    # Tensor-parallel compute on the model axis: danube, qwen3-14b and
    # qwen2-moe-a2.7b at full width, depth cut, over two gloo ranks at 1x2;
    # kernels 1-4 at a rank's packed width.
    tp_mesh = tp_mesh_path(dev)
    lap("tp mesh path")
    stop_rank_pool()        # before the last lines: nothing prints after

    kernels = kernel_entries(timings, runs, ring, {**errs, **ring_errs})
    add_paper_launches(kernels, paper)
    kernels.append(coherence_entry(timings, coh, coh_err))
    kernels.append(paged_entry(timings, serve, paged_errs))
    kernels.append(flash_entry(train))
    add_lm_rows(kernels, train)
    add_ssm_rows(kernels, ssm)
    add_cross_rows(kernels, cross)
    add_mesh_rows(kernels, mesh)
    add_serve_mesh_rows(kernels, serve_mesh)
    add_tp_rows(kernels, tp_mesh, serve_mesh)
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
    print(json.dumps({"ssm": without_profiles(
        {k: v for k, v in ssm.items() if k not in ("lm", "full_adam")})},
        default=str))
    print(json.dumps({"cross": without_profiles(cross)}, default=str))
    print(json.dumps({"mesh": mesh}, default=str))
    print(json.dumps({"serve_mesh": serve_mesh}, default=str))
    print(json.dumps({"fsdp_mesh": fsdp_mesh}, default=str))
    print(json.dumps({"tp_mesh": tp_mesh}, default=str))
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
    if sys.argv[1:2] in (["--mesh-rank"], ["--serve-mesh-rank"],
                         ["--fsdp-mesh-rank"], ["--tp-mesh-rank"]):
        sys.exit(rank_program(sys.argv[1:]))
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(int(sys.argv[2]), sys.argv[3]))
    modes = {"--fsdp-only": lambda: fsdp_only(),
             "--tp-only": lambda: tp_only(sys.argv[2:]),
             "--mesh-only": lambda: mesh_only(sys.argv[2:]),
             "--mesh-only-in": lambda: mesh_only_in(sys.argv[2],
                                                    sys.argv[3:]),
             "--time-cuts": lambda: time_cuts(sys.argv[2:])}
    try:
        sys.exit(modes.get(sys.argv[1] if sys.argv[1:] else "", main)())
    finally:
        stop_rank_pool()
