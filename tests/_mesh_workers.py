"""Rank programs for the port's mesh tests (``test_torch_mesh_engine.py``).

Each spawned process joins a ``gloo`` group, runs every case of its world
size on CPU tensors and saves what the parent compares (``rank<r>.pt``).
The same case functions run in the parent with no mesh, as the one-process
reference. The teacher-forced serve records come from ``chip_smoke.py``'s
``Forcing``. Nothing here imports JAX.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import delays as tdel
from repro_torch import treemath as tm
from repro_torch.data import synthetic
from repro_torch.engine import EngineConfig, build_engine
from repro_torch.engine import plan as planlib
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt
from repro_torch.sharding import rules as rules_lib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

P, DIM, B_WORKER, STEPS, S = 4, 24, 6, 6, 3
LM_STEPS, LM_BATCH, LM_SEQ = 3, 4, 16

# name -> (EngineConfig kwargs, optimizer, exact). ``exact``: the mesh
# gathers the rows and reduces them in the one-process order (bitwise);
# otherwise an all-reduce averages batch-split gradients (fp32 roundoff).
MLP_CASES = {
    "simulate-sgd-tree": (dict(mode="simulate", s=S), "sgd", True),
    "simulate-adam-packed": (dict(mode="simulate", s=S, kernels="on"),
                             "adam", True),
    "simulate-topk-inverse": (dict(mode="simulate", s=S, kernels="on",
                                   compress="topk:0.3", lr_scale="inverse"),
                              "sgd", True),
    "simulate-uniform-delays": (dict(mode="simulate", s=S, kernels="on",
                                     delay="uniform"), "adam", True),
    "stale-psum-adam-tree": (dict(mode="stale-psum", s=S), "adam", True),
    "stale-psum-adam-fused": (dict(mode="stale-psum", s=S, kernels="on"),
                              "adam", True),
    "stale-psum-sgd-topk": (dict(mode="stale-psum", s=S, kernels="on",
                                 compress="topk:0.3"), "sgd", True),
    "stale-psum-adam-topk-fused": (dict(mode="stale-psum", s=S, kernels="on",
                                        compress="topk:0.3", ef_momentum=0.5),
                                   "adam", True),
    "stale-psum-tree-topk": (dict(mode="stale-psum", s=S,
                                  compress="topk:0.3"), "sgd", True),
    "stale-psum-aggregate": (dict(mode="stale-psum", s=S, kernels="on",
                                  per_worker_delays=False), "adam", False),
    "ssp-adam": (dict(mode="ssp", s=S, kernels="on"), "adam", True),
    "ssp-tree": (dict(mode="ssp", s=S), "sgd", True),
    "sync-adam-fused": (dict(mode="sync", kernels="on"), "adam", False),
    "sync-sgd-tree": (dict(mode="sync"), "sgd", False),
    "simulate-three-workers": (dict(mode="simulate", s=S, num_workers=3),
                               "sgd", True),
}


def _data():
    return synthetic.teacher_classification(seed=0, dim=DIM, n_train=512,
                                            n_test=64)


def _optimizer(name: str):
    return topt.adam(1e-2) if name == "adam" else topt.sgd(0.1)


def _config(kw: dict) -> EngineConfig:
    kw = dict(kw)
    p = kw.pop("num_workers", P)
    if kw.pop("delay", None) == "uniform":
        return EngineConfig(num_workers=p, **kw)
    if kw["mode"] in ("simulate", "stale-psum", "ssp") and \
            kw.get("per_worker_delays", True):
        table = np.random.default_rng(p).integers(0, S, (STEPS + 2, p))
        kw["delay"] = tdel.Schedule(table)
    return EngineConfig(num_workers=p, **kw)


def mlp_case(name: str, mesh=None):
    """Run one MLP case for STEPS steps; returns {"params", "losses",
    "workers"} with whole tensors (simulate: every worker's cache)."""
    kw, opt, _ = MLP_CASES[name]
    cfg = _config(kw)
    data = _data()
    params = tmlp.init(0, tmlp.MLPConfig(in_dim=DIM, hidden=16, depth=2),
                       device="cpu")
    eng = build_engine(tmlp.loss_fn, _optimizer(opt), cfg, mesh=mesh,
                       device="cpu")
    state = eng.init(1, params=params)
    p = cfg.num_workers
    losses = []
    for t in range(STEPS):
        lo = t * p * B_WORKER
        x = torch.from_numpy(data.x_train[lo:lo + p * B_WORKER])
        y = torch.from_numpy(data.y_train[lo:lo + p * B_WORKER])
        if cfg.mode == "simulate":
            x, y = x.reshape(p, B_WORKER, -1), y.reshape(p, B_WORKER)
        state, m = eng.step(state, (x, y))
        losses.append(float(m["loss"]))
    out = {"params": tm.tree_map(torch.clone, eng.params(state)),
           "losses": losses}
    if cfg.mode == "simulate":
        caches = state.inner.caches
        if eng.placement is not None:
            caches = eng.placement.gather_tree(caches)
        out["workers"] = tm.tree_map(torch.clone, caches)
    return out


LM_CASES = {
    "deepseek-7b-stale-psum": ("deepseek-7b", dict(mode="stale-psum",
                                                   stale_s=2)),
    "deepseek-7b-sync": ("deepseek-7b", dict(mode="sync")),
    "qwen2-moe-stale-psum": ("qwen2-moe-a2.7b", dict(mode="stale-psum",
                                                     stale_s=2)),
}
LM_MESH = rules_lib.AbstractMesh(("data", "model"), (2, 2))


def lm_case(name: str, mesh=None):
    """A reduced LM through ``make_train_engine`` (kernels auto, P = 2);
    without a mesh it runs under ``use_mesh(LM_MESH)``, so the MoE layer
    groups its tokens as the sharded run does."""
    from repro_torch.configs.base import InputShape
    arch, kw = LM_CASES[name]
    shape = InputShape("mesh_lm", LM_SEQ, LM_BATCH, "train")
    eng = planlib.make_train_engine(arch, shape, mesh, reduced=True,
                                    num_workers=2, kernels="auto",
                                    device="cpu", **kw)
    stream = synthetic.token_lm_stream(3, eng_vocab(arch), LM_SEQ, LM_BATCH)
    with rules_lib.use_mesh(LM_MESH if mesh is None else None):
        state = eng.init(0)
        init = _whole(eng.params(state))
        losses = []
        for _ in range(LM_STEPS):
            state, m = eng.step(state, {"tokens": next(stream)})
            losses.append(float(m["loss"]))
    return {"params": _whole(eng.params(state)), "init": init,
            "losses": losses,
            "kernels": eng.meta["kernels"],
            "model_compute": eng.meta.get("model_compute")}


# The FSDP archs (params, optimizer state and the aggregate ring sharded
# over data): name -> (arch, make_train_engine kwargs), P = 4 workers,
# momentum (the archs' train optimizer). The batch-split cases train with
# remat on, so each layer is gathered again in the backward pass.
FSDP_P, FSDP_STEPS, FSDP_BATCH, FSDP_SEQ = 4, 4, 8, 16
FSDP_CASES = {
    "deepseek-67b-sync": ("deepseek-67b", dict(mode="sync",
                                               remat_override=True)),
    "deepseek-67b-stale-psum": ("deepseek-67b", dict(
        mode="stale-psum", stale_s=2, remat_override=True)),
    "deepseek-67b-stale-psum-per-worker": ("deepseek-67b", dict(
        mode="stale-psum", stale_s=2, per_worker_delays=True)),
    "deepseek-67b-ssp": ("deepseek-67b", dict(mode="ssp", stale_s=2)),
    "deepseek-67b-simulate": ("deepseek-67b", dict(mode="simulate",
                                                   stale_s=2)),
    "kimi-k2-sync": ("kimi-k2-1t-a32b", dict(mode="sync")),
    "kimi-k2-stale-psum": ("kimi-k2-1t-a32b", dict(mode="stale-psum",
                                                   stale_s=2)),
    "kimi-k2-ssp": ("kimi-k2-1t-a32b", dict(mode="ssp", stale_s=2)),
    "kimi-k2-simulate": ("kimi-k2-1t-a32b", dict(mode="simulate",
                                                 stale_s=2)),
}
# mesh label -> (data, model); 2x2 runs deepseek-67b only.
FSDP_MESHES = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2)}
# The batch-split modes: a sum over ranks replaces one backward pass.
FSDP_SPLIT = ("sync", "stale-psum")


def fsdp_cases(label: str) -> list:
    return [name for name, (arch, _) in FSDP_CASES.items()
            if label != "2x2" or arch == "deepseek-67b"]


def fsdp_split(name: str) -> bool:
    kw = FSDP_CASES[name][1]
    return kw["mode"] == "sync" or (kw["mode"] == "stale-psum"
                                    and not kw.get("per_worker_delays"))


def params_gap(got, ref, init, far: float = 1e-4) -> tuple:
    """How far the params ``got`` lie from ``ref``: the largest element's
    distance, the whole tree's L2 distance relative to how far training
    moved ``ref`` from ``init``, and the fraction of elements farther than
    ``far``."""
    worst = num = den = 0.0
    n_far = n = 0
    for g, r, r0 in zip(tm.tree_leaves(got), tm.tree_leaves(ref),
                        tm.tree_leaves(init)):
        assert g.shape == r.shape
        gap = (g - r).abs()
        worst = max(worst, float(gap.max()))
        num += float((gap.double() ** 2).sum())
        den += float(((r - r0).double() ** 2).sum())
        n_far += int((gap > far).sum())
        n += gap.numel()
    return worst, (num / den) ** 0.5, n_far / n


def leaf_gaps(got, ref, init, far: float = 1e-4) -> list:
    """``params_gap`` leaf by leaf: for each leaf its L2 distance from
    ``ref`` relative to how far training moved that leaf, and the fraction
    of its elements farther than ``far``."""
    out = []
    for g, r, r0 in zip(tm.tree_leaves(got), tm.tree_leaves(ref),
                        tm.tree_leaves(init)):
        assert g.shape == r.shape
        gap = (g - r).abs().double()
        moved = float(((r - r0).double() ** 2).sum()) ** 0.5
        out.append((float((gap ** 2).sum()) ** 0.5 / max(moved, 1e-30),
                    int((gap > far).sum()) / gap.numel()))
    return out


# ``adam_close``'s limits on every leaf: its relative L2 distance and its
# share of elements farther than lr / 10. The largest readings over every
# fp32 Adam case of ``test_torch_tp.py`` and ``test_torch_mesh_engine.py``
# on the CPU were 0.0121 (reduced deepseek-7b stale-psum at 2x2) and
# 6.1e-5 (one element of a 16,384); the limits are ten times those.
LEAF_LIMITS = (0.12, 6.1e-4)


def adam_close(gaps: list, lr: float = 1e-3) -> bool:
    """Whether ``leaf_gaps`` (with ``far = lr / 10``) are what an fp32 Adam
    run whose gradients part from one process's at roundoff shows, leaf by
    leaf: Adam normalises a near-zero gradient element, so roundoff can
    flip its step, and such elements are few in every leaf
    (``LEAF_LIMITS``). A leaf whose gradient is wrong (a missing sum over
    the ranks) flips a large share of its elements' steps."""
    return all(rel <= LEAF_LIMITS[0] and share <= LEAF_LIMITS[1]
               for rel, share in gaps)


def _whole(tree):
    from repro_torch.engine.placement import whole_dtensor
    return tm.tree_map(lambda x: whole_dtensor(x).detach().clone(), tree)


def fsdp_case(name: str, mesh=None, label: str = "2x1", plant=False) -> dict:
    """One FSDP case for FSDP_STEPS steps through ``make_train_engine``
    (kernels auto, which the FSDP placement vetoes): each step's loss and
    grad_norm, the whole params at the end, and on a mesh the data axis's
    gathers and reduce-scatters of one more step. Without a mesh it runs
    under ``use_mesh`` of the label's shape, so the MoE layer groups its
    tokens as the mesh does. ``plant``: the per-worker step reads its
    params through the batch-split modes' gather, whose backward sums each
    rank's workers' gradients into the others' (the fault the
    per-worker path's whole gather avoids)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.engine import api as api_lib
    arch, kw = FSDP_CASES[name]
    data, model = FSDP_MESHES[label]
    shape = InputShape("mesh_fsdp", FSDP_SEQ, FSDP_BATCH, "train")
    real_loss = api_lib._mesh_loss
    if plant:
        api_lib._mesh_loss = lambda fn, placement, m, per_worker: real_loss(
            fn, placement, m, False)
    try:
        eng = planlib.make_train_engine(arch, shape, mesh, reduced=True,
                                        num_workers=FSDP_P, kernels="auto",
                                        device="cpu", **kw)
    finally:
        api_lib._mesh_loss = real_loss
    if plant:
        pl = eng.placement
        pl.whole_like = lambda params: params
        pl.data_whole = pl.data_part = lambda tree: tree
    drawn = []
    if mesh is not None and eng.placement.sharded:
        # The values the initialiser hands the placement to cut.
        real_keep = eng.placement.keep

        def keep(x, axes):
            if x.device.type != "meta":
                drawn.append(tuple(x.shape))
            return real_keep(x, axes)
        eng.placement.keep = keep
    stream = synthetic.token_lm_stream(5, eng_vocab(arch), FSDP_SEQ,
                                       FSDP_BATCH)
    ambient = rules_lib.AbstractMesh(("data", "model"), (data, model))

    def batch():
        tokens = next(stream)
        if kw["mode"] == "simulate":
            tokens = tokens.reshape(FSDP_P, FSDP_BATCH // FSDP_P, -1)
        return {"tokens": tokens}

    out = {"losses": [], "grad_norms": [], "kernels": eng.meta["kernels"],
           "drawn": drawn}
    with rules_lib.use_mesh(ambient if mesh is None else None):
        state = eng.init(0)
        for _ in range(FSDP_STEPS):
            state, m = eng.step(state, batch())
            out["losses"].append(float(m["loss"]))
            if "grad_norm" in m:
                out["grad_norms"].append(float(m["grad_norm"]))
        out["params"] = _whole(eng.params(state))
        if mesh is not None and eng.placement.data_axis is not None:
            axis = eng.placement.data_axis
            axis.record = []
            eng.step(state, batch())
            out["traffic"], axis.record = axis.record, None
            out["fsdp"] = eng.placement.fsdp
    return out


def eng_vocab(arch: str) -> int:
    from repro_torch import configs as cfglib
    return cfglib.get(arch).api(reduced=True).vocab_real


def restore_case(mesh, tmpdir: str, params_spec=(None,)):
    """Save a worker-stacked tree on rank 0; every rank restores it with a
    plan's placements (``params_spec`` on a 2x2 mesh: ``("model",)``, a
    DTensor). Returns (restored, whole, step), DTensors as their local
    shards."""
    import torch.distributed as dist
    whole = {"caches": torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6),
             "params": torch.linspace(-1, 1, 10),
             "step": torch.tensor(7)}
    path = ckpt.step_path(tmpdir, 3)
    if dist.get_rank() == 0:
        ckpt.save(path, whole, step=3)
    dist.barrier()
    sh = rules_lib.named({"caches": ("data", None), "params": params_spec,
                          "step": ()}, mesh)
    got, step, _ = ckpt.restore(path, like=whole, shardings=sh)
    got = {k: (v.to_local(), type(v).__name__) if hasattr(v, "to_local")
           else v for k, v in got.items()}
    return got, whole, step


def constraint_case(mesh) -> dict:
    """``constraint``/``ambient_constraint`` on DTensors of a 2x2 mesh:
    each result's placements (as strings) and whether its whole tensor is
    the input's."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    whole = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    rep = distribute_tensor(whole, mesh, [Replicate(), Replicate()])
    cols = distribute_tensor(whole, mesh, [Replicate(), Shard(1)])
    with rules_lib.use_mesh(mesh):
        outs = {"batch-mlp": rules_lib.constraint(rep, mesh, "batch", "mlp"),
                "data-unc": rules_lib.ambient_constraint(cols, "data", "UNC"),
                "data-none": rules_lib.ambient_constraint(cols, "data", None),
                "pod-only": rules_lib.ambient_constraint(cols, "pod", None)}
    return {k: ([str(pl) for pl in v.placements],
                torch.equal(v.full_tensor(), whole)) for k, v in outs.items()}


# The serve cases: reduced archs, 2 slots, 3 requests (a join after an
# evict), a virtual clock. name -> (arch, ServingConfig changes). The routes
# are pinned ("on" overrides the model-axis veto, "off" forces the gather
# route) so the mesh and the one process run the same one; deepseek-67b's
# FSDP placement vetoes the paged route under "auto" everywhere.
SERVE = dict(reduced=True, slots=2, prompt_len=8, max_seq=24, page_tokens=4,
             seed=0, virtual_dt=0.01)
SERVE_GENS = (5, 9, 4)
SERVE_CASES = {
    "deepseek-7b-paged-greedy": ("deepseek-7b", dict(paged="on")),
    "deepseek-7b-gather-greedy": ("deepseek-7b", dict(paged="off")),
    "deepseek-7b-paged-t0.7": ("deepseek-7b", dict(paged="on",
                                                   temperature=0.7)),
    "deepseek-7b-gather-t0.7": ("deepseek-7b", dict(paged="off",
                                                    temperature=0.7)),
    "deepseek-67b-auto": ("deepseek-67b", dict(paged="auto")),
}
# Served at 2x1 alone: the MoE FSDP arch, and deepseek-67b with a data-axis
# gather that delivers nothing (``chip_smoke.NoGather``, planted).
FSDP_SERVE_CASES = {
    "kimi-k2-1t-a32b-auto": ("kimi-k2-1t-a32b", dict(paged="auto")),
    "deepseek-67b-planted": ("deepseek-67b", dict(paged="auto")),
}
# The refresh case boots from snapshot 1, serves a warm-up request (2 decode
# steps), publishes snapshot 2 and polls every REFRESH_EVERY decode steps,
# so the swap lands at decode step 4, two steps into the served stream.
REFRESH_EVERY = 4


def _served(server, report, record=None) -> dict:
    """What every rank and the one process must agree on: each request's
    tokens and staleness stamps, the route, and the report's counts; the
    model axis's route and the ``Forcing`` record of the run (its logits,
    margins and picks), which the tensor-parallel route is held by."""
    return {"route": (server.paged_route, server._paged_why),
            "tokens": {r.rid: r.tokens for r in report.completed},
            "stamps": {r.rid: r.staleness for r in report.completed},
            "counts": (report.decode_steps, report.joins, report.evicts,
                       report.refreshes, report.prefill_calls),
            "report": report, "model_compute": server.model_compute,
            "record": record}


def _recorded_run(server, reqs) -> dict:
    """``server.run(reqs)`` under ``Forcing`` (its picks recorded, not
    forced): ``_served`` of it."""
    from chip_smoke import Forcing
    with Forcing(server) as rec:
        report = server.run(reqs)
    return _served(server, report, rec.record())


def _serve_requests(server, gens=SERVE_GENS, seed=3):
    from repro_torch.serving import synthetic_requests
    reqs = synthetic_requests(len(gens), SERVE["prompt_len"], 1,
                              server.api.vocab_real, seed=seed)
    for r, g in zip(reqs, gens):
        r.max_new_tokens = g
    return reqs


def _step_reads(server) -> list:
    """Each decode step's data-axis gathers, ``[(name, shape)]`` a step,
    filled as the server runs (its step plan wrapped)."""
    axis, plan, steps = server.placement.data_axis, server.splan, []

    def step(*args):
        axis.record = []
        try:
            return plan(*args)
        finally:
            steps.append([(name, shape) for _, name, shape, _ in axis.record])
            axis.record = None
    server.splan = step
    return steps


def serve_case(name: str, mesh=None) -> dict:
    """``name``'s stream served (on ``mesh``): ``_served`` of it and, where
    the placement keeps data blocks, each decode step's data-axis gathers
    (``reads``), the served bytes (``served_bytes``) and the model axis's
    whole gathers. ``-planted``: the data fetch's gather delivers
    nothing."""
    from chip_smoke import NoGather
    from repro_torch.serving import Server, ServingConfig
    arch, kw = {**SERVE_CASES, **FSDP_SERVE_CASES}[name]
    server = Server(ServingConfig(arch=arch, **SERVE, **kw), device="cpu",
                    mesh=mesh)
    pl = server.placement
    reads = None if pl is None or pl.data_axis is None else \
        _step_reads(server)
    if name.endswith("-planted"):
        pl.dist = NoGather()
    out = _recorded_run(server, _serve_requests(server))
    if reads is not None:
        out.update(reads=reads, bytes=served_bytes(server),
                   whole_gathers=pl.whole_gathers)
    return out


def _publish(server, ckpt_dir: str, step: int) -> None:
    """Snapshot ``step``: the arch's init from seed ``step``, written by
    the lead rank (the one process's only rank)."""
    if server._lead:
        params, _ = server.api.init(step, device="cpu")
        ckpt.save(ckpt.step_path(ckpt_dir, step), params, step=step,
                  extra={"published_at": time.time()})


def refresh_case(ckpt_dir: str, mesh=None, arch: str = "deepseek-7b",
                 paged: str = "on") -> dict:
    """Boot from snapshot 1, a warm-up request, then snapshot 2 swapped in
    at decode step REFRESH_EVERY, mid-serve. Rank 0 alone writes and polls;
    the other ranks load the step it broadcasts. Also the decode step each
    swap landed on, the model axis's whole gathers and whether the served
    params are then bitwise ``from_whole`` of snapshot 2 (this rank's
    blocks)."""
    from repro_torch.serving import Server, ServingConfig
    server = Server(ServingConfig(arch=arch, paged=paged, **SERVE),
                    device="cpu", mesh=mesh)
    _publish(server, ckpt_dir, 1)
    boot = server.restore_params(ckpt_dir)
    server.run(_serve_requests(server, gens=(3,), seed=4))
    _publish(server, ckpt_dir, 2)
    refresher = server.make_refresher(ckpt_dir, every_steps=REFRESH_EVERY,
                                      base_step=boot)
    swaps, swap = [], refresher.swap
    refresher.swap = lambda step, extra: (
        swaps.append(server.decode_steps), swap(step, extra))
    out = _recorded_run(server, _serve_requests(server))
    out["boot"], out["step"] = boot, server.refresher.current_step
    out["swaps"] = swaps
    pl = server.placement
    if pl is not None:
        want = pl.from_whole(server.api.init(2, device="cpu")[0])
        out["served_2"] = all(torch.equal(a, b) for a, b in zip(
            tm.tree_leaves(server.params), tm.tree_leaves(want)))
        out["whole_gathers"] = pl.whole_gathers
    return out


def fsdp_serve_init_case(mesh) -> dict:
    """Reduced deepseek-67b inited by the server itself on ``mesh`` (no
    params handed in): whether its params are bitwise ``from_whole`` of
    the one-process init, the shapes of the values the placement's
    ``keep`` was handed, the bytes it kept and the served params'
    (``served_bytes``), and the init's largest live param bytes (kept so
    far plus the value being drawn) against the whole params'."""
    from repro_torch.engine.placement import ServePlacement
    from repro_torch.serving import Server, ServingConfig
    live = {"kept": 0, "peak": 0, "drawn": []}
    keep = ServePlacement.keep

    def counted(self, x, axes):
        out = keep(self, x, axes)
        if x.device.type != "meta":     # a constant's shape, no values
            live["drawn"].append(tuple(x.shape))
            live["peak"] = max(live["peak"],
                               live["kept"] + x.numel() * x.element_size())
            live["kept"] += out.numel() * out.element_size()
        return out
    ServePlacement.keep = counted
    try:
        server = Server(ServingConfig(arch="deepseek-67b", **SERVE),
                        device="cpu", mesh=mesh)
    finally:
        ServePlacement.keep = keep
    whole = server.api.init(server.cfg.seed, device="cpu")[0]
    want = server.placement.from_whole(whole)
    return {"blocks": all(torch.equal(a, b) for a, b in zip(
                tm.tree_leaves(server.params), tm.tree_leaves(want))),
            "drawn": live["drawn"], "kept": live["kept"],
            "peak": live["peak"], "bytes": served_bytes(server),
            "whole": sum(x.numel() * x.element_size()
                         for x in tm.tree_leaves(whole))}


def serve_restore_case(mesh, ckpt_dir: str) -> dict:
    """``restore(shardings=)`` with the serve plan's placement: each leaf's
    type and whether a ``("model",)``-sharded leaf is a DTensor, and the
    placement's whole params against the saved ones."""
    from repro_torch.serving import Server, ServingConfig
    server = Server(ServingConfig(arch="deepseek-7b", **SERVE), device="cpu",
                    mesh=mesh)
    _publish(server, ckpt_dir, 5)
    import torch.distributed as dist
    dist.barrier()
    path = ckpt.step_path(ckpt_dir, 5)
    shards, _, _ = ckpt.restore(path, like=server.params,
                                shardings=rules_lib.named(
                                    server.splan.in_shardings[0], server.mesh))
    saved, _, _ = ckpt.restore(path, like=server.params)
    specs = rules_lib.axes_leaves(server.splan.in_shardings[0])
    kinds = [(type(x).__name__, "model" in str(spec))
             for x, spec in zip(tm.tree_leaves(shards), specs)]
    whole = server.placement.whole(shards)
    # Leaves the model extent does not divide: torch.chunk parts, the last
    # short (5 over 2) or empty (1 over 2).
    from repro_torch.engine.placement import ServePlacement
    odd = {"a": torch.arange(5.0), "b": torch.arange(6.0).reshape(3, 2),
           "c": torch.tensor([7.0])}
    uneven = ServePlacement(mesh, {"a": ("model",), "b": (None, "model"),
                                   "c": ("model",)}, odd)
    return {"kinds": kinds,
            "whole": all(torch.equal(a, b) for a, b in zip(
                tm.tree_leaves(whole), tm.tree_leaves(saved))),
            "uneven": all(torch.equal(a, b) for a, b in zip(
                tm.tree_leaves(uneven.whole(uneven.shard(odd))),
                tm.tree_leaves(odd)))}


def model_axis_run(mesh, **kw) -> dict:
    """One stale-psum step of reduced deepseek-7b on ``mesh`` with ``kw``
    (compression or the packed kernels over its model axis): the ring's
    delivery and the step's sparsity."""
    from repro_torch.configs.base import InputShape
    shape = InputShape("mesh_lm", LM_SEQ, LM_BATCH, "train")
    eng = planlib.make_train_engine("deepseek-7b", shape, mesh, reduced=True,
                                    num_workers=2, stale_s=2, device="cpu",
                                    **kw)
    stream = synthetic.token_lm_stream(3, eng_vocab("deepseek-7b"), LM_SEQ,
                                       LM_BATCH)
    _, m = eng.step(eng.init(0), {"tokens": next(stream)})
    return {"delivery": eng.meta["kernels"]["delivery"],
            "sparsity": float(m.get("sparsity", 0.0))}


def collectives_case(world: int) -> dict:
    """``placement.all_gather_dim`` in pieces of 40 bytes (uneven parts,
    each dim) against the whole tensor every rank drew, and
    ``reduce_scatter_dim`` (the exchange) against this rank's chunk of the
    ranks' tensors summed in rank order."""
    import torch.distributed as dist
    from repro_torch.engine import placement as pl
    rank, piece = dist.get_rank(), pl.GATHER_PIECE_BYTES
    gen = torch.Generator().manual_seed(0)
    pl.GATHER_PIECE_BYTES = 40
    try:
        gathers = []
        for shape, d in (((7, 5), 0), ((4, 9, 3), 1), ((5,), 0),
                         ((3, 8), 1), ((1, 6), 0)):
            whole = torch.randn(shape, generator=gen)
            part = whole.narrow(d, *pl.chunk_span(shape[d], world, rank))
            gathers.append(torch.equal(
                pl.all_gather_dim(dist, part, d, shape[d], world, None),
                whole))
    finally:
        pl.GATHER_PIECE_BYTES = piece
    grads = [torch.randn((3, 4 * world, 5), generator=gen)
             for _ in range(world)]
    want = grads[0]
    for g in grads[1:]:
        want = want + g
    got = pl.reduce_scatter_dim(dist, grads[rank], 1, world, None)
    return {"gathers": gathers,
            "reduce_scatter": torch.equal(got, want.narrow(1, 4 * rank, 4))}


def _raised(build) -> str:
    try:
        build()
    except NotImplementedError as e:
        return str(e)
    return "did not raise"


def rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """Spawn target: join the gloo group and run this world size's cases."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    os.environ.setdefault("MASTER_ADDR", "localhost")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = {"raises": {}, "collectives": collectives_case(world)}
        mesh = make_host_mesh(world, 1, device="cpu")
        out["raises"]["fsdp-compress"] = _raised(
            lambda: planlib.make_train_engine(
                "deepseek-67b", "train_4k", mesh, stale_s=2, reduced=True,
                compress="topk:0.1", device="cpu"))
        for name in MLP_CASES:
            out[name] = mlp_case(name, mesh)
        out["fsdp"] = {}
        for label, (data, model) in FSDP_MESHES.items():
            if data * model != world:
                continue
            fmesh = make_host_mesh(data, model, device="cpu")
            out["fsdp"][label] = {name: fsdp_case(name, fmesh, label)
                                  for name in fsdp_cases(label)}
            if label == "2x1":
                out["fsdp"][label]["planted"] = fsdp_case(
                    "deepseek-67b-ssp", fmesh, label, plant=True)
        if world == 2:
            out["restore"] = restore_case(mesh, out_dir)
            out["plan_in_shardings"] = planlib.make_train_engine(
                "deepseek-7b", "train_4k", mesh, stale_s=2, reduced=True,
                device="cpu").plan().in_shardings[0].inner.gbuf
        if world == 4:
            mesh22 = make_host_mesh(2, 2, device="cpu")
            out["restore"] = restore_case(mesh22, out_dir, ("model",))
            out["constraint"] = constraint_case(mesh22)
            out["model-runs"] = {}
            for what, kw in (("model-compress", dict(compress="topk:0.1")),
                             ("model-kernels", dict(kernels="on"))):
                out["raises"][what] = _raised(lambda: build_engine(
                    tmlp.loss_fn, topt.sgd(0.1),
                    EngineConfig(mode="stale-psum", s=2, num_workers=2, **kw),
                    mesh=mesh22, device="cpu"))
                out["model-runs"][what] = model_axis_run(mesh22, **kw)
            for name in LM_CASES:
                out[name] = lm_case(name, mesh22)
        serve_meshes = {"2x2": (2, 2)} if world == 4 else {"2x1": (2, 1),
                                                            "1x2": (1, 2)}
        out["serve"] = {}
        for label, (data, model) in serve_meshes.items():
            smesh = make_host_mesh(data, model, device="cpu")
            got = {name: serve_case(name, smesh) for name in SERVE_CASES}
            sub = os.path.join(out_dir, f"serve-{label}")
            got["refresh"] = refresh_case(sub, smesh)
            if model > 1:
                got["restore"] = serve_restore_case(smesh, sub)
            if label == "2x1":
                got.update({name: serve_case(name, smesh)
                            for name in FSDP_SERVE_CASES})
                got["refresh-67b"] = refresh_case(
                    sub + "-67b", smesh, "deepseek-67b", "auto")
                got["fsdp-init"] = fsdp_serve_init_case(smesh)
            out["serve"][label] = got
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- tensor-parallel compute on the model axis (``test_torch_tp.py``) ---------

# JAX attention mode (or the MoE experts) -> reduced arch; each runs with
# ``tp = 2``, so the modes are those of the full configs at tp = 16, and
# with remat on, so every layer's collectives run again in the backward.
TP_ARCHS = {"head": "deepseek-7b", "mixed": "h2o-danube-1.8b",
            "contraction": "qwen3-14b", "moe": "qwen2-moe-a2.7b"}
TP_OVERRIDES = {"tp": 2, "remat": True}
TP_SEQ, TP_BATCH, TP_P, TP_STEPS = 16, 4, 2, 3
TP_MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
TP_MODES = ("simulate", "stale-psum", "ssp", "sync")
# A config whose packed row fits EXACT_TOPK_MAX (the exact threshold).
TP_TINY = dict(TP_OVERRIDES, num_layers=1, d_model=32, num_heads=2,
               num_kv_heads=2, head_dim=8, d_ff=64, vocab=64, vocab_real=60)


def tp_api(arch: str, **extra):
    from repro_torch import configs as cfglib
    return cfglib.get(arch).api(reduced=True,
                                overrides={**TP_OVERRIDES, **extra})


def tp_tokens(vocab: int, seed: int = 3):
    return torch.as_tensor(next(synthetic.token_lm_stream(
        seed, vocab, TP_SEQ, TP_BATCH)))


def _model_whole(place, tree) -> list:
    """Each leaf of a tree of this rank's model shards made whole over the
    model group (c10d ``all_gather``)."""
    import torch.distributed as dist
    from repro_torch.engine.placement import all_gather_dim
    out = []
    for x, (_, md), shape in zip(tm.tree_leaves(tree), place._dims,
                                 place.full_shapes):
        if md is not None:
            x = all_gather_dim(dist, x.contiguous(), md, shape[md], place.m,
                               place.model_axis.group)
        out.append(x.detach().clone())
    return out


def moe_drops_overrides() -> dict:
    """The reduced qwen2-moe's MoE settings with capacity drops (capacity
    factor 0.5) and the aux loss dominant (weight 10)."""
    import dataclasses
    moe = tp_api("qwen2-moe-a2.7b").cfg.moe
    return {"moe": dataclasses.replace(moe, capacity_factor=0.5,
                                       aux_weight=10.0)}


def tp_grad_case(mode: str, mesh=None, plant: bool = False,
                 **extra) -> dict:
    """The loss and every leaf's gradient of one batch through the
    engine's loss: one process on whole params, or this rank's model
    shards on the tensor-parallel route (the gradients gathered whole).
    Also how often the loss gathered a model-sharded leaf: the model
    axis's gathers and ``placement.full`` calls. ``plant``: "reduce" made
    the identity (each rank keeps its partial sums); ``extra``: config
    overrides."""
    from repro_torch.engine import api as api_lib
    from repro_torch.engine import placement as pl
    arch = TP_ARCHS[mode]
    api = tp_api(arch, **extra)
    params = api.init(0, device="cpu")[0]
    batch = {"tokens": tp_tokens(api.vocab_real)[None]}
    if mesh is None:
        leaves, treedef = tm.tree_flatten(params)
        leaves = [x.requires_grad_(True) for x in leaves]
        loss = api.loss(tm.tree_unflatten(treedef, leaves),
                        {"tokens": batch["tokens"][0]})
        return {"loss": loss.detach(), "grads": [
            g.detach() for g in torch.autograd.grad(loss, leaves)]}
    eng = build_engine(api, topt.sgd(0.1), EngineConfig(mode="sync"),
                       mesh=mesh, arch=arch, device="cpu")
    place = eng.placement
    if plant:
        place.model_parallel.reduce = lambda x: x
    place.set_full_shapes(params)
    shards = place.shard_params(params)
    leaves, treedef = tm.tree_flatten(shards)
    leaves = [x.unsqueeze(0).requires_grad_(True) for x in leaves]
    calls = []
    real_full = place.full
    place.full = lambda *a, **k: calls.append(1) or real_full(*a, **k)
    place.model_axis.record = []
    loss = api_lib._mesh_loss(api_lib._stacked_loss(api.loss), place, mesh,
                              False)(tm.tree_unflatten(treedef, leaves),
                                     batch)[0]
    grads = torch.autograd.grad(loss, leaves)
    traffic, place.model_axis.record = place.model_axis.record, None
    return {"loss": loss.detach(),
            "grads": _model_whole(place, [g[0] for g in grads]),
            "full_calls": len(calls), "traffic": traffic,
            "model_compute": eng.meta["model_compute"]}


def tp_engine_case(mode: str, mesh=None, label: str = "1x2",
                   arch: str = "deepseek-7b", **kw) -> dict:
    """Reduced ``arch`` at tp = 2 through ``make_train_engine`` with
    kernels on (P = 2, Adam unless ``optimizer_name``): each step's loss
    and grad_norm (and sparsity), the whole params at the end, the
    engine's routes, and on a mesh the model axis's traffic and
    ``placement.full`` calls over one more step. Without a mesh it runs
    under ``use_mesh`` of the label's shape (the MoE's groups)."""
    from repro_torch.configs.base import InputShape
    data, model = TP_MESHES[label]
    shape = InputShape("mesh_tp", TP_SEQ, TP_BATCH, "train")
    p = kw.pop("num_workers", TP_P)
    kw.setdefault("kernels", "on")
    eng = planlib.make_train_engine(
        arch, shape, mesh, reduced=True, overrides=TP_OVERRIDES,
        num_workers=p, mode=mode, stale_s=0 if mode == "sync" else 2,
        device="cpu", **kw)
    stream = synthetic.token_lm_stream(5, eng_vocab(arch), TP_SEQ, TP_BATCH)

    def batch():
        tokens = torch.as_tensor(next(stream))
        if mode == "simulate":
            tokens = tokens.reshape(p, TP_BATCH // p, -1)
        return {"tokens": tokens}

    out = {"losses": [], "grad_norms": [], "sparsity": [],
           "kernels": eng.meta["kernels"],
           "model_compute": eng.meta.get("model_compute")}
    ambient = rules_lib.AbstractMesh(("data", "model"), (data, model))
    with rules_lib.use_mesh(ambient if mesh is None else None):
        state = eng.init(0)
        out["init"] = _whole(eng.params(state))
        for _ in range(TP_STEPS):
            state, m = eng.step(state, batch())
            out["losses"].append(float(m["loss"]))
            for key, into in (("grad_norm", "grad_norms"),
                              ("sparsity", "sparsity")):
                if key in m:
                    out[into].append(float(m[key]))
        out["params"] = _whole(eng.params(state))
        if mesh is not None:
            place = eng.placement
            calls = []
            real_full = place.full
            place.full = lambda *a, **k: calls.append(1) or real_full(*a, **k)
            place.model_axis.record = []
            eng.step(state, batch())
            out["traffic"], place.model_axis.record = (
                place.model_axis.record, None)
            out["full_calls"] = len(calls)
    return out


TP_ENGINE_CASES = {mode: dict(mode=mode) for mode in TP_MODES}
TP_ENGINE_CASES.update({
    "stale-psum-sgd-topk": dict(mode="stale-psum", compress="topk:0.05",
                                optimizer_name="sgd"),
    "stale-psum-adam-topk": dict(mode="stale-psum", compress="topk:0.05"),
    "sync-sgd-topk": dict(mode="sync", compress="topk:0.05",
                          optimizer_name="sgd"),
})


# Reduced deepseek-67b at tp = 2 (mixed attention) in sync at 2x2: FSDP's
# per-layer data-axis gathers beside the tensor-parallel model axis.
TP_FSDP = dict(mode="sync", arch="deepseek-67b", num_workers=4,
               kernels="auto")


def tp_threshold_case(mesh, label: str) -> dict:
    """The top-k threshold and sparsity of the whole packed row from each
    rank's packed shards, against the one-process functions on the whole
    accumulator (which every rank holds here): two ``[2, D]`` rows of a
    drawn accumulator, at a packed row above ``EXACT_TOPK_MAX`` (reduced
    deepseek-7b, the strided sample) and below it (``TP_TINY``)."""
    from repro_torch.compensate import sparsify as sp
    from repro_torch.engine import placement as pl
    from repro_torch.kernels import dispatch
    out = {}
    for name, extra in (("sampled", {}), ("exact", TP_TINY)):
        api = tp_api("deepseek-7b", **extra)
        specs = planlib.params_specs(api, mesh, "deepseek-7b")
        place = pl.MeshPlacement(mesh, TP_P, specs)
        params = api.init(0, device="cpu")[0]
        place.set_full_shapes(params)
        gen = torch.Generator().manual_seed(11)
        acc = tm.tree_map(lambda x: torch.randn(
            (2,) + tuple(x.shape), generator=gen), params)
        whole = tm.tree_pack(acc, lead_ndim=1, pad_to=dispatch.PACK_ALIGN)
        total = tm.pack_spec(params).total
        shards = [x if md is None else x.narrow(md + 1, *pl.chunk_span(
            shape[md], place.m, place.model_axis.rank))
            for x, (_, md), shape in zip(tm.tree_leaves(acc), place._dims,
                                         place.full_shapes)]
        local = tm.tree_pack(shards, lead_ndim=1, pad_to=dispatch.PACK_ALIGN)
        got = {}
        for amount in (0.01, 0.3, 7.0):
            k = sp.topk_count(amount, total)
            want = sp.topk_threshold(whole.abs(), k, total)
            thr = place.row_threshold(local.abs(), k)
            sent_whole = whole * (whole.abs() >= want[:, None])
            sent = local * (local.abs() >= thr[:, None])
            got[amount] = (thr, want, place.row_sparsity(sent),
                           sp.sparsity_of(sent_whole, total))
        out[name] = {"total": total, "got": got}
    return out


def tp_route_case(mesh) -> dict:
    """``meta["model_compute"]`` (and its fallback) of engines on ``mesh``:
    the tensor-parallel route needs a decoder-only transformer whose every
    model-sharded dim the extent divides."""
    from repro_torch.configs.base import InputShape
    shape = InputShape("mesh_tp", TP_SEQ, TP_BATCH, "train")
    out = {}
    for arch, overrides in (("deepseek-7b", None),
                            ("h2o-danube-1.8b", None),
                            ("h2o-danube-1.8b", {"tp": 2}),
                            ("whisper-base", None),
                            ("llama-3.2-vision-11b", None),
                            ("mamba2-1.3b", None),
                            ("zamba2-7b", None)):
        eng = planlib.make_train_engine(arch, shape, mesh, reduced=True,
                                        overrides=overrides, stale_s=2,
                                        device="cpu")
        out[arch, bool(overrides)] = (eng.meta["model_compute"],
                                      eng.meta.get("model_compute_fallback"))
    return out


# -- serving on the model axis's shards (``test_torch_tp.py``) ------------------

# The serve cases of each mesh: (arch, route, temperature) over the four
# layouts at 1x2, deepseek-7b (head) at 2x2; the routes pinned as the
# serve cases above pin them.
TP_SERVE_ROUTES = {"paged": "on", "gather": "off"}
TP_SERVE_TEMPS = {"greedy": 0.0, "t0.7": 0.7}
# The served families a model axis cannot compute tensor-parallel: the
# state-space LM (resident route) and the encoder-decoder (cross layers).
TP_SERVE_GATHERED = ("mamba2-1.3b", "whisper-base")
# Each case's stream: three requests over the two slots (the third joins
# after the first is evicted), shorter than SERVE_GENS to keep the grid's
# time down.
TP_SERVE_GENS = (3, 6, 3)


# At 2x2 also the FSDP arch (reduced deepseek-67b, mixed attention at
# tp = 2) on its data blocks and model shards; the FSDP placement vetoes
# the paged route.
TP_SERVE_FSDP = ("deepseek-67b", "gather", "greedy")


def tp_serve_cases(label: str) -> list:
    archs = TP_ARCHS.values() if label == "1x2" else ("deepseek-7b",)
    return [(arch, route, temp) for arch in archs for route in TP_SERVE_ROUTES
            for temp in TP_SERVE_TEMPS] + (
        [TP_SERVE_FSDP] if label == "2x2" else [])


def tp_server(arch: str, route: str, temp: str, mesh, overrides=None):
    from repro_torch.serving import Server, ServingConfig
    return Server(ServingConfig(
        arch=arch, overrides=TP_OVERRIDES if overrides is None else overrides,
        paged=TP_SERVE_ROUTES[route], temperature=TP_SERVE_TEMPS[temp],
        **SERVE), device="cpu", mesh=mesh)


def served_bytes(server) -> tuple:
    """(bytes of the params the server serves, bytes of this rank's blocks
    of them, whether each leaf has its block's shape). A rank's block of a
    leaf: 1/N of each dim its spec puts on the data axis (N the extent,
    where N divides the dim) and, on the tensor-parallel route, its
    ``torch.chunk`` part of the dim on the model axis."""
    pl = server.placement
    n, mp, have = rules_lib.data_extent(server.mesh), pl.model_parallel, 0
    want, shapes_ok = 0, True
    for x, spec, shape in zip(tm.tree_leaves(server.params), pl.specs,
                              pl.shapes):
        cut = list(shape)
        for d, part in enumerate(spec):
            names = rules_lib._names(part)
            if "data" in names and shape[d] % n == 0:
                cut[d] = shape[d] // n
            if "model" in names and mp is not None:
                cut[d] = mp.span(shape[d])[1]
        have += x.numel() * x.element_size()
        want += int(np.prod(cut)) * x.element_size()
        shapes_ok &= tuple(x.shape) == tuple(cut)
    return have, want, shapes_ok


def tp_serve_ref(arch: str, route: str, temp: str) -> dict:
    """The TP_SERVE_GENS stream served by one process (no mesh), its picks
    recorded (``chip_smoke.Forcing``): the record, the served tokens and
    the pool width."""
    from chip_smoke import Forcing
    server = tp_server(arch, route, temp, None)
    with Forcing(server) as rec:
        report = server.run(_serve_requests(server, TP_SERVE_GENS))
    return dict(rec.record(), pool_width=server.layout.width,
                tokens={r.rid: r.tokens for r in report.completed})


def tp_serve_case(arch: str, route: str, temp: str, mesh, ref: dict,
                  plant: bool = False) -> dict:
    """The TP_SERVE_GENS stream served on ``mesh``, teacher-forced with
    the tokens of its one-process reference ``ref`` (``tp_serve_ref``):
    both records, the mesh serve's model-axis route, pool widths, served
    bytes and the placement's model-axis whole gathers. ``plant``:
    "reduce" made the identity."""
    from chip_smoke import Forcing
    server = tp_server(arch, route, temp, mesh)
    if plant:
        server.model_parallel.reduce = lambda x: x
    with Forcing(server, ref["tokens"]) as rec:
        server.run(_serve_requests(server, TP_SERVE_GENS))
    return {"ref": ref, "got": rec.record(),
            "model_compute": server.model_compute,
            "route": server.paged_route,
            "pool_width": (server.layout.width, ref["pool_width"]),
            "plan": {k: server.splan.meta.get(k) for k in (
                "model_compute", "model_compute_fallback", "pool_width")},
            "bytes": served_bytes(server),
            "whole_gathers": server.placement.whole_gathers}


def tp_serve_init_case(mesh) -> dict:
    """Reduced deepseek-7b at tp = 2 inited by the server itself (no
    params handed in): whether its params are bitwise its shards of the
    one-process init, the bytes of the values the placement's ``keep``
    kept and of the served params, and the init's largest live param
    bytes (the values kept so far plus the one being drawn) against the
    whole params'."""
    from repro_torch.engine.placement import ServePlacement
    live = {"kept": 0, "peak": 0}
    keep = ServePlacement.keep

    def counted(self, x, axes):
        live["peak"] = max(live["peak"],
                           live["kept"] + x.numel() * x.element_size())
        out = keep(self, x, axes)
        live["kept"] += out.numel() * out.element_size()
        return out
    ServePlacement.keep = counted
    try:
        server = tp_server("deepseek-7b", "paged", "greedy", mesh)
    finally:
        ServePlacement.keep = keep
    whole = server.api.init(server.cfg.seed, device="cpu")[0]
    want = server.placement.from_whole(whole)
    return {"shards": all(torch.equal(a, b) for a, b in zip(
                tm.tree_leaves(server.params), tm.tree_leaves(want))),
            "kept": live["kept"], "peak": live["peak"],
            "served": sum(x.numel() * x.element_size()
                          for x in tm.tree_leaves(server.params)),
            "whole": sum(x.numel() * x.element_size()
                         for x in tm.tree_leaves(whole))}


def tp_refresh_dirs(out_dir: str, rank: int) -> dict:
    """Snapshot 1 of reduced deepseek-7b at tp = 2 in ``boot`` and
    snapshots 1 and 2 in ``live``, written by each rank for itself."""
    dirs = {k: os.path.join(out_dir, f"tp-refresh-{rank}-{k}")
            for k in ("boot", "live")}
    api = tp_api("deepseek-7b")
    for step in (1, 2):
        params, _ = api.init(step, device="cpu")
        for k in ("boot", "live") if step == 1 else ("live",):
            ckpt.save(ckpt.step_path(dirs[k], step), params, step=step,
                      extra={"published_at": time.time()})
    return dirs


def tp_refresh_run(dirs: dict, mesh=None, force=None) -> tuple:
    """Reduced deepseek-7b at tp = 2 on the paged route (on ``mesh``, else
    one process), booted from snapshot 1 of ``boot``, a warm-up request,
    then the SERVE_GENS stream with a refresher on ``live`` every
    REFRESH_EVERY decode steps, teacher-forced with ``force`` where given:
    its record, the decode step each swap landed on, the boot's and the
    last step and the served tokens; and the server."""
    from chip_smoke import Forcing
    server = tp_server("deepseek-7b", "paged", "greedy", mesh)
    boot = server.restore_params(dirs["boot"])
    server.run(_serve_requests(server, gens=(3,), seed=4))
    refresher = server.make_refresher(dirs["live"], REFRESH_EVERY, boot)
    swaps, swap = [], refresher.swap
    refresher.swap = lambda step, extra: (
        swaps.append(server.decode_steps), swap(step, extra))
    with Forcing(server, force) as rec:
        report = server.run(_serve_requests(server))
    return dict(rec.record(), swaps=swaps, boot=boot,
                step=refresher.current_step, tokens={
                    r.rid: r.tokens for r in report.completed}), server


def tp_refresh_case(mesh, dirs: dict, ref: dict) -> dict:
    """``tp_refresh_run`` on ``mesh`` teacher-forced with the one-process
    run ``ref``'s tokens: both records, whether the mesh's served params
    after the swap are bitwise its shards of snapshot 2, and the
    placement's model-axis whole gathers."""
    got, server = tp_refresh_run(dirs, mesh, ref["tokens"])
    want = server.placement.from_whole(
        tp_api("deepseek-7b").init(2, device="cpu")[0])
    return {"ref": ref, "got": got,
            "shards_of_2": all(torch.equal(a, b) for a, b in zip(
                tm.tree_leaves(server.params), tm.tree_leaves(want))),
            "whole_gathers": server.placement.whole_gathers}


def tp_gathered_serve(arch: str, mesh=None) -> tuple:
    """A family the model axis cannot compute tensor-parallel, served
    greedy on the paged route (where it has one; "on" overrides the model
    axis's veto) on ``mesh`` (else by one process): ``_served`` of it and
    the server."""
    from repro_torch.serving import Server, ServingConfig
    server = Server(ServingConfig(arch=arch, paged="on", **SERVE),
                    device="cpu", mesh=mesh)
    return _served(server, server.run(_serve_requests(server))), server


def tp_gathered_serve_case(arch: str, mesh, ref: dict) -> dict:
    """``tp_gathered_serve`` on ``mesh`` beside its one-process ``ref``,
    and whether the mesh serves whole params."""
    got, server = tp_gathered_serve(arch, mesh)
    return {"ref": ref, "got": got, "whole": all(
        tuple(x.shape) == shape for x, shape in zip(
            tm.tree_leaves(server.params), server.placement.shapes))}


def tp_rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """Spawn target of ``test_torch_tp.py``: the tensor-parallel cases of
    this world size (2: the 1x2 mesh, 4: 2x2)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    label = "1x2" if world == 2 else "2x2"
    # The serves' one-process references, before this rank joins the group
    # (a Server in a process group serves on its mesh).
    refs = {case: tp_serve_ref(*case) for case in tp_serve_cases(label)}
    if world == 2:
        dirs = tp_refresh_dirs(out_dir, rank)
        refresh_ref = tp_refresh_run(dirs)[0]
        gathered_refs = {arch: tp_gathered_serve(arch)[0]
                         for arch in TP_SERVE_GATHERED}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*TP_MESHES[label], device="cpu")
        out = {"engine": {name: tp_engine_case(mesh=mesh, label=label, **kw)
                          for name, kw in TP_ENGINE_CASES.items()},
               "threshold": tp_threshold_case(mesh, label),
               "serve": {case: tp_serve_case(*case, mesh, refs[case])
                         for case in tp_serve_cases(label)}}
        if world == 2:
            out["serve_planted"] = tp_serve_case(
                "deepseek-7b", "paged", "greedy", mesh,
                refs["deepseek-7b", "paged", "greedy"], plant=True)
            out["serve_init"] = tp_serve_init_case(mesh)
            out["serve_refresh"] = tp_refresh_case(mesh, dirs, refresh_ref)
            out["serve_gathered"] = {
                arch: tp_gathered_serve_case(arch, mesh, gathered_refs[arch])
                for arch in TP_SERVE_GATHERED}
            out["grads"] = {mode: tp_grad_case(mode, mesh)
                            for mode in TP_ARCHS}
            out["planted"] = tp_grad_case("head", mesh, plant=True)
            out["moe_drops"] = tp_grad_case("moe", mesh,
                                            **moe_drops_overrides())
            out["routes"] = tp_route_case(mesh)
        else:
            out["engine"]["moe-stale-psum"] = tp_engine_case(
                "stale-psum", mesh, label, arch="qwen2-moe-a2.7b")
            from torch.distributed.device_mesh import init_device_mesh
            pods = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=(
                "pod", "data", "model"))
            out["raises"] = {
                "pod": _raised(lambda: build_engine(
                    tmlp.loss_fn, topt.sgd(0.1),
                    EngineConfig(mode="sync", num_workers=4), mesh=pods,
                    device="cpu")),
                "fsdp-compress": _raised(lambda: planlib.make_train_engine(
                    "deepseek-67b", "train_4k", mesh, stale_s=2,
                    reduced=True, overrides={"tp": 2}, compress="topk:0.1",
                    device="cpu"))}
            out["fsdp"] = tp_engine_case(**TP_FSDP, mesh=mesh, label=label)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
