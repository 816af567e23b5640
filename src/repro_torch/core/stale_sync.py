"""Distributed staleness as a data-parallel training step, port of
``repro/core/stale_sync.py``.

Modes
-----
* ``stale-psum``: the Async-SGD of Theorem 1. Params are global; each
  worker's gradient enters a ring of ``s`` slots, and the aggregate at step
  k sums, per worker, the gradient from step ``k - d_p`` (``d_p`` from the
  delay spec). The ring is ``[slots, P, ...]`` (per-worker delays) or
  ``[slots, ...]`` (Theorem 1's one delayed aggregate per step).
* ``sync``: the s = 0 baseline, buffer-free (``make_sync_train_step_lean``).

Per-worker gradients follow the port's worker-stacked loss contract: the
shared params are stacked to ``[P, ...]`` and one backward of the ``[P]``
loss sum gives each worker's own gradient (``optim.value_and_grad``). The
aggregate and sync forms stack to ``[1, ...]`` over the whole batch.

Layouts: ``kernels=False`` keeps a per-leaf ring in plain torch;
``kernels=True`` keeps ONE packed ``[slots(, P), D]`` ring and delivers
through ``dispatch.stale_accum``; ``fused_update=True`` runs the whole
post-gradient tail as ONE ``dispatch.fused_update`` pass (EF split, weighted
delivery, Adam over packed moments).

The ring, like every state tensor, is updated IN PLACE, as the JAX engine
does through buffer donation: a state passed to ``step`` is consumed and
must not be stepped again. Ring rows are gathered with ``index_select``,
which copies, so a gather made before the ring write (the compressed fused
tail) is never changed by it. The step count is a Python int; the realized
delays, the top-k thresholds and the LR factor stay on the device, so
nothing in a step reads the device on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.delays.models import DelaySpec, UniformDelay, as_spec
from repro_torch.delays.schedule import Schedule
from repro_torch.kernels import dispatch
from repro_torch.optim.optimizers import Optimizer, lr_at, value_and_grad

Pytree = Any


@dataclasses.dataclass(frozen=True)
class StaleSyncConfig:
    num_workers: int                 # data-parallel extent
    s: int                           # staleness bound (0 = synchronous)
    delay: Optional[DelaySpec] = None   # None = UniformDelay(s)
    buffer_dtype: Any = torch.float32
    # True: per-worker delays d_p over a [slots, P, ...] ring. False: ONE
    # delay per step over the aggregate gradient, ring [slots, ...].
    per_worker_delays: bool = True
    # Deterministic int [T, P] delays indexed by step mod T (how the engine
    # runs SSP).
    delay_table: Optional[Any] = None
    # Packed [slots(, P), D] ring delivered through dispatch.stale_accum.
    kernels: bool = False
    # One-pass megakernel tail (dispatch.fused_update) with the Adam moments
    # packed in opt_state; needs kernels=True and an Adam-spec optimizer.
    fused_update: bool = False

    def __post_init__(self):
        if self.delay is None:
            object.__setattr__(self, "delay", UniformDelay(self.s))
        else:
            object.__setattr__(self, "delay", as_spec(self.delay))
        if self.delay_table is not None and not self.per_worker_delays:
            raise ValueError("delay_table requires per_worker_delays=True")
        if self.fused_update and not self.kernels:
            raise ValueError("fused_update=True requires kernels=True "
                             "(the megakernel runs over the packed ring)")

    @property
    def slots(self) -> int:
        return max(self.s, 1)


@dataclasses.dataclass
class StaleTrainState:
    params: Pytree
    opt_state: Pytree
    gbuf: Pytree          # [slots, P, ...] ring (packed: [slots, P, D])
    step: int
    key: torch.Generator  # delay randomness


def _packed_width(params: Pytree) -> int:
    return tm.padded_size(tm.pack_spec(params).total, dispatch.PACK_ALIGN)


def _packed_adam_state(params: Pytree) -> dict:
    """Megakernel layout: Adam moments packed at the ring width."""
    width = _packed_width(params)
    dev = tm.tree_leaves(params)[0].device
    return {"step": 0, "m": torch.zeros((width,), device=dev),
            "v": torch.zeros((width,), device=dev)}


def _require_adam(optimizer: Optimizer, what: str) -> None:
    spec = getattr(optimizer, "spec", None)
    if not (spec and spec.get("name") == "adam"):
        raise ValueError(f"{what} needs an optimizer with an Adam spec "
                         "(optimizers.adam(...)); got an opaque optimizer")


def init_state(params: Pytree, optimizer: Optimizer, cfg: StaleSyncConfig,
               key, rows: Optional[int] = None,
               buf_like: Pytree = None) -> StaleTrainState:
    """Zero ring and optimizer state. ``key`` is an int seed or a
    ``torch.Generator`` on the params' device. ``rows`` (default: all P)
    is the number of workers whose ring rows this process holds on a
    mesh; ``buf_like`` (default: ``params``) gives the tree ring's rows
    their shapes (an FSDP arch's per-worker ring holds whole rows beside
    data-sharded params)."""
    dev = tm.tree_leaves(params)[0].device
    gen = key if isinstance(key, torch.Generator) else device_lib.generator(key, dev)
    lead = ((cfg.slots, cfg.num_workers if rows is None else rows)
            if cfg.per_worker_delays else (cfg.slots,))
    if cfg.kernels:
        gbuf = torch.zeros(lead + (_packed_width(params),),
                           dtype=cfg.buffer_dtype, device=dev)
    else:
        gbuf = tm.tree_map(
            lambda x: torch.zeros(lead + tuple(x.shape),
                                  dtype=cfg.buffer_dtype, device=dev),
            params if buf_like is None else buf_like)
    opt_state = (_packed_adam_state(params) if cfg.fused_update
                 else optimizer.init(params))
    return StaleTrainState(params=params, opt_state=opt_state, gbuf=gbuf,
                           step=0, key=gen)


def mean_grad(loss_fn, params: Pytree, batch):
    """(loss, gradient) of the whole batch: params and batch stacked to a
    worker axis of 1, per the worker-stacked loss contract."""
    loss, grads = value_and_grad(
        loss_fn, tm.tree_broadcast_leading(params, 1),
        tm.tree_map(lambda x: x.unsqueeze(0), batch))
    return loss[0], tm.tree_map(lambda g: g[0], grads)


def _gather(ring: torch.Tensor, read: torch.Tensor) -> torch.Tensor:
    """Rows ``ring[read[p], p]`` of a ``[slots, P, ...]`` ring (``read``
    [P]), or ``ring[read]`` as ``[1, ...]`` of a ``[slots, ...]`` ring
    (``read`` a 0-dim tensor). A copy, read on the device."""
    if read.dim() == 0:
        return torch.index_select(ring, 0, read.reshape(1))
    slots, p = ring.shape[:2]
    rows = ring.reshape((slots * p,) + tuple(ring.shape[2:]))
    idx = read * p + torch.arange(p, device=ring.device)
    return torch.index_select(rows, 0, idx)


def _adam_delta(dneg, spec, params, factor, eta, wd) -> Pytree:
    """Unpack the fused pass's packed delta and apply the decoupled weight
    decay ``factor * eta * wd * p`` outside the kernel."""
    delta32 = tm.tree_unpack(dneg, spec, dtype=torch.float32)
    swd = factor * eta * wd if wd else None

    def leaf(dl, pp):
        if swd is not None:
            dl = dl - swd * pp
        return dl.to(pp.dtype)

    return tm.tree_map(leaf, delta32, params)


def _mesh_helpers(shard, p: int):
    """``(lo, hi, gather, mean, mean_grads, norm)`` of a process on a mesh
    (``engine.placement.MeshPlacement``), or the one-process identities."""
    if shard is None:
        return (0, p, (lambda x: x), (lambda x, split=True: x),
                (lambda t, split=True: t), tm.tree_norm)
    return (shard.lo, shard.hi, shard.gather, shard.mean, shard.mean_grads,
            shard.norm)


def _rows_mean(metrics: dict, per: bool, mean) -> dict:
    """Metrics of this process's rows, averaged over the data ranks (the
    per-worker split's sparsity); aggregate-form metrics are already
    global."""
    return {k: mean(v) for k, v in metrics.items()} if per else metrics


def make_stale_train_step(loss_fn: Callable, optimizer: Optimizer,
                          cfg: StaleSyncConfig, compensator=None,
                          shard=None):
    """Returns ``step(state, batch, bound=None, comp=None)``.

    ``batch`` leaves carry a leading global-batch axis, reshaped to
    ``[P, B/P, ...]`` so each worker computes its own gradient. ``bound``
    (an int) clamps the realized delays. With ``compensator`` each source's
    gradient is EF-sparsified before it enters the ring (the ring stores the
    sparse ``sent`` payload at the dense packed width) and the optimizer's
    delta is scaled by the staleness-aware LR factor; the step then returns
    ``(state, comp, metrics)``, else ``(state, metrics)``.

    With ``cfg.fused_update`` the post-gradient tail is ONE
    ``dispatch.fused_update`` pass. Compressed, it gathers the ring rows
    BEFORE writing this step's payload and the kernel substitutes this
    step's ``sent`` for fresh (delay 0) rows; dense, it writes first and
    reads after. Both deliver what the write-then-read order delivers.

    ``shard`` (``engine.placement.MeshPlacement``) runs the step on one
    process of a mesh. Per-worker delays: the process computes the
    gradients of its workers ``[lo, hi)`` and holds their ring rows; the
    rows each step reads are gathered from every process and reduced in the
    one-process order. The aggregate form splits the batch over the data
    ranks and averages the gradient with an all-reduce; its ring is the
    same on every process. An FSDP arch's params and optimizer state are
    data-axis shards (``MeshPlacement.fsdp``): the aggregate form reads
    them a layer at a time in its loss and reduce-scatters the gradient
    (so its ring holds shards too); the per-worker form gathers them whole
    once a step, outside autograd, so each worker's gradient and ring row
    is its own, and applies this rank's block of the aggregate."""
    p = cfg.num_workers
    lo, hi, gather, mean, mean_grads, norm = _mesh_helpers(shard, p)
    # An FSDP arch's per-worker step: whole params for the gradients, whole
    # ring rows, this rank's data block of the delivered aggregate.
    fsdp_rows = shard is not None and shard.fsdp and cfg.per_worker_delays
    if cfg.fused_update:
        _require_adam(optimizer, "fused_update=True")
    # Schedules whose bound exceeds the ring would wrap onto fresher slots,
    # so their delays are clamped (a no-op for specs the engine validated).
    if cfg.delay_table is not None:
        source = Schedule(np.asarray(cfg.delay_table)).realize(num_workers=p)
    else:
        source = cfg.delay.realize(
            num_workers=p if cfg.per_worker_delays else None)
    slots = cfg.slots
    clamp_slots = source.bound > slots - 1

    def per_worker_grads(params, batch):
        stacked = tm.tree_broadcast_leading(params, hi - lo)
        shaped = tm.tree_map(
            lambda x: x.reshape((hi - lo, x.shape[0] // (hi - lo))
                                + tuple(x.shape[1:])),
            batch)
        return value_and_grad(loss_fn, stacked, shaped)  # [P], [P, ...]

    def realized_delays(state, bound, shape):
        """The step's delays with every clamp applied, in order: ring
        size, dynamic bound, no history before step 0."""
        d = source.delays(state.key, state.step, shape)
        if clamp_slots:
            d = torch.clamp(d, max=slots - 1)
        if bound is not None:
            d = torch.clamp(d, max=int(bound))
        return torch.clamp(d, max=state.step)

    def fused_tail(state, losses, gvec, bound, comp):
        per = cfg.per_worker_delays
        write = state.step % slots
        spec = tm.pack_spec(state.params)
        dev = gvec.device
        shape = (p,) if per else ()
        if cfg.s == 0:
            d = torch.zeros(shape, dtype=torch.int64, device=dev)
        else:
            d = realized_delays(state, bound, shape)
        staleness = d if per else d.expand(p)
        mean_stale = staleness.float().mean()
        read = torch.remainder(state.step - d, slots)
        mine = read[lo:hi] if per else read

        cmetrics = {}
        factor = 1.0
        if compensator is not None and compensator.scales:
            factor = compensator.lr_factor(comp, mean_stale, state.step)
            cmetrics["lr_scale"] = factor
        osp = optimizer.spec
        ostep = state.opt_state["step"] + 1
        eta = lr_at(osp["lr"], ostep)
        m, v = state.opt_state["m"], state.opt_state["v"]
        pzero = torch.zeros_like(m)
        adam_kw = dict(lr=eta, b1=osp["b1"], b2=osp["b2"], eps=osp["eps"],
                       step=ostep, scale=factor)
        weights = (torch.full((p,), 1.0 / p, device=dev) if per
                   else torch.ones((1,), device=dev))
        gbuf = state.gbuf

        if compensator is not None and compensator.sparsifies:
            # Gather the PRE-write ring rows; the kernel delivers this
            # step's sent for fresh rows, so the payload reaches the ring
            # after the kernel.
            acc, thr, mom_in = compensator.ef_inputs(comp, gvec, spec.total)
            sel = _gather(gbuf, mine)
            if per:
                # Every worker's row enters the one pass; each process
                # keeps its own rows of the split.
                acc, thr, sel = gather(acc), gather(thr), gather(sel)
                mom_in = None if mom_in is None else gather(mom_in)
            else:
                acc, thr = acc.unsqueeze(0), thr.reshape(1)
                mom_in = None if mom_in is None else mom_in.unsqueeze(0)
            fresh = (d == 0).float().reshape(weights.shape)
            outs = dispatch.fused_update(pzero, m, v, sel, weights, acc=acc,
                                         thr=thr, fresh=fresh, mom=mom_in,
                                         **adam_kw)
            dneg, m2, v2, u, sent, resid = outs[:6]
            mom_out = outs[6] if mom_in is not None else None
            comp = compensator.ef_commit(
                comp, resid[lo:hi] if per else resid[0],
                None if mom_out is None
                else (mom_out[lo:hi] if per else mom_out[0]))
            cmetrics.update(compensator.ef_metrics(sent, spec.total))
            gbuf[write] = sent[lo:hi] if per else sent[0]
        else:
            # Dense: write first, then gather (fresh rows come back as
            # written).
            gbuf[write] = gvec
            sel = _gather(gbuf, mine)
            if per:
                sel = gather(sel)
            dneg, m2, v2, u = dispatch.fused_update(pzero, m, v, sel,
                                                    weights, **adam_kw)

        delta = _adam_delta(dneg, spec, state.params, factor, eta,
                            osp["weight_decay"])
        new_state = StaleTrainState(
            params=tm.tree_add(state.params, delta),
            opt_state={"step": ostep, "m": m2, "v": v2}, gbuf=gbuf,
            step=state.step + 1, key=state.key)
        metrics = {"loss": losses.mean(),
                   "grad_norm": (torch.sqrt(torch.sum(u * u)) if shard is None
                                 else shard.packed_norm(u, spec)),
                   "mean_staleness": mean_stale, **cmetrics}
        if compensator is not None:
            return new_state, comp, metrics
        return new_state, metrics

    def step(state: StaleTrainState, batch, bound: Optional[int] = None,
             comp: Pytree = None):
        per = cfg.per_worker_delays
        split = shard is not None and not per and shard.splits_batch(batch)
        if shard is not None:
            batch = tm.tree_map(lambda x: shard.batch_rows(x, per), batch)
        if per:
            params = (shard.data_whole(state.params) if fsdp_rows
                      else state.params)
            losses, grads = per_worker_grads(params, batch)
            del params
            losses = gather(losses)
        else:
            # The aggregate form needs only the global mean gradient: one
            # backward pass (on a mesh, one a data rank, then averaged).
            loss, gmean = mean_grad(loss_fn, state.params, batch)
            loss, gmean = mean(loss, split), mean_grads(gmean, split)
            losses, grads = loss.reshape(1), None
        if cfg.fused_update:
            # Pack, then drop the gradient tree before the fused pass: at
            # full width every [(P,) D] copy the tail holds at once counts.
            gvec = tm.tree_pack(grads if per else gmean,
                                lead_ndim=1 if per else 0,
                                pad_to=dispatch.PACK_ALIGN)
            grads = gmean = None
            return fused_tail(state, losses, gvec, bound, comp)

        write = state.step % slots
        gbuf = state.gbuf
        # Compression runs per SOURCE, before the ring write: the ring
        # stores the sparse sent payload, and the residual follows the
        # source layout ([P, D] per-worker, [D] aggregate).
        cmetrics = {}
        if cfg.kernels:
            spec = tm.pack_spec(state.params)
            gvec = tm.tree_pack(grads if per else gmean,
                                lead_ndim=1 if per else 0,
                                pad_to=dispatch.PACK_ALIGN)
            if compensator is not None and compensator.sparsifies:
                gvec, comp, cm = compensator.sparsify_packed(comp, gvec,
                                                             spec.total)
                cmetrics.update(_rows_mean(cm, per, mean))
            gbuf[write] = gvec

            def kernel_agg(sel, weights):
                aggv = dispatch.stale_accum(
                    torch.zeros((sel.shape[-1],), device=sel.device), sel,
                    weights)
                return tm.tree_unpack(aggv, spec, dtype=torch.float32)
        else:
            to_buffer = grads if per else gmean
            if compensator is not None and compensator.sparsifies:
                to_buffer, comp, cm = compensator.sparsify_tree(
                    comp, to_buffer, lead_ndim=1 if per else 0)
                cmetrics.update(_rows_mean(cm, per, mean))
            for buf, g in zip(tm.tree_leaves(gbuf),
                              tm.tree_leaves(to_buffer)):
                buf[write] = g
            if cfg.s:
                # From here on only the ring's rows are read: drop the
                # gradient tree (at full width a copy of the params).
                to_buffer = grads = gmean = None

        dev = tm.tree_leaves(gbuf)[0].device
        if cfg.s == 0:
            if cfg.kernels and per:
                agg = kernel_agg(gather(gvec),
                                 torch.full((p,), 1.0 / p, device=dev))
            elif per:
                agg = tm.tree_map(lambda g: gather(g).mean(dim=0), to_buffer)
            elif (cfg.kernels and compensator is not None
                  and compensator.sparsifies):
                # The sparse payload is what transport delivers, even with
                # zero delay: unpack the split gvec rather than gmean.
                agg = tm.tree_unpack(gvec, spec, dtype=torch.float32)
            else:
                agg = gmean if cfg.kernels else to_buffer
            staleness = torch.zeros((p,), dtype=torch.int64, device=dev)
        elif per:
            d = realized_delays(state, bound, (p,))
            read = torch.remainder(state.step - d, slots)[lo:hi]  # [P]
            if cfg.kernels:
                agg = kernel_agg(gather(_gather(gbuf, read)),
                                 torch.full((p,), 1.0 / p, device=dev))
            else:
                agg = tm.tree_map(
                    lambda buf: gather(_gather(buf, read)).float().mean(dim=0),
                    gbuf)
            staleness = d
        else:
            # Theorem-1 form: one delayed AGGREGATE gradient per step.
            d = realized_delays(state, bound, ())
            read = torch.remainder(state.step - d, slots)
            if cfg.kernels:
                agg = kernel_agg(_gather(gbuf, read),
                                 torch.ones((1,), device=dev))
            else:
                agg = tm.tree_map(lambda buf: _gather(buf, read)[0].float(),
                                  gbuf)
            staleness = d.expand(p)

        mean_stale = staleness.float().mean()
        if fsdp_rows:
            # The whole aggregate's norm, in the one-process order; then
            # this rank's block of it.
            grad_norm = norm(agg, data=False)
            agg = shard.data_part(agg)
        else:
            grad_norm = norm(agg)
        delta, opt_state = optimizer.update(agg, state.opt_state,
                                            state.params)
        agg = None          # the delivered copy: not needed past the update
        if compensator is not None and compensator.scales:
            factor = compensator.lr_factor(comp, mean_stale, state.step)
            delta = compensator.scale_tree(delta, factor)
            cmetrics["lr_scale"] = factor
        new_state = StaleTrainState(
            params=tm.tree_add(state.params, delta), opt_state=opt_state,
            gbuf=gbuf, step=state.step + 1, key=state.key)
        metrics = {"loss": losses.mean(), "grad_norm": grad_norm,
                   "mean_staleness": mean_stale, **cmetrics}
        if compensator is not None:
            return new_state, comp, metrics
        return new_state, metrics

    return step


def make_sync_train_step(loss_fn: Callable, optimizer: Optimizer):
    """Plain synchronous data-parallel step over a :class:`StaleTrainState`
    (its ring is carried along untouched)."""

    def step(state: StaleTrainState, batch):
        loss, grads = mean_grad(loss_fn, state.params, batch)
        delta, opt_state = optimizer.update(grads, state.opt_state,
                                            state.params)
        new_state = StaleTrainState(
            params=tm.tree_add(state.params, delta), opt_state=opt_state,
            gbuf=state.gbuf, step=state.step + 1, key=state.key)
        return new_state, {"loss": loss, "grad_norm": tm.tree_norm(grads)}

    return step


@dataclasses.dataclass
class SyncTrainState:
    """Buffer-free state of the synchronous baseline."""
    params: Pytree
    opt_state: Pytree
    step: int


def init_sync_state(params: Pytree, optimizer: Optimizer,
                    fused: bool = False) -> SyncTrainState:
    """``fused=True`` stores the Adam moments packed (the megakernel
    layout)."""
    opt_state = (_packed_adam_state(params) if fused
                 else optimizer.init(params))
    return SyncTrainState(params=params, opt_state=opt_state, step=0)


def make_sync_train_step_lean(loss_fn: Callable, optimizer: Optimizer,
                              compensator=None, fused: bool = False,
                              shard=None):
    """Buffer-free synchronous step: ``step(state, batch, comp=None)``.

    ``fused=True`` (an Adam-spec optimizer) runs the post-gradient tail over
    the packed [D] view with the moments packed in opt_state: with
    compression, ONE ``dispatch.fused_update`` pass in which the gradient
    is a single fresh row of weight 1.0 (no ring, so ``stale=None``);
    dense with an LR factor, ``fused_update`` plain over that row, which
    takes the factor as a device scalar; dense without one,
    ``dispatch.fused_adam`` alone. Staleness is identically 0 here, so
    ``inverse`` leaves the stepsize as it is and ``theorem1`` reduces to
    its schedule factor.

    ``shard`` (``engine.placement.MeshPlacement``) splits the batch over
    the data ranks of a mesh and averages the gradient with an all-reduce
    (of the packed vector when ``fused``), so every process applies the
    same update; an FSDP arch's data-sharded leaves arrive reduce-scattered
    by their per-layer gathers instead, and each process updates its
    shards."""
    if fused:
        _require_adam(optimizer, "fused=True")
    mean, mean_grads = _mesh_helpers(shard, 1)[3:5]

    def fused_tail(state, loss, box, comp):
        # The packed gradient arrives in a one-element list, so that no
        # frame keeps it once the pass has read it.
        gvec = box.pop()
        spec = tm.pack_spec(state.params)
        dev = gvec.device
        cmetrics = {}
        factor = 1.0
        if compensator is not None and compensator.scales:
            factor = compensator.lr_factor(comp, 0.0, state.step)
            cmetrics["lr_scale"] = factor
        osp = optimizer.spec
        ostep = state.opt_state["step"] + 1
        eta = lr_at(osp["lr"], ostep)
        m, v = state.opt_state["m"], state.opt_state["v"]
        pzero = torch.zeros_like(m)
        one = torch.ones((1,), device=dev)
        adam_kw = dict(lr=eta, b1=osp["b1"], b2=osp["b2"], eps=osp["eps"],
                       step=ostep, scale=factor)
        if compensator is not None and compensator.sparsifies:
            acc, thr, mom_in = compensator.ef_inputs(comp, gvec, spec.total)
            outs = dispatch.fused_update(
                pzero, m, v, None, one, acc=acc.unsqueeze(0),
                thr=thr.reshape(1),
                mom=None if mom_in is None else mom_in.unsqueeze(0),
                **adam_kw)
            dneg, m2, v2, u, sent, resid = outs[:6]
            mom_out = outs[6][0] if mom_in is not None else None
            comp = compensator.ef_commit(comp, resid[0], mom_out)
            cmetrics.update(compensator.ef_metrics(sent, spec.total))
        elif compensator is not None and compensator.scales:
            # The LR factor lives on the device: fused_update takes it as
            # a device scalar, so the step never reads it on the host.
            dneg, m2, v2, _ = dispatch.fused_update(
                pzero, m, v, gvec.unsqueeze(0), one, **adam_kw)
        else:
            # No ring, no split and no factor: delivery would be the
            # identity, so the packed Adam kernel runs alone.
            dneg, m2, v2 = dispatch.fused_adam(pzero, m, v, gvec, eta,
                                               osp["b1"], osp["b2"],
                                               osp["eps"], ostep)
        # At full width every [D] copy alive beside the new params counts.
        del gvec, pzero
        delta = _adam_delta(dneg, spec, state.params, factor, eta,
                            osp["weight_decay"])
        new_state = SyncTrainState(
            params=tm.tree_add(state.params, delta),
            opt_state={"step": ostep, "m": m2, "v": v2},
            step=state.step + 1)
        if compensator is not None:
            return new_state, comp, {"loss": loss, **cmetrics}
        return new_state, {"loss": loss}

    def step(state: SyncTrainState, batch, comp: Pytree = None):
        split = shard is not None and shard.splits_batch(batch)
        if shard is not None:
            batch = tm.tree_map(lambda x: shard.batch_rows(x, False), batch)
        loss, grads = mean_grad(loss_fn, state.params, batch)
        loss = mean(loss, split)
        if fused:
            # Pack, then drop the gradient tree before the fused pass: at
            # full width every [D] copy the tail holds at once counts.
            box = [mean(tm.tree_pack(grads, pad_to=dispatch.PACK_ALIGN),
                        split)]
            del grads
            return fused_tail(state, loss, box, comp)
        grads = mean_grads(grads, split)
        cmetrics = {}
        if compensator is not None:
            grads, comp, cmetrics = compensator.sparsify_tree(comp, grads)
        delta, opt_state = optimizer.update(grads, state.opt_state,
                                            state.params)
        del grads
        if compensator is not None and compensator.scales:
            factor = compensator.lr_factor(comp, 0.0, state.step)
            delta = compensator.scale_tree(delta, factor)
            cmetrics = {**cmetrics, "lr_scale": factor}
        new_state = SyncTrainState(
            params=tm.tree_add(state.params, delta), opt_state=opt_state,
            step=state.step + 1)
        if compensator is not None:
            return new_state, comp, {"loss": loss, **cmetrics}
        return new_state, {"loss": loss}

    return step
