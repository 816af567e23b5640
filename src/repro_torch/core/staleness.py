"""The paper's staleness simulation model (Section 3), port of
``repro/core/staleness.py``.

Semantics:
  * ``P`` workers each hold a full model cache ``x_p``.
  * At iteration ``t`` every worker computes an additive update ``u_p^t``
    from its own cache.
  * The update reaches every worker ``p'`` (``p`` included) at the start of
    iteration ``t + 1 + r_{p,p'}^t``, ``r`` drawn from the delay spec.
  * Evaluation reads worker 0's cache.

Caches are stacked on a leading worker axis ``[P, ...]``; the JAX package's
``vmap`` over that axis is written out here as a batch dimension, so
``update_fn`` sees all P workers at once (see ``optim.value_and_grad``).
In-flight updates live in a delivery ring, in one of two layouts:

* tree (``kernels=False``): leaves ``[P, B, ...]`` with ``B = bound + 1``;
  slot ``d`` holds the sum of updates landing in ``d + 1`` iterations. Each
  step delivers slot 0 and rolls the buffer left.
* packed (``kernels=True``): ONE ``ring [P, B, D]`` of packed flat rows
  (``treemath.tree_pack``) addressed by a rotating cursor (slot ``t mod B``
  holds step ``t``'s arrivals), plus the prefetched ``arrived [P, D]`` row.
  Delivery runs through ``dispatch.stale_accum`` (the CUDA kernel on the
  card), then the consumed slot is zeroed, the P^2 new rows are added in,
  and the next step's row is read.

The packed step updates its ring IN PLACE, as the JAX engine does through
buffer donation: a state passed to ``step`` is consumed and must not be
stepped again. The prefetched ``arrived`` row is a copy, never a view of the
ring, so the slot zeroed at the next step cannot alias it (with ``B = 1``
every step reuses slot 0). Scattering rows that share a ``(dst, slot)``
target runs one source at a time in a fixed order, with no float atomics on
a shared element, so replays are bitwise deterministic.

The step count and the ring cursor are Python ints: ``t mod B`` and the
Adam bias corrections never force a device sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.delays.models import DelayModel, DelaySpec, as_spec
from repro_torch.kernels import dispatch
from repro_torch.optim.optimizers import lr_at, value_and_grad

Pytree = Any
# update_fn(params, update_state, batch, gen) -> (update, new_update_state, metrics)
UpdateFn = Callable[[Pytree, Pytree, Pytree, torch.Generator],
                    Tuple[Pytree, Pytree, dict]]
# server_apply(caches, server_state, arrived) -> (caches, server_state), over
# all P workers at once ([P, ...] leaves), as update_fn is.
ServerApply = Callable[[Pytree, Pytree, Pytree], Tuple[Pytree, Pytree]]


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    num_workers: int
    delay: DelaySpec
    # Apply delivered aggregates through a server-side transform instead of
    # plain addition (ablation: where does Adam state live?).
    server_side: bool = False
    # Packed [P, B, D] ring + kernel delivery (see module docstring).
    kernels: bool = False

    def __post_init__(self):
        object.__setattr__(self, "delay", as_spec(self.delay))
        if self.kernels and self.server_side:
            raise ValueError(
                "kernels=True is unsupported with server_side=True: the "
                "server transform consumes per-leaf arrivals")

    @property
    def buffer_slots(self) -> int:
        return self.delay.bound + 1


@dataclasses.dataclass
class SimState:
    caches: Pytree        # [P, ...] per-worker model caches
    pending: Pytree       # [P, B, ...] ring (packed: {"ring", "arrived"})
    update_state: Pytree  # per-worker algorithm state ([P, ...] leaves)
    server_state: Pytree  # per-worker server-side transform state (or ())
    step: int             # iteration counter
    key: torch.Generator  # delay (and stochastic-loss) randomness


def _packed_width(params: Pytree) -> int:
    return tm.padded_size(tm.pack_spec(params).total, dispatch.PACK_ALIGN)


def _is_packed(state: SimState) -> bool:
    """Packed states carry one pending dict whose tree shape differs from
    the caches tree."""
    return tm.tree_structure(state.pending) != tm.tree_structure(state.caches)


def init_sim_state(params: Pytree, update_state: Pytree,
                   cfg: StalenessConfig, key, server_state: Pytree = (),
                   rows: Optional[int] = None) -> SimState:
    """All workers start from identical ``params``; buffers start empty.

    ``update_state``/``server_state`` are given per single worker and
    broadcast across the worker axis. ``key`` is an int seed or a
    ``torch.Generator`` on the params' device. ``rows`` (default: all P)
    is the number of workers this process holds on a mesh."""
    p = cfg.num_workers if rows is None else rows
    dev = tm.tree_leaves(params)[0].device
    gen = key if isinstance(key, torch.Generator) else device_lib.generator(key, dev)
    caches = tm.tree_broadcast_leading(params, p)
    if cfg.kernels:
        width = _packed_width(params)
        pending = {
            "ring": torch.zeros((p, cfg.buffer_slots, width), device=dev),
            "arrived": torch.zeros((p, width), device=dev),
        }
    else:
        pending = tm.tree_map(
            lambda x: torch.zeros((p, cfg.buffer_slots) + tuple(x.shape),
                                  dtype=x.dtype, device=x.device), params)
    return SimState(caches=caches, pending=pending,
                    update_state=tm.tree_broadcast_leading(update_state, p),
                    server_state=tm.tree_broadcast_leading(server_state, p),
                    step=0, key=gen)


def _roll(pending: Pytree) -> Pytree:
    return tm.tree_map(
        lambda b: torch.cat([b[:, 1:], torch.zeros_like(b[:, :1])], dim=1),
        pending)


def _deliver(caches: Pytree, pending: Pytree) -> Tuple[Pytree, Pytree]:
    new_caches = tm.tree_map(lambda c, b: c + b[:, 0].to(c.dtype),
                             caches, pending)
    return new_caches, _roll(pending)


def _deliver_server(caches: Pytree, pending: Pytree, server_state: Pytree,
                    server_apply) -> Tuple[Pytree, Pytree, Pytree]:
    """Delivery through ``server_apply`` in place of the plain add."""
    arrived = tm.tree_map(lambda b: b[:, 0], pending)
    caches, server_state = server_apply(caches, server_state, arrived)
    return caches, _roll(pending), server_state


def _dispatch(pending: Pytree, updates: Pytree, delays: torch.Tensor,
              slots: int, lo: int = 0) -> Pytree:
    # onehot[src, dst, slot] routes update[src] into pending[dst, slot]; the
    # contraction over src is a fixed-order matmul. On a mesh ``updates``
    # holds every source and ``pending`` the destinations from ``lo``: the
    # product runs over all P destinations, as in one process, and this
    # process keeps its rows of it.
    onehot = (delays.unsqueeze(-1)
              == torch.arange(slots, device=delays.device)).float()

    def scatter(buf, u):
        acc = torch.tensordot(onehot, u.float(), dims=([0], [0]))  # [P,B,...]
        acc = acc[lo:lo + buf.shape[0]]
        return buf + acc.to(buf.dtype)

    return tm.tree_map(scatter, pending, updates)


def _ring_dispatch(ring: torch.Tensor, uvec: torch.Tensor,
                   delays: torch.Tensor, step: int) -> torch.Tensor:
    """Packed-layout dispatch, in place on ``ring [P, B, D]``: zero the
    consumed slot ``step mod B``, add each source's row ``uvec[src]`` into
    ``(dst, (step + 1 + r[src, dst]) mod B)`` for every dst, and return a
    copy of the next step's arrivals. One ``index_add_`` per source: within
    a source the P targets are distinct, so no element takes two adds in one
    launch, and sources add in a fixed order. On a mesh the ring holds this
    process's destinations (``delays`` their columns) and ``uvec`` every
    source, so each row takes the one-process adds in the one-process
    order."""
    p, slots, width = ring.shape
    ring[:, step % slots].zero_()
    slot = torch.remainder(delays + (step + 1), slots)           # [src, dst]
    rows = ring.view(p * slots, width)
    base = torch.arange(p, device=ring.device) * slots
    for src in range(uvec.shape[0]):
        rows.index_add_(0, base + slot[src],
                        uvec[src].unsqueeze(0).expand(p, width))
    return ring[:, (step + 1) % slots].clone()


def make_sim_step(update_fn: UpdateFn, cfg: StalenessConfig,
                  server_apply=None, compensator=None,
                  fused: Optional[dict] = None, shard=None):
    """Build one engine step: ``step(state, batches, bound=None) ->
    (state, metrics)``.

    ``batches`` carry a leading worker axis ``P`` on every leaf. ``bound``
    (an int) clamps the realized delays (the engine's dynamic staleness
    control).

    ``compensator`` (``compensate.Compensator``) compensates each worker's
    OUTGOING update before it enters the delivery ring: the update is
    scaled by the worker's realized mean delay (the per-source 1/tau rule;
    the delays are drawn in the same step) and then EF-sparsified against a
    per-worker [P, D] packed residual. The step then takes ``comp=`` and
    returns ``(state, comp, metrics)``; the tree, packed and fused steps
    all honour it.

    ``server_apply`` (with ``cfg.server_side``; tree layout only) delivers
    each iteration's arrivals as ``server_apply(caches, server_state,
    arrived)`` in place of the plain add, over all P workers at once.

    ``fused`` (requires ``kernels=True``) replaces ``update_fn`` with the
    fused compute stage: per-worker gradients of ``fused["loss"]``, then ALL
    P workers' Adam as ONE ``dispatch.fused_adam`` pass over the flattened
    [P*D] packed view, with the moments stored packed in
    ``update_state = {"m": [P, D], "v": [P, D]}``. Keys of ``fused``:
    ``loss``, ``takes_key``, ``lr``, ``b1``, ``b2``, ``eps``,
    ``weight_decay``.

    ``shard`` (``engine.placement.MeshPlacement``) runs the step for this
    process's workers ``[lo, hi)`` of a mesh: the state and the batches
    hold those rows only, every process draws the whole delay matrix, and
    the dispatch gathers every source's update before each process adds
    into its own destinations.
    """
    if cfg.server_side and server_apply is None:
        raise ValueError("server_side=True requires a server_apply transform")
    if fused is not None and not cfg.kernels:
        raise ValueError("fused simulate step requires kernels=True "
                         "(it runs over the packed ring)")
    p = cfg.num_workers
    lo, hi = (0, p) if shard is None else (shard.lo, shard.hi)
    gather = (lambda x: x) if shard is None else shard.gather
    slots = cfg.buffer_slots
    source = cfg.delay.realize(num_workers=p)

    def draw(state: SimState, bound: Optional[int]) -> torch.Tensor:
        delays = source.delays(state.key, state.step, (p, p))
        if bound is not None:
            delays = torch.clamp(delays, max=int(bound))
        return delays

    def compensate(comp, updates, delays, step, packed_true_size=None):
        """Scale-then-sparsify each source worker's update: ``updates`` is
        the tree (tree layout) or the packed [P, D] view (packed layouts,
        with ``packed_true_size``)."""
        lr_metrics = {}
        if compensator.scales:
            out_delay = delays.float().mean(dim=1)                # [P]
            factor = compensator.lr_factor(comp, out_delay,
                                           step).expand(p)[lo:hi]
            if packed_true_size is not None:
                updates = updates * factor[:, None]
            else:
                updates = compensator.scale_tree(updates, factor)
            lr_metrics["lr_scale"] = factor
        if packed_true_size is not None:
            updates, comp, cmetrics = compensator.sparsify_packed(
                comp, updates, packed_true_size)
        else:
            updates, comp, cmetrics = compensator.sparsify_tree(
                comp, updates, lead_ndim=1)
        return updates, comp, {**cmetrics, **lr_metrics}

    def finish(new_state, comp, metrics):
        if compensator is not None:
            return new_state, comp, metrics
        return new_state, metrics

    def deliver_packed(state: SimState):
        """Caches plus the prefetched arrivals, through one stale_accum over
        the flattened packed caches view. Returns (caches tree, [P, D])."""
        pspec = tm.pack_spec(state.caches, lead_ndim=1)
        arrived = state.pending["arrived"]                       # [P, D]
        cvec = tm.tree_pack(state.caches, lead_ndim=1,
                            pad_to=dispatch.PACK_ALIGN)          # [P, D]
        flat = dispatch.stale_accum(
            cvec.reshape(-1), arrived.reshape(1, -1),
            torch.ones((1,), device=arrived.device))
        cflat = flat.reshape(hi - lo, -1)
        return tm.tree_unpack(cflat, pspec), cflat

    def finish_packed(state, caches, update_state, uvec, delays, metrics,
                      comp):
        if compensator is not None:
            uvec, comp, cmetrics = compensate(
                comp, uvec, delays, state.step,
                packed_true_size=tm.pack_spec(caches, lead_ndim=1).total)
            metrics = {**metrics, **cmetrics}
        ring = state.pending["ring"]
        arrived_next = _ring_dispatch(ring, gather(uvec.to(ring.dtype)),
                                      delays[:, lo:hi], state.step)
        new_state = SimState(
            caches=caches, pending={"ring": ring, "arrived": arrived_next},
            update_state=update_state, server_state=state.server_state,
            step=state.step + 1, key=state.key)
        return finish(new_state, comp, metrics)

    def packed_step(state: SimState, batches: Pytree,
                    bound: Optional[int] = None, comp: Pytree = None):
        caches, _ = deliver_packed(state)
        updates, update_state, metrics = update_fn(
            caches, state.update_state, batches, state.key)
        delays = draw(state, bound)
        uvec = tm.tree_pack(updates, lead_ndim=1, pad_to=dispatch.PACK_ALIGN)
        return finish_packed(state, caches, update_state, uvec, delays,
                             metrics, comp)

    def packed_fused_step(state: SimState, batches: Pytree,
                          bound: Optional[int] = None, comp: Pytree = None):
        caches, cflat = deliver_packed(state)
        args = (batches, state.key) if fused["takes_key"] else (batches,)
        losses, grads = value_and_grad(fused["loss"], caches, *args)
        gvec = tm.tree_pack(grads, lead_ndim=1,
                            pad_to=dispatch.PACK_ALIGN)          # [P, D]
        m, v = state.update_state["m"], state.update_state["v"]
        ostep = state.step + 1      # every worker steps once per iteration
        eta = lr_at(fused["lr"], ostep)
        dneg, m2, v2 = dispatch.fused_adam(
            torch.zeros((m.numel(),), device=m.device), m.reshape(-1),
            v.reshape(-1), gvec.reshape(-1), eta, fused["b1"], fused["b2"],
            fused["eps"], ostep)
        uvec = dneg.reshape(hi - lo, -1)                         # [P, D]
        wd = fused["weight_decay"]
        if wd:
            # Decoupled decay against the post-delivery cache each gradient
            # was computed at: the packed image of the per-leaf AdamW rule.
            uvec = uvec - eta * wd * cflat
        update_state = {"m": m2.reshape(hi - lo, -1),
                        "v": v2.reshape(hi - lo, -1)}
        delays = draw(state, bound)
        return finish_packed(state, caches, update_state, uvec, delays,
                             {"loss": losses}, comp)

    def step(state: SimState, batches: Pytree, bound: Optional[int] = None,
             comp: Pytree = None):
        if cfg.server_side:
            caches, pending, server_state = _deliver_server(
                state.caches, state.pending, state.server_state, server_apply)
        else:
            caches, pending = _deliver(state.caches, state.pending)
            server_state = state.server_state
        updates, update_state, metrics = update_fn(
            caches, state.update_state, batches, state.key)
        delays = draw(state, bound)
        if compensator is not None:
            updates, comp, cmetrics = compensate(comp, updates, delays,
                                                 state.step)
            metrics = {**metrics, **cmetrics}
        pending = _dispatch(pending, tm.tree_map(gather, updates), delays,
                            slots, lo)
        new_state = SimState(caches=caches, pending=pending,
                             update_state=update_state,
                             server_state=server_state,
                             step=state.step + 1, key=state.key)
        return finish(new_state, comp, metrics)

    if fused is not None:
        return packed_fused_step
    return packed_step if cfg.kernels else step


def drain(state: SimState, server_apply: Optional[ServerApply] = None,
          server_side: bool = False) -> SimState:
    """Deliver every in-flight update without generating new ones. After
    draining, every cache equals ``x0 + sum of all generated updates``.
    Handles both pending layouts; ``server_side`` delivers the tree layout
    through ``server_apply``."""
    if _is_packed(state):
        ring = state.pending["ring"]
        slots = ring.shape[1]
        pspec = tm.pack_spec(state.caches, lead_ndim=1)

        def add(caches, row):
            delivered = tm.tree_unpack(row, pspec)
            return tm.tree_map(lambda c, d: c + d.to(c.dtype), caches,
                               delivered)

        # The prefetched row IS ring slot (step mod B); the remaining
        # in-flight updates sit at the following B-1 cursor positions.
        caches = add(state.caches, state.pending["arrived"])
        for i in range(1, slots):
            caches = add(caches, ring[:, (state.step + i) % slots])
        return dataclasses.replace(
            state, caches=caches,
            pending={"ring": torch.zeros_like(ring),
                     "arrived": torch.zeros_like(state.pending["arrived"])})

    slots = tm.tree_leaves(state.pending)[0].shape[1]
    caches, pending, server_state = (state.caches, state.pending,
                                     state.server_state)
    for _ in range(slots):
        if server_side:
            caches, pending, server_state = _deliver_server(
                caches, pending, server_state, server_apply)
        else:
            caches, pending = _deliver(caches, pending)
    return dataclasses.replace(state, caches=caches, pending=pending,
                               server_state=server_state)


def draw_delay_matrix(gen: torch.Generator, delay: DelayModel,
                      p: int) -> torch.Tensor:
    """``r[src, dst]``, one delay a (source, destination) pair: the
    sampler's ``[p, p]`` draw (the step draws through
    ``delay.realize().delays(gen, step, (p, p))``, which for a sampler is
    this call)."""
    return delay.sample(gen, (p, p))


def sequential_reference(update_fn: UpdateFn, params: Pytree,
                         update_state: Pytree, batches_per_step,
                         keys=None) -> Pytree:
    """Plain sequential execution (the s=0, P=1 limit) for exactness
    tests: unstacked params and batches, one update per batch."""
    x, ust = params, update_state
    keys = keys if keys is not None else [None] * len(batches_per_step)
    for batch, key in zip(batches_per_step, keys):
        u, ust, _ = update_fn(x, ust, batch, key)
        x = tm.tree_add(x, u)
    return x


def effective_staleness_histogram(delay: DelayModel, gen: torch.Generator,
                                  p: int, steps: int) -> torch.Tensor:
    """Empirical distribution of the total delay (1 + r) over ``steps``
    draws of ``[p, p]``: a ``bincount`` of length ``delay.bound + 2``."""
    draws = torch.stack([delay.sample(gen, (p, p)) for _ in range(steps)])
    return torch.bincount((draws + 1).reshape(-1),
                          minlength=delay.bound + 2)
