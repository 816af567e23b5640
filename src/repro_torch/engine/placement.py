"""Engine state across the ranks of a ``DeviceMesh`` (the port's half of
``repro/engine/plan.py``'s placement, run rather than compiled).

The JAX package lets GSPMD insert the collectives; here they are explicit.
A :class:`MeshPlacement` describes one rank's share of an engine:

* **The worker axis over ``("pod", "data")``.** With P workers over N data
  ranks (P divisible by N), each rank owns the rows ``[lo, hi)`` of every
  ``[P, ...]`` buffer (caches, the pending ring, per-worker gradients, the
  compensation rows) as plain local tensors. A P that N does not divide
  replicates the worker axis, as the JAX planner does.
* **Collectives only where a worker's value crosses to another.**
  ``gather`` (an ``all_gather`` in rank order, which is worker order) feeds
  simulate's dispatch of every source into every destination and the
  per-worker rings' delayed aggregate, which then reduce in the one-process
  order, so those steps are bitwise the one-process steps. ``mean`` (an
  ``all_reduce``) averages the batch-split gradients of ``sync`` and the
  aggregate ring; that sum runs in another order than one backward over the
  whole batch, so it agrees to fp32 roundoff only.
* **The model axis.** Every param-shaped tensor is held as this rank's
  shard along the dims its spec puts on ``"model"`` (``torch.chunk``
  semantics, as DTensor's ``Shard``). A decoder-only transformer whose
  every model-sharded dim the extent divides computes tensor-parallel on
  those shards (``tensor_parallel_verdict``; the engine's loss installs
  :class:`ModelParallel`, whose ``copy`` and ``reduce`` are the layers'
  collectives; ``models/transformer.py``). Anywhere else the loss sees
  those dims whole: ``full`` gathers them with ``GatherShards`` (c10d's
  ``all_gather``; its backward hands each rank its chunk of the gradient,
  since every model rank computed it from the same batch). Either way
  each leaf's gradient is this rank's shard of the whole gradient. The
  optimizer's tree math and the packed kernels are elementwise, so they
  run on the shards (packed: this rank's leaves concatenated); norms add
  their squares over the groups that shard a leaf, and compression takes
  the top-k threshold and the sparsity of the whole packed row
  (``row_threshold``, ``row_sparsity``). ``public`` returns params as
  DTensors over the whole mesh.
* **The data axis of the FSDP archs** (``deepseek-67b``, ``kimi-k2``: the
  rules put ``embed`` on data). Params, optimizer state and the aggregate
  ring hold this rank's block of each leaf's ``embed`` dim. In the
  batch-split modes the model reads its params through ``fetch`` (an
  ambient hook, ``rules.use_fetch``), which gathers one layer (or
  ``embed``, ``head``, ``final_ln``) at a time and reduce-scatters its
  gradient in the backward pass; under remat a layer is gathered again
  there. The per-worker modes gather the params whole once a step outside
  autograd (``data_whole``), keep whole rows in their ring, and apply this
  rank's block of the delivered aggregate (``data_part``). simulate keeps
  no data shards: its caches spend the data axis on the worker dim.

No path calls ``DTensor.full_tensor()``: its functional collective
segfaults over gloo on CUDA tensors (torch 2.11), where c10d's
collectives run.

Index-heavy ring code (``_ring_dispatch``, ``_gather``) never runs as
DTensor ops: ``aten.index`` refuses a DTensor beside a plain index tensor.

A :class:`ServePlacement` is one rank's share of a serve (``serving/
server.py``): the params are stored as the serve plan's shards, every slot
lives on every rank, and rank 0 takes the host decisions every rank
applies. On a model axis where ``tensor_parallel_verdict`` holds the
server computes on the shards, as the engine's loss does (``ModelParallel``
over the model group); anywhere else it makes the model dims whole once a
load or refresh. An FSDP arch's data blocks stay blocks: prefill and
decode read them through ``ServePlacement.fetch``, which gathers one layer
(or ``embed``, ``head``, ``final_ln``) at a time as the model reads it, as
the batch-split training steps do, so no rank holds the served copy whole.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import treemath as tm
from repro_torch.sharding import rules as rules_lib

Pytree = Any

# ROADMAP items for what a mesh does not run yet.
FSDP_COMPRESS_ITEM = "A.20, compression over FSDP shards"
MULTINODE_ITEM = "A.19, multi-node"


def is_device_mesh(mesh) -> bool:
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def map_specs(fn, tree: Pytree, specs: list, shapes: list) -> Pytree:
    """``fn(leaf, spec, whole shape)`` over a params-shaped tree."""
    leaves, treedef = tm.tree_flatten(tree)
    if len(leaves) != len(specs):
        raise ValueError(f"params of {len(leaves)} leaves, specs of "
                         f"{len(specs)}")
    return tm.tree_unflatten(treedef, [
        fn(x, spec, shape) for x, spec, shape in zip(leaves, specs, shapes)])


# A part larger than this is gathered as flat pieces of this many bytes,
# all in flight at once: gloo stages each through pinned host memory and
# runs them on its worker threads (and its devices, ``GLOO_SOCKET_IFNAME``)
# side by side, ~1.3x the rate of one whole gather on one device and ~1.8x
# on two or four (PERF.md, PR 27).
GATHER_PIECE_BYTES = 1 << 26


def all_gather_dim(dist, x: torch.Tensor, d: int, full: int, n: int,
                   group) -> torch.Tensor:
    """Whole dim ``d`` (``full`` long) from each of the ``n`` ranks of
    ``group``'s ``torch.chunk`` part of it, by ``all_gather`` in group
    order (in flat pieces of GATHER_PIECE_BYTES, issued together). Parts
    are padded to the chunk size: the last may be short or empty."""
    c = -(-full // n)
    if x.shape[d] < c:
        pad = list(x.shape)
        pad[d] = c - x.shape[d]
        x = torch.cat([x, x.new_zeros(pad)], dim=d)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    flat, size = x.view(-1), max(1, GATHER_PIECE_BYTES // x.element_size())
    works = [dist.all_gather([p.view(-1)[lo:lo + size] for p in parts],
                             flat[lo:lo + size], group=group, async_op=True)
             for lo in range(0, flat.numel(), size)]
    for work in works:
        work.wait()
    out = torch.cat(parts, dim=d)
    return out if out.shape[d] == full else out.narrow(d, 0, full).contiguous()


def chunk_span(full: int, n: int, rank: int) -> tuple:
    """``(start, length)`` of part ``rank`` of ``n`` ``torch.chunk`` parts
    of a dim ``full`` long (the last may be short or empty)."""
    c = -(-full // n)
    start = min(rank * c, full)
    return start, min(c, full - start)


def leaf_dims(spec: tuple, shape: tuple, n: int, m: int) -> tuple:
    """``(data dim or None, model dim or None)`` of a leaf of ``shape``
    placed by ``spec`` on ``n`` data and ``m`` model ranks: a data dim only
    where ``n`` > 1 divides it (the even-division fallback keeps it whole),
    a model dim only where ``m`` > 1."""
    def dim_on(name):
        dims = [d for d, part in enumerate(spec)
                if name in rules_lib._names(part)]
        return dims[0] if dims else None
    dd = dim_on("data") if n > 1 else None
    if dd is not None and shape[dd] % n:
        dd = None
    return dd, dim_on("model") if m > 1 else None


def block(x: torch.Tensor, dims: tuple, data: tuple,
          model: Optional[tuple]) -> torch.Tensor:
    """This rank's block of a whole value ``x`` (a view): block ``rank`` of
    ``n`` of its data dim (``data = (n, rank)``) and ``torch.chunk``'s part
    ``rank`` of ``m`` of its model dim (``model = (m, rank)``, or None to
    keep it whole)."""
    dd, md = dims
    if dd is not None:
        c = x.shape[dd] // data[0]
        x = x.narrow(dd, data[1] * c, c)
    if md is not None and model is not None:
        x = x.narrow(md, *chunk_span(x.shape[md], *model))
    return x


def top_starts(params: Pytree) -> dict:
    """``{top-level key: index of its first leaf}`` in the leaf order."""
    starts, at = {}, 0
    if isinstance(params, dict):
        for key in sorted(params):
            starts[key] = at
            at += len(tm.tree_leaves(params[key]))
    return starts


def read_subtree(tree: Pytree, name: str, starts: dict, dims: list,
                 shapes: list, gather) -> Pytree:
    """A model's read of ``params[name]`` (one layer's slice of a stacked
    ``[L, ...]`` subtree, or a whole top-level leaf): each data-sharded
    leaf replaced by ``gather(x, d, full)``, its data dim ``d`` made
    ``full`` long; ``starts`` (``top_starts``), ``dims`` (``leaf_dims`` a
    leaf) and ``shapes`` (the whole leaves') place the subtree's leaves in
    the params' (the placements' ``fetch``)."""
    first = starts[name]
    leaves, treedef = tm.tree_flatten(tree)
    out = []
    for i, x in enumerate(leaves):
        dd = dims[first + i][0]
        shape = shapes[first + i]
        if dd is not None:
            cut = len(shape) - x.dim()       # 1 for a layer's slice
            x = gather(x, dd - cut, shape[dd])
        out.append(x)
    return tm.tree_unflatten(treedef, out)


def reduce_scatter_dim(dist, g: torch.Tensor, d: int, n: int,
                       group) -> torch.Tensor:
    """This rank's chunk of dim ``d`` of ``g`` summed over the ``n`` ranks
    of ``group``: one ``all_to_all_single`` hands each rank every rank's
    chunk of it (``n - 1`` chunks out and in), summed here in rank order.
    gloo runs c10d's ``reduce_scatter_tensor`` as an ``all_reduce`` of the
    whole tensor, which over two ranks moves twice those bytes through the
    host (PERF.md). ``n`` divides the dim. The sum stays in ``g``'s dtype:
    over two ranks it is one addition, so it rounds once, as a sum in fp32
    cast back would."""
    moved = g.movedim(d, 0).contiguous()
    parts = torch.empty_like(moved)
    dist.all_to_all_single(parts, moved, group=group)
    parts = parts.view((n, moved.shape[0] // n) + tuple(moved.shape[1:]))
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.movedim(0, d).contiguous()


class Axis:
    """One mesh axis as the collectives see it: its c10d group, extent and
    this rank's place on it. ``record`` (a list, or None) collects
    ``(kind, name, shape, bytes)`` of every gather and reduce-scatter the
    axis runs."""

    def __init__(self, dist, name: str, group, n: int, rank: int):
        self.dist, self.name, self.group = dist, name, group
        self.n, self.rank = n, rank
        self.record = None

    def note(self, kind: str, label: str, x: torch.Tensor) -> None:
        if self.record is not None:
            self.record.append((f"{self.name}.{kind}", label, tuple(x.shape),
                                x.numel() * x.element_size()))


class GatherShards(torch.autograd.Function):
    """Whole dim ``d`` (``full`` long) from each rank's ``torch.chunk``
    part over a mesh axis (``all_gather_dim``: c10d, not a DTensor
    collective). The backward returns this rank's part of the whole
    gradient: ``"slice"`` takes its chunk (every rank computed the same
    gradient: the model axis, whose ranks see one batch), ``"sum"``
    reduce-scatters it (each rank's gradient is of its own batch rows: the
    data axis of FSDP, where the step then divides by the extent)."""

    @staticmethod
    def forward(ctx, x, axis, d, full, backward, label):
        ctx.axis, ctx.d, ctx.full = axis, d, full
        ctx.backward, ctx.label = backward, label
        out = all_gather_dim(axis.dist, x, d, full, axis.n, axis.group)
        axis.note("gather", label, out)
        return out

    @staticmethod
    def backward(ctx, g):
        axis, d = ctx.axis, ctx.d
        if ctx.backward == "slice":
            start, length = chunk_span(ctx.full, axis.n, axis.rank)
            return (g.narrow(d, start, length).contiguous(),
                    None, None, None, None, None)
        axis.note("reduce_scatter", ctx.label, g)
        return (reduce_scatter_dim(axis.dist, g, d, axis.n, axis.group),
                None, None, None, None, None)


def _all_reduce_f32(axis, x: torch.Tensor, label: str) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, taken in fp32 (a bf16 part rounds
    once, in the cast back) on a fresh tensor."""
    out = x.float().contiguous()
    if out is x:
        out = out.clone()
    axis.note("all_reduce", label, out)
    axis.dist.all_reduce(out, group=axis.group)
    return out.to(x.dtype)


class CopyToModel(torch.autograd.Function):
    """The "copy": the identity forward, an all-reduce of the gradient over
    the model axis backward. It marks where a value every rank holds whole
    enters a rank-partial computation, whose gradient each rank then holds
    only its part of."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(ctx.axis, g, "copy"), None


class ReduceFromModel(torch.autograd.Function):
    """The "reduce": an all-reduce over the model axis forward, the
    identity backward. It closes a rank-partial product (a row-parallel
    matmul): every rank's output, and so the gradient coming back, is
    whole."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce_f32(axis, x, "reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelParallel:
    """The model axis as a tensor-parallel model sees it
    (``sharding.rules.use_model_parallel``): ``m`` ranks, this one at
    ``rank``; ``span(n)`` is this rank's ``(start, length)`` of a dim ``n``
    long (``chunk_span``, as the params are cut), and ``copy``, ``reduce``,
    ``gather`` (a dim whole, its backward this rank's chunk) and ``max``
    (detached) are its collectives over the model group."""

    def __init__(self, axis: Axis):
        self.axis, self.m, self.rank = axis, axis.n, axis.rank

    def span(self, n: int) -> tuple:
        return chunk_span(n, self.m, self.rank)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return ReduceFromModel.apply(x, self.axis)

    def gather(self, x: torch.Tensor, d: int, full: int,
               label: str) -> torch.Tensor:
        return GatherShards.apply(x, self.axis, d, full, "slice", label)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        out = x.detach().contiguous().clone()
        self.axis.dist.all_reduce(out, op=self.axis.dist.ReduceOp.MAX,
                                  group=self.axis.group)
        return out


def tensor_parallel_verdict(api, specs, m: int) -> tuple:
    """``(ok, why_not)``: whether a model axis of extent ``m`` computes
    tensor-parallel. It needs a decoder-only transformer (no cross layers;
    not whisper, mamba2 or zamba2) and, as the JAX planner's jit arguments
    do, every dim a spec puts on ``"model"`` divisible by ``m``; anywhere
    else the loss gathers the shards whole."""
    cfg = getattr(api, "cfg", None)
    if specs is None or api is None:
        return False, "a bare loss (no params specs)"
    if api.family != "transformer" or not getattr(cfg, "causal", False):
        return False, f"{api.family} family"
    if cfg.num_cross_layers:
        return False, "cross-attention layers"
    params, _ = api.init(0, device="meta")
    for x, spec in zip(tm.tree_leaves(params), rules_lib.axes_leaves(specs)):
        for d, part in enumerate(spec):
            if "model" in rules_lib._names(part) and x.shape[d] % m:
                return False, (f"a dim of {x.shape[d]} in a leaf of shape "
                               f"{tuple(x.shape)} does not divide by {m}")
    return True, ""


def model_compute(api, specs, m: int) -> tuple:
    """``(route, why)`` of a model axis of extent ``m`` > 1:
    ``("tensor-parallel", "")`` where ``tensor_parallel_verdict`` holds,
    else ``("gathered", why)`` (the engine's, the serve plan's and the
    serve placement's ``model_compute``)."""
    ok, why = tensor_parallel_verdict(api, specs, m)
    return ("tensor-parallel", "") if ok else ("gathered", why)


def whole_dtensor(x):
    """A DTensor's whole value by c10d's ``all_gather`` over each mesh dim
    that shards it (``DTensor.full_tensor()``'s functional collective
    segfaults over gloo on CUDA tensors with torch 2.11); anything else as
    it is."""
    if not hasattr(x, "to_local"):
        return x
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    mesh, out = x.device_mesh, x.to_local()
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            out = all_gather_dim(dist, out, pl.dim, x.shape[pl.dim],
                                 mesh.size(i), mesh.get_group(i))
    return out


class MeshPlacement:
    """One rank's share of a P-worker engine on a real ``DeviceMesh``.

    ``specs`` is the params' spec tree (``engine/plan.py::params_specs``:
    the rules' data and model parts), or None for a bare loss. The model
    parts shard every param-shaped tensor when the model extent is above 1;
    with ``fsdp`` (an FSDP arch over data > 1, outside simulate) the data
    parts shard params, optimizer state and the aggregate ring too, a leaf
    whose dim the data extent does not divide staying whole. ``rules``
    (those ``specs`` came from) place a leaf the initialiser draws by its
    logical axes (``keep``). The worker axis shards as the plan's
    (``rules.worker_split``)."""

    def __init__(self, mesh, num_workers: int, specs: Pytree = None,
                 fsdp: bool = False, rules: dict = None):
        import torch.distributed as dist
        names = tuple(mesh.mesh_dim_names)
        if "pod" in names:
            raise NotImplementedError(
                f"a 'pod' axis on a DeviceMesh (ROADMAP {MULTINODE_ITEM})")
        self.mesh = mesh
        self.dist = dist
        self.n = rules_lib.data_extent(mesh)
        self.m = rules_lib.model_extent(mesh)
        self.data_rank = mesh.get_local_rank("data") if "data" in names else 0
        self.data_group = mesh.get_group("data") if "data" in names else None
        self.model_mesh = mesh["model"] if "model" in names else None
        self.data_axis = (Axis(dist, "data", self.data_group, self.n,
                               self.data_rank) if self.n > 1 else None)
        self.model_axis = (Axis(dist, "model", self.model_mesh.get_group(),
                                self.m, mesh.get_local_rank("model"))
                           if self.m > 1 else None)
        self.p = num_workers
        # The worker axis shards only where N divides P; else every rank
        # holds (and computes) every worker, as the JAX planner replicates.
        split = rules_lib.worker_split(mesh, num_workers) is not None
        self.wn = self.n if split else 1
        per = num_workers // self.wn
        self.lo = self.data_rank * per if self.wn > 1 else 0
        self.hi = self.lo + per
        self.fsdp = bool(fsdp and specs is not None and self.n > 1)
        self.specs = specs
        self.rules = rules
        self.sharded = specs is not None and (self.fsdp or self.m > 1)
        self.full_shapes = None
        self._dims = None
        # The model parallel context of the tensor-parallel route (the
        # engine sets it), else None: the loss gathers whole params.
        self.model_parallel = None
        self._row = None

    # -- rows -----------------------------------------------------------------
    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def local_rows(self, x):
        """This rank's rows of a leading worker axis."""
        return x[self.lo:self.hi]

    def batch_rows(self, x, per_worker: bool = True):
        """This rank's rows of a global batch leaf: worker-contiguous row
        blocks (``per_worker``, the per-worker modes' ``[P, B/P]`` reshape)
        or one of N equal blocks (the batch-split modes), whole when N
        does not divide it."""
        if not torch.is_tensor(x) or x.dim() == 0:
            return x
        b = x.shape[0]
        if per_worker:
            if self.wn == 1:
                return x
            per = b // self.p
            return x[self.lo * per:self.hi * per]
        if self.n == 1 or b % self.n:
            return x
        per = b // self.n
        return x[self.data_rank * per:(self.data_rank + 1) * per]

    def splits_batch(self, batch) -> bool:
        b = tm.tree_leaves(batch)[0].shape[0]
        return self.n > 1 and b % self.n == 0

    # -- collectives ----------------------------------------------------------
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All P workers' rows from every rank's ``[rows, ...]`` (an
        ``all_gather`` over the data group, in rank = worker order)."""
        if self.wn == 1:
            return x
        return all_gather_dim(self.dist, x, 0, x.shape[0] * self.wn,
                              self.wn, self.data_group)

    def gather_tree(self, tree: Pytree) -> Pytree:
        return tm.tree_map(self.gather, tree)

    def mean(self, x: torch.Tensor, split: bool = True) -> torch.Tensor:
        """The mean over the data ranks of a batch-split value (an
        ``all_reduce`` sum, then / N); unchanged when the batch was not
        split."""
        if self.n == 1 or not split:
            return x
        out = x.detach().clone()
        self.dist.all_reduce(out, group=self.data_group)
        return out / self.n

    def mean_grads(self, grads: Pytree, split: bool = True) -> Pytree:
        """The batch-split modes' mean gradient from this rank's: a
        data-sharded leaf arrives summed over the data ranks by its
        gather's reduce-scatter (whether or not the batch was split: each
        rank's gradient of the whole batch sums to N of it) and is divided
        by N; every other leaf is ``mean``-ed."""
        if not self.fsdp:
            return tm.tree_map(lambda g: self.mean(g, split), grads)
        return self._map(lambda g, dims, _shape: g / self.n
                         if dims[0] is not None else self.mean(g, split),
                         grads)

    def broadcast_rows0(self, tree: Pytree) -> Pytree:
        """Worker 0's row of every ``[rows, ...]`` leaf, sent from the data
        rank that holds it (a collective: every rank calls it)."""
        def one(x):
            row = (x[0].clone() if self.data_rank == 0 or self.wn == 1
                   else torch.empty_like(x[0]))
            if self.wn > 1:
                src = self.dist.get_global_rank(self.data_group, 0)
                self.dist.broadcast(row, src=src, group=self.data_group)
            return row
        return tm.tree_map(one, tree)

    # -- params shards --------------------------------------------------------
    def set_full_shapes(self, params: Pytree) -> None:
        """Record the whole params' shapes and, per leaf, the dim each axis
        shards: ``(data dim or None, model dim or None)``."""
        self.full_shapes = [tuple(x.shape) for x in tm.tree_leaves(params)]
        if not self.sharded:
            return
        self._first = top_starts(params)
        specs = rules_lib.axes_leaves(self.specs)
        if len(specs) != len(self.full_shapes):
            raise ValueError(f"params of {len(self.full_shapes)} leaves, "
                             f"specs of {len(specs)}")
        self._dims = [self._leaf_dims(spec, shape)
                      for spec, shape in zip(specs, self.full_shapes)]

    def _leaf_dims(self, spec: tuple, shape: tuple) -> tuple:
        """``leaf_dims``: data only with ``fsdp``."""
        return leaf_dims(spec, shape, self.n if self.fsdp else 1, self.m)

    def _map(self, fn, tree: Pytree, lead: int = 0) -> Pytree:
        """``fn(leaf, (data dim, model dim), whole shape)`` over a
        params-shaped tree whose leaves carry ``lead`` leading dims (the
        dims count from the first param dim)."""
        leaves, treedef = tm.tree_flatten(tree)
        if len(leaves) != len(self._dims):
            raise ValueError(f"params of {len(leaves)} leaves, placement of "
                             f"{len(self._dims)}")
        return tm.tree_unflatten(treedef, [
            fn(x, tuple(None if d is None else d + lead for d in dims),
               shape) for x, dims, shape in zip(leaves, self._dims,
                                                self.full_shapes)])

    def _cut(self, x, dims):
        """This rank's block of a whole leaf ``x``: its block of the data
        dim and its ``torch.chunk`` part of the model dim (a view)."""
        return block(x, dims, (self.n, self.data_rank),
                     None if self.model_axis is None
                     else (self.m, self.model_axis.rank))

    def shard_params(self, params: Pytree) -> Pytree:
        """This rank's shards of whole params (no collective: every rank
        holds the same whole params). Leaves the initialiser already cut
        (``keep``) pass as they are."""
        if not self.sharded:
            return params

        def one(x, dims, shape):
            if tuple(x.shape) != tuple(shape):
                return x
            return self._cut(x, dims).contiguous()
        return self._map(one, params)

    def keep(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        """The initialiser's hook (``models.layers.use_keep``): this rank's
        block of a value just drawn whole, a leaf or one slice of a stacked
        leaf, whose trailing dims ``axes`` name; placed by ``rules`` as
        ``specs`` place the leaf. The block owns its storage, so the whole
        value can go."""
        lead = x.dim() - len(axes)
        dims = tuple(None if d is None else d + lead for d in self._leaf_dims(
            rules_lib.spec_for(axes, self.mesh, self.rules),
            tuple(x.shape[lead:])))
        out = self._cut(x, dims)
        return out.clone() if out.numel() < x.numel() else out

    def whole_like(self, params: Pytree) -> Pytree:
        """Meta tensors shaped as ``params``' shards with their data dims
        whole (the per-worker ring's rows: whole params on the data axis,
        which its worker rows occupy)."""
        def one(x, dims, shape):
            size = list(x.shape)
            if dims[0] is not None:
                size[dims[0]] = shape[dims[0]]
            return torch.empty(size, dtype=x.dtype, device="meta")
        return self._map(one, params)

    def data_whole(self, params: Pytree) -> Pytree:
        """Data-sharded leaves gathered whole on the data axis, outside
        autograd (the per-worker modes' params, once a step)."""
        if not self.fsdp:
            return params

        def one(x, dims, shape):
            if dims[0] is None:
                return x
            with torch.no_grad():
                out = all_gather_dim(self.dist, x.detach(), dims[0],
                                     shape[dims[0]], self.n,
                                     self.data_group)
            self.data_axis.note("gather", "whole", out)
            return out
        return self._map(one, params)

    def data_part(self, tree: Pytree) -> Pytree:
        """This rank's block of each data-sharded leaf of a tree that
        holds them whole (the per-worker modes' delivered aggregate)."""
        if not self.fsdp:
            return tree

        def one(x, dims, shape):
            if dims[0] is None:
                return x
            c = shape[dims[0]] // self.n
            return x.narrow(dims[0], self.data_rank * c, c).contiguous()
        return self._map(one, tree)

    def full(self, tree: Pytree, lead: int = 1) -> Pytree:
        """Model-sharded dims made whole, on leaves with ``lead`` leading
        (worker) dims, by a gather over the model group whose backward
        hands each rank its chunk of the gradient (``GatherShards``,
        "slice"). Data-sharded dims stay as they are: the batch-split modes
        gather them a layer at a time (``fetch``)."""
        if self.model_axis is None or not self.sharded:
            return tree

        def one(x, dims, shape):
            md = dims[1]
            if md is None:
                return x
            return GatherShards.apply(x, self.model_axis, md,
                                      shape[md - lead], "slice", "full")
        return self._map(one, tree, lead)

    def fetch(self, tree: Pytree, name: str) -> Pytree:
        """The model's read of ``params[name]`` (one layer's slice of a
        stacked ``[L, ...]`` subtree, or a whole top-level leaf) in a
        batch-split step: data-sharded leaves gathered whole on the data
        axis, their backward reduce-scattering the gradient
        (``GatherShards``, "sum"). Installed by the engine's loss
        (``rules.use_fetch``)."""
        return read_subtree(
            tree, name, self._first, self._dims, self.full_shapes,
            lambda x, d, full: GatherShards.apply(x, self.data_axis, d, full,
                                                  "sum", name))

    def public(self, params: Pytree) -> Pytree:
        """Params as the caller sees them: DTensors over the whole
        ``(data, model)`` mesh (each rank's shards of the global array, as
        JAX returns one) when anything is sharded, else this rank's plain
        tensors."""
        if not self.sharded:
            return params
        from torch.distributed.tensor import DTensor, Replicate, Shard
        names = tuple(self.mesh.mesh_dim_names)

        def one(x, dims, shape):
            on = dict(zip(("data", "model"), dims))
            placements = [Shard(on[a]) if on.get(a) is not None
                          else Replicate() for a in names]
            stride = torch.empty(shape, device="meta").stride()
            return DTensor.from_local(x, self.mesh, placements,
                                      run_check=False, shape=shape,
                                      stride=stride)
        return self._map(one, params)

    def sq_norm(self, tree: Pytree, data: bool = True) -> torch.Tensor:
        """Squared L2 norm of a params-shaped tree of shards: each leaf's
        squares add over the groups of the axes that shard it, replicated
        leaves count once. ``data=False``: the tree holds its data dims
        whole (the per-worker modes' aggregate)."""
        if not self.sharded:
            return tm.tree_sq_norm(tree)
        leaves = tm.tree_leaves(tree)
        # [model-only, model and data] over the model group, then
        # [data-only + the reduced both] over the data group.
        acc = torch.zeros((4,), device=leaves[0].device)
        for x, (dd, md) in zip(leaves, self._dims):
            on_data = dd is not None and data
            acc[2 * (md is None) + (not on_data)] += torch.sum(
                x.float() * x.float())
        # acc: [model+data, model, data, none]
        if self.model_axis is not None:
            both = acc[:2].clone()
            self.dist.all_reduce(both, group=self.model_axis.group)
            acc = torch.cat([both, acc[2:]])
        if self.data_axis is not None and self.fsdp and data:
            on_data = (acc[0] + acc[2]).reshape(1)
            self.dist.all_reduce(on_data, group=self.data_group)
            return on_data[0] + acc[1] + acc[3]
        return acc.sum()

    def norm(self, tree: Pytree, data: bool = True) -> torch.Tensor:
        return torch.sqrt(self.sq_norm(tree, data))

    def packed_norm(self, vec: torch.Tensor,
                    spec: tm.PackSpec) -> torch.Tensor:
        """L2 norm of the whole params-shaped row a packed ``[D]`` view of
        this rank's shards stands for."""
        if not self.sharded:
            return torch.sqrt(torch.sum(vec * vec))
        return self.norm(tm.tree_unpack(vec, spec, dtype=torch.float32))

    # -- the whole packed row (compression over the model axis) -------------
    @property
    def splits_rows(self) -> bool:
        """Whether a packed view of this rank's params is a part of one
        process's packed row (the model axis shards some leaf)."""
        return self.sharded and self.model_axis is not None

    def row(self) -> tm.ShardRow:
        """This rank's place in one process's packed row of the params:
        each leaf's model dim and this rank's chunk of it, the replicated
        leaves counted on model rank 0 alone."""
        if self._row is None:
            md = [dims[1] for dims in self._dims]
            spans = [None if d is None else chunk_span(
                shape[d], self.m, self.model_axis.rank)
                for d, shape in zip(md, self.full_shapes)]
            self._row = tm.ShardRow(self.full_shapes, md, spans,
                                    owns_whole=self.model_axis.rank == 0)
        return self._row

    def row_threshold(self, absacc: torch.Tensor, k: int) -> torch.Tensor:
        """The per-row top-k threshold of the whole packed row, bitwise the
        one-process ``compensate.topk_threshold(absacc_whole, k, total)``:
        up to ``EXACT_TOPK_MAX`` elements the k-th largest of the union of
        the ranks' local top-k (one all-gather); above, the same strided
        sample of the whole row, each rank filling the positions it owns
        and one all-reduce summing them."""
        from repro_torch.compensate import sparsify as sp
        row, axis = self.row(), self.model_axis
        n = row.total
        lead = tuple(absacc.shape[:-1])
        if n <= sp.EXACT_TOPK_MAX:
            kk = min(k, n)
            owned = row.owned(absacc)
            top = torch.topk(owned, min(kk, owned.shape[-1]), dim=-1).values
            if top.shape[-1] < kk:
                top = torch.cat([top, top.new_full(
                    lead + (kk - top.shape[-1],), -1.0)], dim=-1)
            parts = [torch.empty_like(top) for _ in range(axis.n)]
            axis.dist.all_gather(parts, top.contiguous(), group=axis.group)
            return torch.topk(torch.cat(parts, dim=-1), kk,
                              dim=-1).values[..., -1]
        stride = -(-n // sp.TOPK_SAMPLE)
        slots, local = row.sample(stride, absacc.device)
        ns = -(-n // stride)
        sample = absacc.new_zeros(lead + (ns,))
        sample[..., slots] = absacc[..., local]
        axis.dist.all_reduce(sample, group=axis.group)
        ks = max(1, round(k * ns / n))
        return torch.topk(sample, ks, dim=-1).values[..., -1]

    def row_sparsity(self, sent: torch.Tensor) -> torch.Tensor:
        """Realized zero fraction of a sent payload over the whole row's
        real entries (the nnz of each rank's owned elements, summed)."""
        row, axis = self.row(), self.model_axis
        rows = sent.numel() // sent.shape[-1] if sent.shape[-1] else 0
        nnz = row.owned_nnz(sent).reshape(1)
        axis.dist.all_reduce(nnz, group=axis.group)
        return 1.0 - nnz[0] / (rows * row.total)


class _Block(rules_lib.NamedSharding):
    """A ``NamedSharding`` whose placed leaf stays this rank's plain
    block (``ServePlacement.blocks``)."""

    def wrap(self, block: torch.Tensor, shape):
        return block.contiguous()


class ServePlacement:
    """One rank's share of a serve on a ``DeviceMesh`` that spans the
    process group, by the serve plan's params specs (``plan_serve_step``'s
    ``in_shardings[0]``: the model axis on the param dims, FSDP archs'
    ``embed`` on data).

    * ``shard(params)``: this rank's shards (``NamedSharding.place``, the
      form ``restore(shardings=)`` returns, reading only those blocks);
      ``blocks()``, the placements the server restores with, keeps each a
      plain tensor.
    * ``serve(shards)``: the params the server's steps read, once a load
      or refresh. An FSDP arch's data blocks stay this rank's blocks
      (``data_axis`` is then its data group; a leaf whose dim the extent
      does not divide is whole). The model axis: where it computes
      tensor-parallel (``model_compute``, ``tensor_parallel_verdict`` on
      ``api``) the shards stay shards, as local tensors, and
      ``model_parallel`` (a :class:`ModelParallel` over the model group) is
      the context the server runs its steps under. Anywhere else
      (``"gathered"``, ``model_compute_fallback`` the reason) each
      model-sharded dim is made whole by an ``all_gather`` over the model
      group (c10d's, not ``DTensor.full_tensor``, whose functional
      collective segfaults over gloo on CUDA tensors with torch 2.11;
      PERF.md); ``whole_gathers`` counts them. ``whole(shards)`` makes
      every dim whole.
    * ``fetch(tree, name)``: the model's read of ``params[name]`` in a
      step (one layer's slice of a stacked subtree, or a top-level leaf),
      its data blocks gathered whole over the data group, outside autograd,
      and dropped by the model after use. The server installs it
      (``rules.use_fetch``) where ``data_axis`` is set; ``data_axis.record``
      collects the gathers.
    * ``from_whole(params)``: ``serve`` of params every rank holds whole,
      with no collective; ``keep``, the initialiser's hook
      (``models.layers.use_keep``, placed by ``rules``), cuts each value to
      what ``serve`` keeps of it as it is drawn, so a rank that inits its
      own params never holds what it does not serve. ``sharded``: whether
      they cut anything.
    * ``decide(values)``: rank 0's host decisions (a list of numbers; None
      goes as NaN and comes back as None), broadcast to every rank, and
      ``all_ok(flag)``: whether every rank's flag holds. Any decision a
      rank took alone could differ between ranks, and a refresh would then
      call a collective on one rank and not on another."""

    def __init__(self, mesh, params_specs: Pytree, params_shapes: Pytree,
                 api=None, rules: Optional[dict] = None):
        import torch.distributed as dist
        self.dist = dist
        self.mesh = mesh
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"a serve mesh spans the process group: mesh of "
                             f"{mesh.size()} ranks, group of "
                             f"{dist.get_world_size()}")
        self.specs = rules_lib.axes_leaves(params_specs)
        self.shapes = [tuple(x.shape) for x in tm.tree_leaves(params_shapes)]
        self.treedef = tm.tree_structure(params_shapes)
        self.rules = rules
        self.lead = int(mesh.mesh.flatten()[0])
        self.is_lead = dist.get_rank() == self.lead
        # Host decisions travel as CPU tensors over gloo, on the card's
        # device over nccl.
        self.host = torch.device("cpu" if dist.get_backend() == "gloo"
                                 else mesh.device_type)
        self.whole_gathers = 0
        self.model_compute, self.model_compute_fallback = None, ""
        self.model_parallel = None
        self.n = rules_lib.data_extent(mesh)
        m = rules_lib.model_extent(mesh)
        if m > 1:
            self.model_compute, self.model_compute_fallback = model_compute(
                api, params_specs, m)
            if self.model_compute == "tensor-parallel":
                self.model_parallel = ModelParallel(Axis(
                    dist, "model", mesh["model"].get_group(), m,
                    mesh.get_local_rank("model")))
        self._dims = [leaf_dims(spec, shape, self.n, m)
                      for spec, shape in zip(self.specs, self.shapes)]
        self._starts = top_starts(params_shapes)
        self.data_axis = None
        if any(dd is not None for dd, _ in self._dims):
            self.data_axis = Axis(dist, "data", mesh.get_group("data"),
                                  self.n, mesh.get_local_rank("data"))
        self.sharded = (self.data_axis is not None
                        or self.model_parallel is not None)

    def shard(self, params: Pytree) -> Pytree:
        return map_specs(lambda x, spec, _shape: rules_lib.NamedSharding(
            self.mesh, spec).place(x), params, self.specs, self.shapes)

    def blocks(self) -> Pytree:
        """The server's own ``restore(shardings=)`` placements: each
        leaf's block as ``NamedSharding`` reads it, kept a plain tensor
        (``serve`` reads the blocks locally, so no leaf becomes a DTensor,
        whose first use imports ~12 s of modules in a fresh process)."""
        return tm.tree_unflatten(self.treedef, [
            _Block(self.mesh, spec) for spec in self.specs])

    def whole(self, shards: Pytree) -> Pytree:
        return map_specs(self._whole, shards, self.specs, self.shapes)

    def serve(self, shards: Pytree) -> Pytree:
        axes = () if self.model_parallel is not None else ("model",)
        return map_specs(lambda x, spec, shape: self._whole(
            x, spec, shape, axes=axes), shards, self.specs, self.shapes)

    def from_whole(self, params: Pytree) -> Pytree:
        if not self.sharded:
            return params
        leaves, treedef = tm.tree_flatten(params)
        return tm.tree_unflatten(treedef, [
            self._block(x, dims) for x, dims in zip(leaves, self._dims)])

    def keep(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        lead = x.dim() - len(axes)
        dims = leaf_dims(rules_lib.spec_for(axes, self.mesh, self.rules),
                         tuple(x.shape[lead:]), self.n,
                         rules_lib.model_extent(self.mesh))
        return self._block(x, tuple(None if d is None else d + lead
                                    for d in dims))

    def _block(self, x: torch.Tensor, dims: tuple) -> torch.Tensor:
        """What ``serve`` keeps of a whole value ``x``: its data block and,
        on the tensor-parallel route, its ``torch.chunk`` part of the model
        dim, owning its storage (``x`` itself where nothing is cut)."""
        mp = self.model_parallel
        out = block(x, dims, (self.n, 0 if self.data_axis is None
                              else self.data_axis.rank),
                    None if mp is None else (mp.m, mp.rank))
        return out.clone() if out.numel() < x.numel() else out

    def fetch(self, tree: Pytree, name: str) -> Pytree:
        def gather(x, d, full):
            with torch.no_grad():
                out = all_gather_dim(self.dist, x, d, full, self.n,
                                     self.data_axis.group)
            self.data_axis.note("gather", name, out)
            return out
        return read_subtree(tree, name, self._starts, self._dims,
                            self.shapes, gather)

    def _whole(self, x, spec, shape, axes=("model", "data")):
        local = x.to_local() if hasattr(x, "to_local") else x
        sizes = rules_lib.mesh_sizes(self.mesh)
        for name in axes:
            dims = [d for d, part in enumerate(spec)
                    if name in rules_lib._names(part)]
            n = sizes.get(name, 1)
            # ``place`` keeps a dim on data whole where the extent does not
            # divide it.
            if not dims or n == 1 or (name == "data" and shape[dims[0]] % n):
                continue
            local = all_gather_dim(self.dist, local, dims[0], shape[dims[0]],
                                   n, self.mesh.get_group(name))
            self.whole_gathers += name == "model"
        return local

    def decide(self, values: list) -> list:
        t = torch.tensor([float("nan") if v is None else float(v)
                          for v in values], dtype=torch.float64,
                         device=self.host)
        self.dist.broadcast(t, src=self.lead)
        return [None if v != v else v for v in t.tolist()]

    def all_ok(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int64, device=self.host)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MIN)
        return bool(t.item())
