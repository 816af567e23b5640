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
  semantics, as DTensor's ``Shard``). The loss sees whole params: ``full``
  wraps each shard as a DTensor on the model sub-mesh and gathers it with
  ``full_tensor()``, whose backward hands each rank the gradient of its own
  shard. The optimizer's tree math is elementwise, so it runs on the shards
  as DTensor propagation would; norms add their squares over the model
  group. ``public`` returns params as DTensors on the model sub-mesh.

Index-heavy ring code (``_ring_dispatch``, ``_gather``) never runs as
DTensor ops: ``aten.index`` refuses a DTensor beside a plain index tensor.

A :class:`ServePlacement` is one rank's share of a serve (``serving/
server.py``): the params are stored as the serve plan's shards and made
whole once a load or refresh, every slot lives on every rank, and rank 0
takes the host decisions every rank applies.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import treemath as tm
from repro_torch.sharding import rules as rules_lib

Pytree = Any

# ROADMAP items for what a mesh does not run yet.
FSDP_ITEM = "A.17, the FSDP archs on a mesh"
MODEL_ITEM = "A.18, the model axis on more than one card"
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


def all_gather_dim(dist, x: torch.Tensor, d: int, full: int, n: int,
                   group) -> torch.Tensor:
    """Whole dim ``d`` (``full`` long) from each of the ``n`` ranks of
    ``group``'s ``torch.chunk`` part of it, by one ``all_gather`` in group
    order. Parts are padded to the chunk size: the last may be short or
    empty."""
    c = -(-full // n)
    if x.shape[d] < c:
        pad = list(x.shape)
        pad[d] = c - x.shape[d]
        x = torch.cat([x, x.new_zeros(pad)], dim=d)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=d)
    return out if out.shape[d] == full else out.narrow(d, 0, full).contiguous()


class MeshPlacement:
    """One rank's share of a P-worker engine on a real ``DeviceMesh``.

    ``model_specs`` is the params tree of model-axis spec tuples that
    ``engine/plan.py::model_specs`` gives (the plan's param dims of a
    worker-stacked state), or None when the model extent is 1. The worker
    axis shards as the plan's (``rules.worker_split``)."""

    def __init__(self, mesh, num_workers: int, model_specs: Pytree = None):
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
        self.p = num_workers
        # The worker axis shards only where N divides P; else every rank
        # holds (and computes) every worker, as the JAX planner replicates.
        split = rules_lib.worker_split(mesh, num_workers) is not None
        self.wn = self.n if split else 1
        per = num_workers // self.wn
        self.lo = self.data_rank * per if self.wn > 1 else 0
        self.hi = self.lo + per
        self.model_specs = model_specs if self.m > 1 else None
        self.full_shapes = None

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

    # -- the model axis -------------------------------------------------------
    def _placements(self, spec, lead: int):
        return rules_lib.placements((None,) * lead + tuple(spec),
                                    self.model_mesh)

    def shard_params(self, params: Pytree) -> Pytree:
        """This rank's model-axis shards of whole params (the identity at
        model extent 1)."""
        if self.model_specs is None:
            return params
        from torch.distributed.tensor import distribute_tensor
        return self._map(lambda x, spec, _shape: distribute_tensor(
            x, self.model_mesh, self._placements(spec, 0),
            src_data_rank=None).to_local(), params)

    def _dtensor(self, x, spec, lead: int, shape):
        from torch.distributed.tensor import DTensor
        full_shape = tuple(x.shape[:lead]) + tuple(shape)
        stride = torch.empty(full_shape, device="meta").stride()
        return DTensor.from_local(x, self.model_mesh,
                                  self._placements(spec, lead),
                                  run_check=False, shape=full_shape,
                                  stride=stride)

    def full(self, tree: Pytree, lead: int = 1) -> Pytree:
        """Whole tensors from shards with ``lead`` leading (worker) dims, by
        an all-gather over the model group whose backward returns each
        rank its shard's gradient."""
        if self.model_specs is None:
            return tree
        return self._map(lambda x, spec, shape: self._dtensor(
            x, spec, lead, shape).full_tensor(), tree)

    def public(self, params: Pytree) -> Pytree:
        """Params as the caller sees them: DTensors on the model sub-mesh
        (model extent > 1), else this rank's plain tensors."""
        if self.model_specs is None:
            return params
        return self._map(lambda x, spec, shape: self._dtensor(
            x, spec, 0, shape), params)

    def sq_norm(self, tree: Pytree) -> torch.Tensor:
        """Squared L2 norm of a params-shaped tree of shards: sharded leaves
        add their squares over the model group, replicated ones count
        once."""
        if self.model_specs is None:
            return tm.tree_sq_norm(tree)
        leaves = tm.tree_leaves(tree)
        sharded = torch.zeros((), device=leaves[0].device)
        whole = torch.zeros_like(sharded)
        for x, spec in zip(leaves, rules_lib.axes_leaves(self.model_specs)):
            sq = torch.sum(x.float() * x.float())
            if any("model" in rules_lib._names(p) for p in spec):
                sharded = sharded + sq
            else:
                whole = whole + sq
        self.dist.all_reduce(sharded, group=self.model_mesh.get_group())
        return sharded + whole

    def norm(self, tree: Pytree) -> torch.Tensor:
        return torch.sqrt(self.sq_norm(tree))

    def set_full_shapes(self, params: Pytree) -> None:
        """Record the whole params' shapes (``full`` and ``public`` rebuild
        DTensors from shards)."""
        self.full_shapes = [tuple(x.shape) for x in tm.tree_leaves(params)]

    def _map(self, fn, tree: Pytree) -> Pytree:
        specs = rules_lib.axes_leaves(self.model_specs)
        return map_specs(fn, tree, specs,
                         self.full_shapes or [None] * len(specs))


class ServePlacement:
    """One rank's share of a serve on a ``DeviceMesh`` that spans the
    process group, by the serve plan's params specs (``plan_serve_step``'s
    ``in_shardings[0]``: the model axis on the param dims, FSDP archs'
    ``embed`` on data).

    * ``shard(params)``: this rank's shards (``NamedSharding.place``, the
      form ``restore(shardings=)`` returns, reading only those blocks).
    * ``whole(shards)``: whole params for the steps, by an ``all_gather``
      over each mesh axis a spec names (c10d's, not ``DTensor.full_tensor``,
      whose functional collective segfaults over gloo on CUDA tensors with
      torch 2.11; PERF.md). The server calls it once a load or
      refresh, so its decode and prefill steps call no collective; the cost
      is memory, since every rank holds the whole served copy beside its
      shards (tensor-parallel layers are A.18).
    * ``decide(values)``: rank 0's host decisions (a list of numbers; None
      goes as NaN and comes back as None), broadcast to every rank, and
      ``all_ok(flag)``: whether every rank's flag holds. Any decision a
      rank took alone could differ between ranks, and a refresh would then
      call the gather on one rank and not on another."""

    def __init__(self, mesh, params_specs: Pytree, params_shapes: Pytree):
        import torch.distributed as dist
        self.dist = dist
        self.mesh = mesh
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"a serve mesh spans the process group: mesh of "
                             f"{mesh.size()} ranks, group of "
                             f"{dist.get_world_size()}")
        self.specs = rules_lib.axes_leaves(params_specs)
        self.shapes = [tuple(x.shape) for x in tm.tree_leaves(params_shapes)]
        self.lead = int(mesh.mesh.flatten()[0])
        self.is_lead = dist.get_rank() == self.lead
        # Host decisions travel as CPU tensors over gloo, on the card's
        # device over nccl.
        self.host = torch.device("cpu" if dist.get_backend() == "gloo"
                                 else mesh.device_type)

    def shard(self, params: Pytree) -> Pytree:
        return map_specs(lambda x, spec, _shape: rules_lib.NamedSharding(
            self.mesh, spec).place(x), params, self.specs, self.shapes)

    def whole(self, shards: Pytree) -> Pytree:
        return map_specs(self._whole, shards, self.specs, self.shapes)

    def _whole(self, x, spec, shape):
        local = x.to_local() if hasattr(x, "to_local") else x
        sizes = rules_lib.mesh_sizes(self.mesh)
        for name in ("model", "data"):
            dims = [d for d, part in enumerate(spec)
                    if name in rules_lib._names(part)]
            n = sizes.get(name, 1)
            # ``place`` keeps a dim on data whole where the extent does not
            # divide it.
            if not dims or n == 1 or (name == "data" and shape[dims[0]] % n):
                continue
            local = all_gather_dim(self.dist, local, dims[0], shape[dims[0]],
                                   n, self.mesh.get_group(name))
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
