"""Logical-axis sharding rules -> partition specs over a device mesh (port of
``repro/sharding/rules.py``).

Params are built with logical axis names per dimension (``models/layers.py``:
``Param``); the rules map names to mesh axes. A spec here is a plain tuple
with one part per tensor dim: ``None``, a mesh-axis name, or a tuple of
names, exactly what ``tuple(jax.sharding.PartitionSpec(...))`` gives.
``placements`` turns a spec into ``torch.distributed.tensor`` placements.

Every function takes a real ``torch.distributed.device_mesh.DeviceMesh`` or
an :class:`AbstractMesh` (axis names and sizes only), so plans for the
production shapes (``16x16``, ``2x16x16``) build with no process group. A
duck-typed mesh with ``axis_names`` and ``devices.shape`` works too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

# Architectures whose params/optimizer also shard over the data axis (ZeRO /
# FSDP-style "embed" -> data): the configs too large to replicate.
FSDP_ARCHS = {"kimi-k2-1t-a32b", "deepseek-67b"}

# logical axis -> mesh axis (None = replicated). "batch" spans pod+data.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    "seq": None,
    "cache_seq": "model",       # seq-sharded KV cache (flash-decoding layout)
    "vocab": "model",
    "embed": None,              # switched to ("pod","data") by fsdp=True
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "head_dim_sharded": "model",  # contraction-mode wo
    "mlp": "model",
    "d_sharded": "model",       # contraction-mode qkv input dim
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
    "state": None,
    "conv": None,
    "replicated": None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh by axis names and sizes alone: enough to plan placements
    (``make_production_mesh``) without a process group or a device."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis_names {self.axis_names} and shape "
                             f"{self.shape} differ in length")


def mesh_sizes(mesh) -> dict:
    """``{axis name: extent}`` of a DeviceMesh, an AbstractMesh or a
    duck-typed mesh (``axis_names`` + ``devices.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # a DeviceMesh
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_sizes(mesh))


def rules_for(fsdp: bool = False, extra: Optional[dict] = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if fsdp:
        rules["embed"] = ("pod", "data")
    if extra:
        rules.update(extra)
    return rules


def data_extent(mesh) -> int:
    """Total data-parallel worker count (pods x data); 1 without a mesh."""
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def model_extent(mesh) -> int:
    return 1 if mesh is None else mesh_sizes(mesh).get("model", 1)


def _collapse(kept: tuple):
    return kept if len(kept) > 1 else (kept[0] if kept else None)


def worker_axes(mesh):
    """Mesh axes a leading worker dimension shards over: ("pod","data") kept
    as available, collapsed to a single name or None like spec_for does."""
    have = set(axis_names(mesh))
    return _collapse(tuple(a for a in ("pod", "data") if a in have))


def worker_split(mesh, num_workers: int):
    """The mesh axes a ``[P, ...]`` leading worker dim shards over
    (``worker_axes``), or None where the data extent does not divide P:
    the worker axis then replicates, as the JAX planner does."""
    wax = worker_axes(mesh)
    return None if wax is None or num_workers % data_extent(mesh) else wax


def is_fsdp(arch) -> bool:
    """Whether an arch (its registry entry, or the id it is registered
    under) takes the FSDP placement: the entry's ``fsdp`` flag, which
    ``FSDP_ARCHS`` lists for the registered archs."""
    if arch is None:
        return False
    if not isinstance(arch, str):
        return bool(getattr(arch, "fsdp", False))
    from repro_torch import configs
    entry = configs.REGISTRY.get(arch)
    return entry is not None and bool(entry.fsdp)


def rules_for_arch(arch, shape=None, mesh=None,
                   extra: Optional[dict] = None) -> dict:
    """The rule set for one (arch, shape, mesh), ``arch`` a registry entry
    or its id: FSDP placement where ``is_fsdp``, plus the even-division
    fallback (a global batch that the data extent does not divide,
    long_500k's batch of 1, replicates)."""
    rules = rules_for(fsdp=is_fsdp(arch), extra=extra)
    if shape is not None and mesh is not None:
        if shape.global_batch % data_extent(mesh):
            rules["batch"] = None
            rules["cache_batch"] = None
    return rules


def strip_data(rules: dict) -> dict:
    """Rules with pod/data targets removed (model-axis sharding only), for
    state whose leading worker dimension already occupies the data axis (a
    spec may not use a mesh axis twice)."""
    def clean(v):
        if isinstance(v, tuple):
            return _collapse(tuple(a for a in v if a not in ("pod", "data")))
        return None if v in ("pod", "data") else v
    return {k: clean(v) for k, v in rules.items()}


def spec_for(axes: Sequence[Optional[str]], mesh, rules: dict) -> tuple:
    """Logical axes tuple -> spec tuple, dropping mesh axes that do not
    exist on this mesh (e.g. 'pod' on the single-pod mesh)."""
    have = set(axis_names(mesh))
    parts = []
    for name in axes:
        target = None if name is None else rules.get(name, None)
        if target is None:
            parts.append(None)
        elif isinstance(target, tuple):
            parts.append(_collapse(tuple(t for t in target if t in have)))
        else:
            parts.append(target if target in have else None)
    return tuple(parts)


def is_axes_leaf(x) -> bool:
    """A logical-axes (or spec) leaf: a tuple of names, ``None``s and name
    tuples. The empty tuple is the leaf of a scalar."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None)))
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def map_axes(fn, tree: Any) -> Any:
    """Map ``fn`` over the axes leaves of a nested dict/list tree (the port's
    ``treemath`` would walk into the tuples)."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(map_axes(fn, v) for v in tree)
    return fn(tree)


def _collect_leaves(node, out: list) -> None:
    if is_axes_leaf(node) or not isinstance(node, (dict, list, tuple)):
        if node is not None:
            out.append(node)
    elif isinstance(node, dict):
        for k in sorted(node):
            _collect_leaves(node[k], out)
    else:
        for v in node:
            _collect_leaves(v, out)


def axes_leaves(tree: Any) -> list:
    """The axes (or spec, or placement) leaves of a tree in the JAX leaf
    order (sorted dict keys)."""
    out: list = []
    _collect_leaves(tree, out)
    return out


def tree_specs(axes_tree: Any, mesh, rules: Optional[dict] = None) -> Any:
    """Map a tree of logical-axes tuples to a tree of spec tuples."""
    rules = rules or DEFAULT_RULES
    return map_axes(lambda axes: spec_for(axes, mesh, rules), axes_tree)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def batch_spec(mesh) -> tuple:
    have = set(axis_names(mesh))
    return (_collapse(tuple(a for a in ("pod", "data") if a in have)),)


def _names(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of a spec on ``mesh``: ``Shard(d)`` on every mesh
    dim that names tensor dim ``d`` (a tuple part lists its mesh axes major
    to minor, as the mesh orders them), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, part in enumerate(spec) if name in _names(part)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} uses mesh axis {name!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX ``NamedSharding``). ``place`` puts a whole
    tensor where the spec says on a ``DeviceMesh``, by the engine's
    convention: dims on ``pod``/``data`` keep this rank's contiguous block
    as a plain tensor (whole where the extent does not divide them), and
    dims on ``model`` make a DTensor on the model sub-mesh when its extent
    is above 1."""
    mesh: Any
    spec: tuple

    def place(self, x: torch.Tensor):
        return self.wrap(x[self.index(x.shape)], tuple(x.shape))

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a whole tensor of ``shape``, a slice a
        dim (what ``place`` keeps; ``checkpoint.restore`` reads only it)."""
        return self._cut(shape)[0]

    def wrap(self, block: torch.Tensor, shape: Sequence[int]):
        """The placed tensor from this rank's ``block`` (``index(shape)``)
        of a whole tensor of ``shape``."""
        block = block.contiguous()
        if model_extent(self.mesh) == 1 or not any(
                "model" in _names(part) for part in self.spec):
            return block
        from torch.distributed.tensor import DTensor
        model = self.mesh["model"]
        held = self._cut(shape)[1]
        return DTensor.from_local(
            block, model, placements(self.spec, model), run_check=False,
            shape=held, stride=torch.empty(held, device="meta").stride())

    def _cut(self, shape: Sequence[int]):
        """(this rank's slices, the shape its model sub-mesh holds): the
        data axes' block of each dim they divide, then ``torch.chunk``'s
        part of it on ``model``, as ``distribute_tensor`` cuts."""
        if not hasattr(self.mesh, "mesh_dim_names"):
            raise ValueError("an abstract mesh places nothing; use a "
                             "DeviceMesh")
        sizes = mesh_sizes(self.mesh)
        index, held = [slice(None)] * len(shape), list(shape)
        for d, part in enumerate(self.spec):
            names = _names(part)
            lo, n = 0, shape[d]
            data = [a for a in ("pod", "data") if a in names]
            k = 1
            for a in data:
                k *= sizes[a]
            if k > 1 and n % k == 0:
                rank = 0
                for a in data:
                    rank = rank * sizes[a] + self.mesh.get_local_rank(a)
                n //= k
                lo = rank * n
            held[d] = n
            m = sizes.get("model", 1)
            if "model" in names and m > 1:
                c = -(-n // m)
                start = min(self.mesh.get_local_rank("model") * c, n)
                lo, n = lo + start, min(c, n - start)
            index[d] = slice(lo, lo + n)
        return tuple(index), tuple(held)


def named(spec_tree: Any, mesh) -> Any:
    """A tree of spec tuples (a plan's ``in_shardings``) -> a tree of
    :class:`NamedSharding` on ``mesh``."""
    return map_axes(lambda spec: NamedSharding(mesh, spec), spec_tree)


# -- the ambient mesh ---------------------------------------------------------

_AMBIENT: list = []


class use_mesh:
    """``with use_mesh(mesh):`` installs the mesh ``ambient_mesh()`` returns
    (the JAX package's ``with mesh:``); ``use_mesh(None)`` hides an outer
    one. Model code reads it without a mesh handle threaded through every
    layer (the MoE layer's dispatch groups)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _AMBIENT.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _AMBIENT.pop()
        return False


def ambient_mesh():
    """The mesh installed by ``use_mesh`` (None outside any context)."""
    return _AMBIENT[-1] if _AMBIENT else None


_FETCH: list = []


def _own(tree, name: str):
    return tree


class use_fetch:
    """``with use_fetch(fn):`` routes the model's reads of its params
    through ``fn(subtree, name)``, ``name`` the top-level key the subtree
    came from (one layer's slice of ``params["layers"]``, or ``embed``,
    ``head``, ``final_ln``): the FSDP placement's per-layer gather
    (``engine/placement.py::MeshPlacement.fetch``). ``use_fetch(None)``
    reads params as they are."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        _FETCH.append(self.fn)
        return self.fn

    def __exit__(self, *exc):
        _FETCH.pop()
        return False


def ambient_fetch():
    """The read ``use_fetch`` installed, else the identity. Model code
    takes it once a forward pass, so a layer recomputed in the backward
    pass (remat) reads through the same one."""
    return _FETCH[-1] if _FETCH and _FETCH[-1] is not None else _own


_MODEL_PARALLEL: list = []


class use_model_parallel:
    """``with use_model_parallel(mp):`` tells the model that its params are
    this rank's model-axis shards and that it computes on them
    tensor-parallel: ``mp`` (``engine/placement.py::ModelParallel``) holds
    the model group, this rank's index ``rank`` on it, its extent ``m``,
    the spans of each sharded dim and the two collectives (``copy``,
    ``reduce``). Installed by the engine's loss; ``use_model_parallel(None)``
    computes on whole params, as outside a mesh."""

    def __init__(self, mp):
        self.mp = mp

    def __enter__(self):
        _MODEL_PARALLEL.append(self.mp)
        return self.mp

    def __exit__(self, *exc):
        _MODEL_PARALLEL.pop()
        return False


def ambient_model_parallel():
    """The context ``use_model_parallel`` installed, or None (whole
    params). Model code takes it once a forward pass, as the fetch."""
    return _MODEL_PARALLEL[-1] if _MODEL_PARALLEL else None


def _redistribute(x, spec, keep=()):
    """Redistribute a DTensor to ``spec`` on its own mesh; mesh dims that
    now shard a tensor dim listed in ``keep`` stay as they are. A plain
    tensor is returned unchanged."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    target = placements(spec, x.device_mesh)
    for i, (cur, new) in enumerate(zip(x.placements, target)):
        if isinstance(cur, Shard) and cur.dim in keep and not isinstance(
                new, Shard):
            target[i] = cur
    return x.redistribute(x.device_mesh, target)


def constraint(x, mesh, *axes: Optional[str], rules: Optional[dict] = None):
    """Redistribute a DTensor to the spec of its logical ``axes``; a plain
    tensor (one rank's local rows, or a one-device run) is left alone."""
    rules = rules or DEFAULT_RULES
    return _redistribute(x, spec_for(axes, mesh, rules))


def ambient_constraint(x, *parts: Optional[str]):
    """``constraint`` against the ambient mesh with mesh-axis ``parts``
    (``"UNC"`` leaves a dim as it is); a no-op without an ambient mesh, for
    plain tensors, or when no named axis exists on the mesh."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    have = set(axis_names(mesh))

    def clean(p):
        if p == "UNC":
            return None
        if isinstance(p, tuple):
            return _collapse(tuple(a for a in p if a in have))
        return p if p in have else None

    cleaned = tuple(clean(p) for p in parts)
    if all(c is None for c in cleaned):
        return x
    return _redistribute(x, cleaned,
                         keep={d for d, p in enumerate(parts) if p == "UNC"})
