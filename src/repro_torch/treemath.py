"""Pytree arithmetic and packed flat views over nested dicts/lists of tensors.

A pytree here is a nested ``dict`` / ``list`` / ``tuple`` whose leaves are
tensors (or Python scalars, e.g. an optimizer's ``step`` count); ``None`` is
an empty subtree. The flattener visits dict keys in SORTED order, as
``jax.tree.flatten`` does (``torch.utils._pytree`` keeps insertion order).
That order fixes the packed layout, so the port's packed rings, moments and
caches compare element-wise with the JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Tuple

import torch

Pytree = Any


# -- flattening (JAX leaf order) ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Static structure of a pytree: ``kind`` is ``"leaf"``, ``"none"``,
    ``"dict"``, ``"list"`` or ``"tuple"``; ``keys`` are the sorted dict
    keys."""
    kind: str
    keys: Tuple = ()
    children: Tuple["TreeDef", ...] = ()


_LEAF = TreeDef("leaf")


def _flatten_into(node, leaves: List[Any]) -> TreeDef:
    # A module-level helper, not a closure: a nested function that calls
    # itself through its closure forms a reference cycle with the leaves
    # list, which then keeps every leaf (GBs at full width) alive until the
    # cyclic garbage collector happens to run.
    if node is None:
        return TreeDef("none")
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return TreeDef("dict", keys,
                       tuple(_flatten_into(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, (), tuple(_flatten_into(c, leaves) for c in node))
    leaves.append(node)
    return _LEAF


def tree_flatten(tree: Pytree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(td: TreeDef, it):
    # Module-level for the same reason as _flatten_into: a self-calling
    # closure would hold the leaf iterator, and so every leaf, in a cycle.
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    if td.kind == "dict":
        return {k: _build(c, it) for k, c in zip(td.keys, td.children)}
    kids = [_build(c, it) for c in td.children]
    return kids if td.kind == "list" else tuple(kids)


def tree_unflatten(treedef: TreeDef, leaves) -> Pytree:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Pytree) -> list:
    return tree_flatten(tree)[0]


def tree_structure(tree: Pytree) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rdef = tree_flatten(r)
        if rdef != treedef:
            raise ValueError("tree_map: trees have different structures")
        others.append(rl)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


# -- arithmetic ---------------------------------------------------------------

def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Pytree, c) -> Pytree:
    return tree_map(lambda x: x * c, a)


def tree_axpy(alpha, x: Pytree, y: Pytree) -> Pytree:
    """alpha * x + y, elementwise over matching pytrees."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, a)


def tree_dot(a: Pytree, b: Pytree) -> torch.Tensor:
    """Inner product over all leaves (fp32 accumulation)."""
    parts = tree_leaves(tree_map(
        lambda x, y: torch.sum(x.float() * y.float()), a, b))
    return functools.reduce(torch.add, parts, torch.tensor(0.0))


def tree_sq_norm(a: Pytree) -> torch.Tensor:
    return tree_dot(a, a)


def tree_norm(a: Pytree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def tree_size(a: Pytree) -> int:
    """Total number of elements."""
    return sum(x.numel() for x in tree_leaves(a))


def tree_cast(a: Pytree, dtype) -> Pytree:
    return tree_map(lambda x: x.to(dtype), a)


def tree_stack(trees: list) -> Pytree:
    """Stack a list of identical pytrees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_index(a: Pytree, i: int) -> Pytree:
    """Index the leading axis of every leaf."""
    return tree_map(lambda x: x[i], a)


def tree_broadcast_leading(a: Pytree, n: int) -> Pytree:
    """Tile every tensor leaf with a new leading axis of size n (a real
    copy, not an expanded view, so per-worker rows can diverge). Python
    scalar leaves, such as a shared step count, stay as they are."""
    def tile(x):
        if not torch.is_tensor(x):
            return x
        return x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()
    return tree_map(tile, a)


def tree_flatten_to_vector(a: Pytree) -> torch.Tensor:
    """Concatenate all leaves into one fp32 vector."""
    leaves = [x.float().reshape(-1) for x in tree_leaves(a)]
    return torch.cat(leaves) if leaves else torch.zeros((0,))


def tree_allfinite(a: Pytree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(a))


def tree_moveaxis(a: Pytree, axes, dst: int = 0, lead_ndim: int = 0) -> Pytree:
    """Per-leaf ``torch.movedim``: ``axes`` is a flat sequence (leaf order)
    of source axis indices, ``None`` leaving that leaf untouched. Both the
    source axes and ``dst`` are offset by ``lead_ndim``, so the same spec
    works on leaves that carry extra leading (slot/worker) axes. The serving
    plane rotates each decode-cache leaf token-major with it before
    packing."""
    leaves, treedef = tree_flatten(a)
    if len(leaves) != len(axes):
        raise ValueError(f"axes spec has {len(axes)} entries for "
                         f"{len(leaves)} leaves")
    moved = [x if ax is None else torch.movedim(x, ax + lead_ndim,
                                                dst + lead_ndim)
             for x, ax in zip(leaves, axes)]
    return tree_unflatten(treedef, moved)


# -- packed flat views (the kernel substrate) ---------------------------------
#
# The kernels work on contiguous [D] / [S, D] views, not pytrees. A PackSpec
# records how a tree's leaves lie in one flat vector, so the engine packs once
# per step, runs the kernel over the packed view and unpacks the result.

@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static layout of a pytree inside a flat [D] vector."""
    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf trailing shapes
    dtypes: tuple                         # per-leaf dtypes
    sizes: Tuple[int, ...]                # per-leaf element counts
    total: int                            # D = sum(sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)


def pack_spec(a: Pytree, lead_ndim: int = 0) -> PackSpec:
    """Layout of ``a``'s leaves (ignoring ``lead_ndim`` leading axes) in one
    flat vector."""
    leaves, treedef = tree_flatten(a)
    shapes = tuple(tuple(x.shape[lead_ndim:]) for x in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    return PackSpec(treedef=treedef, shapes=shapes,
                    dtypes=tuple(x.dtype for x in leaves),
                    sizes=sizes, total=sum(sizes))


def padded_size(total: int, pad_to: int) -> int:
    """D rounded up to a multiple of ``pad_to`` (the kernel block width)."""
    return total + (-total % pad_to) if pad_to and total else total


def tree_pack(a: Pytree, lead_ndim: int = 0, dtype=torch.float32,
              pad_to: int = 0) -> torch.Tensor:
    """Concatenate leaves into a contiguous [*lead, D] tensor.

    ``lead_ndim`` leading axes (e.g. a worker axis) are kept; trailing dims
    flatten into D. ``pad_to`` zero-pads D up to a multiple, and the pad
    tail is inert: zero gradients and moments stay zero, and unpack ignores
    it. Leaves are copied once into one allocation."""
    leaves = tree_leaves(a)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    lead = tuple(leaves[0].shape[:lead_ndim])
    sizes = [math.prod(x.shape[lead_ndim:]) for x in leaves]
    width = padded_size(sum(sizes), pad_to)
    out = torch.empty(lead + (width,), dtype=dtype, device=leaves[0].device)
    off = 0
    for x, size in zip(leaves, sizes):
        out[..., off:off + size] = x.reshape(lead + (size,))
        off += size
    out[..., off:].zero_()
    return out


def tree_unpack(vec: torch.Tensor, spec: PackSpec, dtype=None) -> Pytree:
    """Inverse of :func:`tree_pack`: split the last axis of ``vec`` per the
    spec and reshape each piece back to its leaf shape. Leading axes of
    ``vec`` carry onto every leaf. Pieces are views of ``vec`` where the
    dtype already matches. ``dtype`` overrides the per-leaf spec dtypes."""
    lead = tuple(vec.shape[:-1])
    pieces, off = [], 0
    for shape, size, leaf_dtype in zip(spec.shapes, spec.sizes, spec.dtypes):
        piece = vec[..., off:off + size].reshape(lead + shape)
        pieces.append(piece.to(dtype if dtype is not None else leaf_dtype))
        off += size
    return tree_unflatten(spec.treedef, pieces)


class ShardRow:
    """One rank's packed view of its shards as a part of one process's
    packed row of the whole tree.

    ``shapes`` are the whole leaves' shapes in leaf order; per leaf,
    ``dims`` names the dim this rank holds a chunk of (None: it holds the
    leaf whole, as every rank does) and ``spans`` that chunk's ``(start,
    length)``. The rank's packed view concatenates its chunks in the same
    leaf order, so an element's place in either row follows from the
    leaf's flat offset and the chunk (``locate``). A leaf every rank holds
    whole is counted by the rank with ``owns_whole`` alone, so summing the
    ranks' parts counts each element of the whole row once."""

    def __init__(self, shapes, dims, spans, owns_whole: bool):
        self.shapes = [tuple(s) for s in shapes]
        self.dims, self.spans = list(dims), list(spans)
        self.owns_whole = owns_whole
        self.local_shapes = []
        for shape, d, span in zip(self.shapes, self.dims, self.spans):
            local = list(shape)
            if d is not None:
                local[d] = span[1]
            self.local_shapes.append(tuple(local))
        self.sizes = [math.prod(s) for s in self.shapes]
        self.local_sizes = [math.prod(s) for s in self.local_shapes]
        self.offsets = _offsets(self.sizes)
        self.local_offsets = _offsets(self.local_sizes)
        self.total = sum(self.sizes)
        self.local_total = sum(self.local_sizes)
        self._samples = {}

    def _whole_leaves(self) -> list:
        """``(local offset, size)`` of the leaves held whole."""
        return [(off, size) for off, size, d in zip(
            self.local_offsets, self.local_sizes, self.dims) if d is None]

    def locate(self, positions):
        """Whole-row positions (a sorted int numpy array) -> ``(mine,
        local)``: which of them this rank counts and their indices in its
        packed view."""
        import numpy as np
        positions = np.asarray(positions, dtype=np.int64)
        mine = np.zeros(positions.shape, dtype=bool)
        local = np.zeros(positions.shape, dtype=np.int64)
        for shape, lshape, d, span, off, size, loff in zip(
                self.shapes, self.local_shapes, self.dims, self.spans,
                self.offsets, self.sizes, self.local_offsets):
            at = np.nonzero((positions >= off) & (positions < off + size))[0]
            if not at.size:
                continue
            within = positions[at] - off
            if d is None:
                if self.owns_whole:
                    mine[at], local[at] = True, loff + within
                continue
            coords = list(np.unravel_index(within, shape))
            keep = (coords[d] >= span[0]) & (coords[d] < span[0] + span[1])
            coords = [c[keep] for c in coords]
            coords[d] = coords[d] - span[0]
            mine[at[keep]] = True
            local[at[keep]] = loff + np.ravel_multi_index(coords, lshape)
        return mine, local

    def sample(self, stride: int, device) -> tuple:
        """The whole row's strided sample (positions ``0, stride, ...``)
        as ``(slots, local)`` index tensors on ``device``: the sample slots
        this rank fills and where it reads them in its packed view."""
        key = (stride, str(device))
        if key not in self._samples:
            import numpy as np
            pos = np.arange(0, self.total, stride)
            mine, local = self.locate(pos)
            self._samples[key] = (
                torch.as_tensor(np.nonzero(mine)[0], device=device),
                torch.as_tensor(local[mine], device=device))
        return self._samples[key]

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """``x[..., :local_total]`` (a packed ``[..., D]`` view of
        magnitudes) with the elements this rank does not count at -1."""
        x = x[..., :self.local_total]
        whole = self._whole_leaves()
        if self.owns_whole or not whole:
            return x
        x = x.clone()
        for off, size in whole:
            x[..., off:off + size] = -1.0
        return x

    def owned_nnz(self, x: torch.Tensor) -> torch.Tensor:
        """Nonzero elements this rank counts in a packed ``[..., D]`` view
        (an fp32 device scalar, as ``sparsity_of`` counts)."""
        nnz = (x != 0).float().sum()
        if not self.owns_whole:
            for off, size in self._whole_leaves():
                nnz = nnz - (x[..., off:off + size] != 0).float().sum()
        return nnz


def _offsets(sizes) -> list:
    out, off = [], 0
    for s in sizes:
        out.append(off)
        off += s
    return out
