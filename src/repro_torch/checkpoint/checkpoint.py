"""Pytree checkpointing on .npz (port of ``repro/checkpoint/checkpoint.py``).

The format is the JAX package's, so each package restores the other's
snapshots: leaves are stored as ``leaf_<i>`` in the JAX leaf order (sorted
dict keys) and named in the metadata with ``jax.tree_util.keystr``'s
spelling (``['layers'][0]['w']``); the metadata (step, names, shardings,
extra) rides in a JSON side file. ``shardings`` is written as a list of
``None``: the snapshot holds whole tensors, and ``restore(shardings=)``
places each leaf on a mesh.

Writes are ATOMIC: both files land via write-to-temp + ``os.replace``, and
the meta file is renamed LAST: it is the commit marker. A reader polling
``latest_step`` only ever sees fully written snapshots. ``prune`` removes
the meta first (un-announcing the step) and the .npz second, the exact
reverse, so the only race left is a reader holding a step that ``prune``
deletes under it; readers handle that as ``FileNotFoundError``.
"""
from __future__ import annotations

import json
import os
import struct
import zipfile
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import treemath as tm

Pytree = Any


def _walk_names(node, path: str, names: List[str], leaves: list) -> None:
    # Module-level, not a self-calling closure, so no reference cycle keeps
    # the leaves alive after the caller is done with them.
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_names(node[k], f"{path}[{k!r}]", names, leaves)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _walk_names(child, f"{path}[{i}]", names, leaves)
    else:
        names.append(path)
        leaves.append(node)


def _zip_places(like, shardings, out: list) -> None:
    """One placement per leaf of ``like``, in its leaf order: a placement
    (or None) at a node of ``shardings`` covers that node's whole
    subtree."""
    if shardings is None or hasattr(shardings, "place"):
        out.extend([shardings] * len(_leaf_names(like)[0]))
    elif isinstance(like, dict):
        for k in sorted(like):
            _zip_places(like[k], shardings[k], out)
    elif isinstance(like, (list, tuple)):
        for child, sh in zip(like, shardings):
            _zip_places(child, sh, out)
    else:
        raise ValueError(f"shardings node {shardings!r} is neither a "
                         "placement nor a subtree of the restored tree")


def _leaf_names(tree: Pytree):
    """(names, leaves) in the JAX leaf order, each name spelled as
    ``jax.tree_util.keystr`` spells its path."""
    names: List[str] = []
    leaves: list = []
    _walk_names(tree, "", names, leaves)
    return names, leaves


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save(path: str, tree: Pytree, step: int = 0,
         extra: Optional[dict] = None) -> None:
    names, leaves = _leaf_names(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    npz = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(npz)), exist_ok=True)
    # np.savez on a file OBJECT (a string would get ".npz" appended to the
    # temp name); temp files live in the target dir so os.replace never
    # crosses a filesystem boundary.
    tmp = npz + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, npz)
    meta = {"step": int(step), "names": names,
            "shardings": [None] * len(leaves), "extra": extra or {}}
    mtmp = _meta_path(path) + f".tmp-{os.getpid()}"
    with open(mtmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(mtmp, _meta_path(path))  # commit marker lands last


def restore(path: str, like: Pytree, shardings: Optional[Pytree] = None):
    """Restore into the structure of ``like``. Returns (tree, step, extra).
    Each leaf comes back as a tensor on the device of ``like``'s matching
    leaf (the CPU where that leaf is not a tensor), with the saved dtype and
    values bit for bit. ``shardings`` (a tree like ``like`` whose leaves are
    ``sharding.rules.NamedSharding`` or None) places each leaf as the
    plan does: this rank's rows of a worker axis as a plain tensor, a
    model-sharded dim as a DTensor on the model sub-mesh; only this rank's
    block of a placed leaf is read from the file."""
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    names, like_leaves = _leaf_names(like)
    if names != meta["names"]:
        raise ValueError(
            "checkpoint/model structure mismatch:\n"
            f" ckpt: {meta['names'][:5]}...\n tree: {names[:5]}...")
    places: list = [None] * len(names)
    if shardings is not None:
        places = []
        _zip_places(like, shardings, places)
    read = _read_leaves(_npz_path(path),
                        [None if s is None else s.index for s in places])
    leaves = []
    for (a, shape), l, s in zip(read, like_leaves, places):
        x = torch.from_numpy(a).to(l.device if torch.is_tensor(l) else "cpu")
        leaves.append(x if s is None else s.wrap(x, shape))
    return (tm.tree_unflatten(tm.tree_structure(like), leaves), meta["step"],
            meta["extra"])


def _read_leaves(npz: str, parts: list) -> List[Tuple[np.ndarray, tuple]]:
    """``(block, whole shape)`` of each leaf of a snapshot: the whole leaf
    where ``parts[i]`` is None, else the block ``parts[i](shape)`` indexes
    (a slice a dim)."""
    with zipfile.ZipFile(npz) as zf, open(npz, "rb") as f:
        return [_read_stored(f, zf.getinfo(f"leaf_{i}.npy"), part)
                for i, part in enumerate(parts)]


def _read_stored(f, info: zipfile.ZipInfo, part=None):
    """One stored ``.npy`` member, as ``np.savez`` writes it, read in place
    from the zip: the whole array with one ``np.fromfile``, checked against
    the zip's CRC-32 (about twice ``np.load``'s rate, which copies 256 KiB
    at a time), or only a block of it through a memory map, reading only
    its pages (a CRC covers the whole member, so a block is checked
    against the header and the member's size alone)."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise zipfile.BadZipFile(f"{info.filename}: compressed; a snapshot "
                                 "stores its members (np.savez)")
    f.seek(info.header_offset)
    local = f.read(30)
    if local[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{info.filename}: bad local header")
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    if f.read(name_len).decode() != info.orig_filename:
        raise zipfile.BadZipFile(f"{info.filename}: names in directory and "
                                 "header differ")
    start = info.header_offset + 30 + name_len + extra_len
    f.seek(start)
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    if dtype.hasobject:
        raise zipfile.BadZipFile(f"{info.filename}: an object array")
    head_len = f.tell() - start
    count = int(np.prod(shape))
    if head_len + count * dtype.itemsize != info.file_size:
        raise zipfile.BadZipFile(f"{info.filename}: size differs from the "
                                 "zip's")
    order = "F" if fortran else "C"
    index = None if part is None else part(shape)
    if count and index is not None and any(
            (s.start, s.stop) != (0, n) for s, n in zip(index, shape)):
        block = np.memmap(f, dtype=dtype, mode="r", offset=start + head_len,
                          shape=shape, order=order)[index]
        return np.ascontiguousarray(block), shape
    f.seek(start)
    crc = zlib.crc32(f.read(head_len))
    arr = np.fromfile(f, dtype=dtype, count=count)
    if zlib.crc32(arr, crc) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    return arr.reshape(shape, order=order), shape


def steps_in(ckpt_dir: str) -> List[int]:
    """COMMITTED snapshot steps in ``ckpt_dir``, ascending. A step counts
    only when both its .npz and its .meta.json exist (the meta file is
    written last), so an in-flight publish is invisible."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("step_") and f.endswith(".npz"):
            stem = f[len("step_"):-len(".npz")]
            if not stem.isdigit():
                continue
            if os.path.exists(_meta_path(os.path.join(ckpt_dir, f))):
                steps.append(int(stem))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = steps_in(ckpt_dir)
    return steps[-1] if steps else None


def prune(ckpt_dir: str, keep_last: int) -> List[int]:
    """Delete all but the newest ``keep_last`` committed snapshots. Removes
    each victim's meta FIRST and its .npz second, the reverse of the
    publish order. Returns the pruned steps."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    victims = steps_in(ckpt_dir)[:-keep_last]
    for step in victims:
        path = step_path(ckpt_dir, step)
        for p in (_meta_path(path), _npz_path(path)):
            try:
                os.remove(p)
            except FileNotFoundError:  # concurrent pruner: already gone
                pass
    return victims


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.npz")
