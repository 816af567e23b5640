"""Port parity: repro_torch.checkpoint against repro.checkpoint.

The port keeps the reference's on-disk format (``leaf_<i>`` arrays in the
JAX leaf order, ``jax.tree_util.keystr`` leaf names, a ``.meta.json``
commit marker written last), so each package restores the other's
snapshots bit for bit. Also the serving contract (atomic, meta-gated
publishes; pruning; a reader polling mid-publish sees old or new, never a
torn snapshot) and ``CheckpointHook``.
"""
from __future__ import annotations

import glob
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.models import mlp as jmlp
from repro_torch import treemath as tm
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import params_from_jax
from repro_torch.engine import (CheckpointHook, EngineConfig, Trainer,
                                build_engine)
from repro_torch.optim import sgd

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)


def _tree(k: float):
    return {"w": torch.full((64, 8), k), "b": torch.full((8,), k)}


def _trees():
    """(name, numpy tree): the MLP's params and a tree with every container
    kind and a few dtypes."""
    rng = np.random.default_rng(0)
    mlp = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0),
                                             jmlp.MLPConfig(12, 8, 2)))
    mixed = {"z": (rng.standard_normal(3).astype(np.float32),
                   [np.arange(4, dtype=np.int32)]),
             "a": {"k2": rng.standard_normal((2, 2)).astype(np.float32),
                   "k1": np.array(7, np.int64)},
             "m": [rng.standard_normal(5).astype(np.float32), None]}
    return [("mlp", mlp), ("mixed", mixed)]


def _torch_tree(tree):
    return params_from_jax(tree, "cpu")


def _equal_bitwise(a, b):
    la, lb = tm.tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name,tree", _trees())
def test_leaf_names_are_jax_keystr(name, tree):
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert ckpt._leaf_names(_torch_tree(tree))[0] == want


@pytest.mark.parametrize("name,tree", _trees())
def test_port_save_restores_in_jax(tmp_path, name, tree):
    path = ckpt.step_path(str(tmp_path), 4)
    ckpt.save(path, _torch_tree(tree), step=4, extra={"who": "port"})
    got, step, extra = jckpt.restore(path, like=tree)
    assert step == 4 and extra == {"who": "port"}
    _equal_bitwise(_torch_tree(tree), got)
    assert jckpt.latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("name,tree", _trees())
def test_jax_save_restores_in_port(tmp_path, name, tree):
    path = jckpt.step_path(str(tmp_path), 9)
    jtree = jax.tree.map(jnp.asarray, tree)   # int64 -> int32 without x64
    jckpt.save(path, jtree, step=9, extra={"who": "jax"})
    got, step, extra = ckpt.restore(path, like=_torch_tree(tree))
    assert step == 9 and extra == {"who": "jax"}
    _equal_bitwise(got, jtree)
    assert ckpt.latest_step(str(tmp_path)) == 9


def test_restore_structure_mismatch_and_shardings(tmp_path):
    path = ckpt.step_path(str(tmp_path), 1)
    ckpt.save(path, _tree(1.0), step=1)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(path, like={"w": torch.zeros(1)})
    # restore(shardings=) is ported (A.12): None leaves keep the whole
    # tensor; a placement on an abstract mesh has nowhere to go. The
    # two-rank placement is in test_torch_mesh_engine.py.
    got, _, _ = ckpt.restore(path, like=_tree(0.0),
                             shardings={"w": None, "b": None})
    _equal_bitwise(got, _tree(1.0))
    from repro_torch.sharding.rules import AbstractMesh, NamedSharding
    with pytest.raises(ValueError, match="abstract mesh"):
        ckpt.restore(path, like=_tree(0.0), shardings={
            "w": NamedSharding(AbstractMesh(("data",), (2,)), ("data",)),
            "b": None})
    with open(path[:-4] + ".meta.json") as f:
        assert json.load(f)["shardings"] == [None, None]


def test_latest_step_empty_and_missing(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.steps_in(str(tmp_path)) == []


def test_save_is_atomic_and_meta_gated(tmp_path):
    d = str(tmp_path)
    ckpt.save(ckpt.step_path(d, 3), _tree(3.0), step=3, extra={"tag": "x"})
    assert not glob.glob(os.path.join(d, "*.tmp-*"))
    assert os.path.exists(os.path.join(d, "step_3.npz"))
    assert os.path.exists(os.path.join(d, "step_3.meta.json"))
    assert ckpt.latest_step(d) == 3
    # A partial publish (npz without its meta commit marker) is invisible.
    with open(os.path.join(d, "step_9.npz"), "wb") as f:
        np.savez(f, leaf_0=np.zeros(3))
    assert ckpt.latest_step(d) == 3 and ckpt.steps_in(d) == [3]
    tree, step, extra = ckpt.restore(ckpt.step_path(d, 3), like=_tree(0.0))
    assert step == 3 and extra == {"tag": "x"}
    assert torch.equal(tree["w"], _tree(3.0)["w"])


def test_prune_keep_last(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        ckpt.save(ckpt.step_path(d, s), _tree(float(s)), step=s)
    assert ckpt.prune(d, keep_last=2) == [1, 2, 3]
    assert ckpt.steps_in(d) == [4, 5]
    tree, step, _ = ckpt.restore(ckpt.step_path(d, ckpt.latest_step(d)),
                                 like=_tree(0.0))
    assert step == 5 and float(tree["b"][0]) == 5.0
    with pytest.raises(ValueError):
        ckpt.prune(d, keep_last=0)


def test_checkpoint_hook_keep_last_restores_eval_params(tmp_path):
    """CheckpointHook prunes behind itself, and its last snapshot restores
    the engine's eval params bit for bit."""
    def quad(params, batch):
        x, y = batch
        pred = torch.einsum("...bd,...d->...b", x, params["w"])
        return ((pred - y) ** 2).mean(dim=-1)

    eng = build_engine(quad, sgd(0.1), EngineConfig(mode="sync",
                                                    num_workers=1),
                       device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 4)).astype(np.float32))
    d = str(tmp_path)
    res = Trainer(eng, hooks=[CheckpointHook(d, every=1, keep_last=2,
                                             extra={"run": 1})]).run(
        lambda: (x, x @ torch.arange(4.0)), 5,
        params={"w": torch.zeros(4)})
    assert ckpt.steps_in(d) == [4, 5]
    tree, step, extra = ckpt.restore(ckpt.step_path(d, 5),
                                     like={"w": torch.zeros(4)})
    assert step == 5 and extra == {"run": 1}
    assert torch.equal(tree["w"], eng.params(res.state)["w"])


def test_publisher_refresher_race(tmp_path):
    """Concurrent publish (with pruning) vs restore: every successful read
    is a UNIFORM snapshot, old or new, never a mix of two publishes."""
    d = str(tmp_path)
    ckpt.save(ckpt.step_path(d, 1), _tree(1.0), step=1)

    def publisher():
        for s in range(2, 41):
            ckpt.save(ckpt.step_path(d, s), _tree(float(s)), step=s)
            ckpt.prune(d, keep_last=3)

    t = threading.Thread(target=publisher)
    t.start()
    reads, torn = 0, []
    while t.is_alive() or reads < 5:
        step = ckpt.latest_step(d)
        if step is None:
            continue
        try:
            tree, got, _ = ckpt.restore(ckpt.step_path(d, step),
                                        like=_tree(0.0))
        except FileNotFoundError:
            continue  # pruned between poll and read: the documented race
        reads += 1
        vals = torch.cat([x.reshape(-1) for x in tm.tree_leaves(tree)])
        if not bool((vals == vals[0]).all()) or float(vals[0]) != got:
            torn.append((got, float(vals.min()), float(vals.max())))
    t.join(timeout=60)
    assert not t.is_alive()
    assert reads >= 5
    assert not torn, f"torn snapshots observed: {torn[:3]}"


def test_leaf_names_keep_no_leaf_alive(tmp_path):
    """Saving walks the tree without leaving a reference cycle: with the
    cyclic collector off, the saved params die with the caller's last
    reference."""
    import gc
    import weakref
    from repro_torch.checkpoint import checkpoint as tckpt
    gc.disable()
    try:
        tree = {"w": torch.ones(4), "layers": {"b": torch.zeros(2)}}
        refs = [weakref.ref(x) for x in (tree["w"], tree["layers"]["b"])]
        tckpt.save(str(tmp_path / "step_1"), tree, step=1)
        del tree
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("name,tree", _trees())
def test_restore_reads_stored_members_as_np_load(tmp_path, name, tree):
    """``restore`` reads a stored member straight from the file (one
    ``np.fromfile``, checked against the zip's CRC-32): bitwise
    ``np.load``'s leaves, a Fortran-ordered member too; a flipped data
    byte raises ``BadZipFile`` as ``np.load`` would, and so does a
    compressed member, which no snapshot holds."""
    import struct
    import zipfile
    path = ckpt.step_path(str(tmp_path), 2)
    ckpt.save(path, _torch_tree(tree), step=2)
    n = len(jax.tree.leaves(tree))
    with np.load(path) as npz:
        want = [npz[f"leaf_{i}"] for i in range(n)]
    got = ckpt._read_leaves(path, [None] * n)
    assert all(a.dtype == b.dtype and a.shape == b.shape == shape
               and a.tobytes() == b.tobytes()
               for (a, shape), b in zip(got, want))
    odd = str(tmp_path / "odd.npz")
    fort = np.asfortranarray(np.arange(12.0).reshape(3, 4))
    np.savez(odd, leaf_0=fort)
    (a, _), = ckpt._read_leaves(odd, [None])
    assert np.array_equal(a, fort)
    with zipfile.ZipFile(odd, "a", zipfile.ZIP_DEFLATED) as zf:
        with zf.open("leaf_1.npy", "w") as fp:
            np.lib.format.write_array(fp, np.arange(5, dtype=np.int32))
    with pytest.raises(zipfile.BadZipFile, match="compressed"):
        ckpt._read_leaves(odd, [None, None])
    raw = bytearray(open(path, "rb").read())
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(f"leaf_{n - 1}.npy")
    at = info.header_offset
    name_len, extra_len = struct.unpack("<HH", raw[at + 26:at + 30])
    raw[at + 30 + name_len + extra_len + info.file_size - 1] ^= 1  # last byte
    bad = str(tmp_path / "bad.npz")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        ckpt._read_leaves(bad, [None] * n)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        with np.load(bad) as npz:
            npz[f"leaf_{n - 1}"]


@pytest.mark.parametrize("order", ["C", "F"])
def test_restore_reads_a_block_of_a_member(tmp_path, order):
    """A placed leaf reads only its block (``NamedSharding.index``):
    bitwise that block of the whole array, for every dim sliced, empty
    blocks and C- and Fortran-ordered members."""
    x = np.arange(4 * 6 * 5, dtype=np.float32).reshape(4, 6, 5, order=order)
    blocks = [(slice(0, 4), slice(0, 6), slice(0, 5)),
              (slice(1, 3), slice(0, 6), slice(0, 5)),
              (slice(0, 4), slice(3, 6), slice(0, 5)),
              (slice(0, 4), slice(0, 6), slice(2, 4)),
              (slice(2, 4), slice(1, 2), slice(4, 5)),
              (slice(0, 4), slice(6, 6), slice(0, 5))]
    path = str(tmp_path / "blk.npz")
    np.savez(path, **{f"leaf_{i}": x for i in range(len(blocks))})
    got = ckpt._read_leaves(path, [lambda shape, b=b: b for b in blocks])
    for (a, shape), b in zip(got, blocks):
        assert shape == x.shape and a.dtype == x.dtype
        assert a.shape == x[b].shape and np.array_equal(a, x[b])
