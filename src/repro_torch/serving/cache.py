"""Packed paged decode-cache: every slot's cache pages in ONE flat tensor
(port of ``repro/serving/cache.py``).

The serving plane holds one batch-1 model cache per slot, so requests at
different positions can share a decode step. Those caches live packed:

* Each cache leaf is rotated **token-major** (``treemath.tree_moveaxis``)
  and packed, so one ring row ``[W]`` holds everything the model keeps for
  one cache token of one slot. The token axis is *detected*: ``init_cache``
  is probed on the ``meta`` device at two sequence lengths (and two batch
  sizes, for the batch axis), and the axis that stretches is the token
  axis. Length-independent leaves ride in a per-slot "resident" row that is
  rewritten wholesale each step.
* Rows are grouped into pages of ``page_tokens`` rows, and all pages of all
  slots live in ONE fp32 ``[num_pages + 1, page_tokens, W]`` tensor (int
  leaves such as ``slot_pos`` ride in it as floats, exact below 2^24). A
  host-side page table maps (slot, page slot) -> page id, and a LIFO free
  list hands pages from an evicted request to the next admission.
* Index ``num_pages`` is the **null page**: evicted slots point there, and
  the decode step routes masked slots' writes there too, so a freed page can
  be re-allocated while the old slot is still in the batch mask.

Decode writes are cursor-addressed like the model's own ring cache: position
``p`` lives in row ``p % tokens``. The page tensor is updated IN PLACE by
the serve step's scatters and by admissions (the JAX package donates it to
its jitted step to the same effect).

On the tensor-parallel serve (``serving/server.py``) each rank builds its
layout from its own cache shapes, under the model-parallel context
(``models/transformer.py::rank_kv_heads``), so its pool holds only the kv
heads its q heads read: ``Hkv/m`` in head mode, the span of its groups in
mixed mode, all of them in contraction mode, where a rank attends on
whole heads. Page tables, positions, allocation and the null page are the
same on every rank. The JAX package replicates the pool, because GSPMD
plans it as one array; a rank-local pool is a placement of the same
cache, not another feature, and it spares an all-gather of every new k/v
row each step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.kernels import dispatch

Pytree = Any

# Probe lengths for token-axis detection: small enough that even a
# window-capped ring stretches between them (any window >= 3).
_PROBE_A, _PROBE_B = 2, 3


def _leaf_names(tree: Pytree) -> List[str]:
    """'/'-joined dict-key paths of the leaves, in leaf order."""
    names: List[str] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + [str(i)])
        else:
            names.append("/".join(path))

    walk(tree, [])
    return names


def _diff_axes(leaves_a, leaves_b, what: str) -> List[Optional[int]]:
    axes: List[Optional[int]] = []
    for xa, xb in zip(leaves_a, leaves_b):
        if xa.dim() != xb.dim():
            raise ValueError(f"cache leaf rank changed with {what}: "
                             f"{tuple(xa.shape)} vs {tuple(xb.shape)}")
        diff = [i for i, (m, n) in enumerate(zip(xa.shape, xb.shape))
                if m != n]
        if len(diff) > 1:
            raise ValueError(f"cache leaf has several {what}-dependent axes: "
                             f"{tuple(xa.shape)} vs {tuple(xb.shape)}")
        axes.append(diff[0] if diff else None)
    return axes


def _detect_token_axes(api):
    """(treedef, per-leaf token axis or None, per-leaf batch axis or None,
    per-leaf path name) of ``api.init_cache``'s leaves, found by probing on
    the ``meta`` device (nothing is allocated)."""
    a = api.init_cache(1, _PROBE_A, device="meta")[0]
    b = api.init_cache(1, _PROBE_B, device="meta")[0]
    b2 = api.init_cache(2, _PROBE_B, device="meta")[0]
    tok_axes = _diff_axes(tm.tree_leaves(a), tm.tree_leaves(b), "seq_len")
    batch_axes = _diff_axes(tm.tree_leaves(b), tm.tree_leaves(b2), "batch")
    return tm.tree_structure(a), tok_axes, batch_axes, _leaf_names(a)


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Static token-major packing layout of one arch's decode cache."""
    treedef: Any
    token_axes: Tuple[Optional[int], ...]   # per flattened leaf; None = resident
    batch_axes: Tuple[Optional[int], ...]   # per flattened leaf; None = shared
    tok_order: Tuple[int, ...]              # token-leaf pack order (see below)
    leaf_views: Tuple[Tuple[str, int, Tuple[int, ...]], ...]
    tok_spec: Optional[tm.PackSpec]         # over token-major leaves (lead [C])
    res_spec: tm.PackSpec                   # over length-independent leaves
    tokens: int                             # C: ring rows per slot (0 if none)
    page_tokens: int                        # T: rows per page
    pages_per_slot: int
    width: int                              # W: packed floats per token row
    res_width: int
    empty_rows: Optional[torch.Tensor]      # [C, W] packed init_cache rows
    empty_res: torch.Tensor                 # [res_width]

    # ``tok_order`` puts the big K/V column blocks FIRST in a packed row
    # (size-descending, then leaf order) and small leaves like ``slot_pos``
    # last, so each K/V block sits at a multiple of its own width.
    # ``leaf_views`` records, per token leaf in ORIGINAL leaf order, (path
    # name, column offset in the packed row, per-token shape): the in-place
    # addresses the paged kernel reads.

    @property
    def has_tokens(self) -> bool:
        return self.tokens > 0

    @property
    def padded_tokens(self) -> int:
        return self.pages_per_slot * self.page_tokens

    # -- pack / unpack (``lead`` extra leading axes, e.g. slots) -------------

    def pack_rows(self, cache: Pytree, lead: int = 0):
        """cache pytree -> (rows [*lead, C, W] or None, res [*lead, res_width])."""
        moved = tm.tree_moveaxis(cache, self.token_axes, 0, lead_ndim=lead)
        leaves = tm.tree_leaves(moved)
        tok = [x for x, ax in zip(leaves, self.token_axes) if ax is not None]
        tok = [tok[i] for i in self.tok_order]
        res = [x for x, ax in zip(leaves, self.token_axes) if ax is None]
        rows = tm.tree_pack(tok, lead_ndim=lead + 1) if tok else None
        if res:
            res_vec = tm.tree_pack(res, lead_ndim=lead)
        else:
            lead_shape = tuple(leaves[0].shape[:lead]) if leaves else ()
            res_vec = torch.zeros(lead_shape + (0,), device=(
                leaves[0].device if leaves else None))
        return rows, res_vec

    def unpack_slots(self, rows: Optional[torch.Tensor], res: torch.Tensor,
                     lead: int = 1) -> Pytree:
        """Inverse of :meth:`pack_rows`: rebuild the cache pytree."""
        tok_p = tm.tree_unpack(rows, self.tok_spec) if self.tok_spec else []
        tok = [None] * len(tok_p)
        for packed_i, orig_i in enumerate(self.tok_order):
            tok[orig_i] = tok_p[packed_i]
        res_it = iter(tm.tree_unpack(res, self.res_spec))
        tok_it = iter(tok)
        leaves = []
        for ax in self.token_axes:
            if ax is None:
                leaves.append(next(res_it))
            else:  # [*lead, C, *rest] -> token axis back in place
                leaves.append(torch.movedim(next(tok_it), lead, lead + ax))
        return tm.tree_unflatten(self.treedef, leaves)

    def unpack_resident(self, res: torch.Tensor) -> Pytree:
        """Resident leaves only -> the full cache structure with ``None`` in
        every token-leaf position (their data stays in the page pool; the
        paged decode path reads it through :class:`PagedKV`)."""
        res_it = iter(tm.tree_unpack(res, self.res_spec))
        leaves = [next(res_it) if ax is None else None
                  for ax in self.token_axes]
        return tm.tree_unflatten(self.treedef, leaves)

    def slice_batch(self, cache: Pytree, b: int) -> Pytree:
        """Batch row ``b`` of a batched prefill cache, keepdims (batch-
        independent leaves like ``slot_pos`` pass through shared)."""
        out = [x if ax is None else x.narrow(ax, b, 1)
               for x, ax in zip(tm.tree_leaves(cache), self.batch_axes)]
        return tm.tree_unflatten(self.treedef, out)

    # -- the two device-side page ops the serve step uses -------------------

    def gather(self, pages: torch.Tensor, resident: torch.Tensor,
               tables: torch.Tensor) -> Pytree:
        """Page-table gather -> slot-stacked cache pytree ([S, ...] leaves)."""
        rows = None
        if self.has_tokens:
            views = pages[tables.long()]                  # [S, PPS, T, W]
            rows = views.reshape(tables.shape[0], -1, self.width)
            rows = rows[:, : self.tokens]
        return self.unpack_slots(rows, resident, lead=1)

    def scatter_token(self, pages: torch.Tensor, resident: torch.Tensor,
                      caches: Pytree, tables: torch.Tensor, pos: torch.Tensor,
                      mask: torch.Tensor):
        """Write one decode step's cache updates back into the page tensor
        (in place). Cursor addressing: only the page holding ring row
        ``pos % tokens`` is written per slot. Masked slots are routed to the
        null page so their lanes cannot clobber re-allocated pages."""
        rows, res = self.pack_rows(caches, lead=1)       # [S, C, W], [S, Wr]
        if self.has_tokens:
            s = tables.shape[0]
            sidx = torch.arange(s, device=pages.device)
            pslot = (pos.long() % self.tokens) // self.page_tokens
            pad = self.padded_tokens - self.tokens
            if pad:
                rows = F.pad(rows, (0, 0, 0, pad))
            paged = rows.reshape(s, self.pages_per_slot, self.page_tokens,
                                 self.width)
            ids = torch.where(mask, tables.long()[sidx, pslot],
                              pages.shape[0] - 1)
            pages[ids] = paged[sidx, pslot]
        if self.res_width:
            resident = torch.where(mask[:, None], res, resident)
        return pages, resident

    def scatter_rows(self, pages: torch.Tensor, resident: torch.Tensor,
                     new_cache: Pytree, tables: torch.Tensor,
                     pos: torch.Tensor, mask: torch.Tensor):
        """Paged-route write-back (in place): ``new_cache`` carries ONE token
        per slot (token axes of extent 1), packed into one [S, W] row and
        written to ring row ``pos % tokens`` of each slot's page. Masked
        slots write to the null page."""
        rows, res = self.pack_rows(new_cache, lead=1)    # [S, 1, W], [S, Wr]
        if self.has_tokens:
            s = tables.shape[0]
            row = pos.long() % self.tokens
            sidx = torch.arange(s, device=pages.device)
            ids = torch.where(mask, tables.long()[sidx, row // self.page_tokens],
                              pages.shape[0] - 1)
            pages[ids, row % self.page_tokens] = rows[:, 0]
        if self.res_width:
            resident = torch.where(mask[:, None], res, resident)
        return pages, resident

    def paged_kv(self, pages: torch.Tensor, tables: torch.Tensor,
                 pos: torch.Tensor) -> "PagedKV":
        return PagedKV(pages=pages, tables=tables, pos=pos, layout=self)


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """Device view of the packed page pool handed to ``api.decode_paged``:
    ``attend`` routes one layer's decode attention through
    ``dispatch.paged_attention`` (the CUDA kernel, or its plain version on
    the CPU), reading the K/V column blocks in place at the
    ``layout.leaf_views`` offsets."""
    pages: torch.Tensor     # [num_pages + 1, T, W]
    tables: torch.Tensor    # [S, PPS] int32
    pos: torch.Tensor       # [S] int32 absolute decode positions
    layout: PageLayout

    def attend(self, layer: int, q, k_new, v_new, *, window: int = 0):
        """q [S,H,hd], k_new/v_new [S,Hkv,hd] (cache dtype) -> attention
        output [S,H,hd], over the ``k`` and ``v`` cache leaves. On a
        tensor-parallel rank H and Hkv are the rank's: its q heads and the
        kv heads its pool holds."""
        views = {n: (off, shape) for n, off, shape in self.layout.leaf_views}
        k_off, k_shape = views["k"]
        v_off, v_shape = views["v"]
        s, h, hd = q.shape
        hkv = k_shape[-2]
        layers = k_shape[0]
        if k_shape != v_shape:
            raise ValueError(f"k/v leaf shapes differ: {k_shape} vs {v_shape}")
        if math.prod(k_shape) != layers * hkv * hd:
            raise ValueError(
                f"k leaf {k_shape} is not [layers, 1.., Hkv, hd] per token")
        return dispatch.paged_attention(
            q, k_new, v_new, self.pages, self.tables, self.pos, layer,
            k_off=k_off, v_off=v_off, kv_heads=hkv, head_dim=hd,
            tokens=self.layout.tokens, page_tokens=self.layout.page_tokens,
            window=window)


def build_layout(api, max_seq: int, page_tokens: int = 8,
                 device=None) -> PageLayout:
    """Derive the packing layout (and the packed empty-cache template, on
    ``device``: CUDA unless ``device="cpu"``) for ``api``'s decode cache at
    capacity ``max_seq``.

    Every leaf rides in fp32 page rows, and an int32 value round-trips that
    cast exactly only below 2^24: checked here against the largest value an
    int leaf can hold (the vocab size or the position bound)."""
    dev = device_lib.resolve(device)
    treedef, axes, batch_axes, names = _detect_token_axes(api)
    template = api.init_cache(1, max_seq, device=dev)[0]
    t_def = tm.tree_structure(template)
    if t_def != treedef:
        raise ValueError(f"init_cache structure changed with seq_len: "
                         f"{t_def} vs {treedef}")

    int_bound = max(int(getattr(api, "vocab_real", 0) or 0), max_seq)
    for name, leaf in zip(names, tm.tree_leaves(template)):
        if not leaf.is_floating_point() and int_bound >= 1 << 24:
            raise ValueError(
                f"cache leaf '{name}' is {leaf.dtype} but values up to "
                f"{int_bound} do not survive the fp32 page packing "
                f"(exact only below 2^24 = {1 << 24})")

    leaves = tm.tree_leaves(tm.tree_moveaxis(template, axes, 0))
    tok = [x for x, ax in zip(leaves, axes) if ax is not None]
    tok_names = [n for n, ax in zip(names, axes) if ax is not None]
    res = [x for x, ax in zip(leaves, axes) if ax is None]
    c_sizes = {x.shape[0] for x in tok}
    if len(c_sizes) > 1:
        raise ValueError(f"token axes disagree on ring length: "
                         f"{sorted(c_sizes)}")
    tokens = c_sizes.pop() if c_sizes else 0
    page_tokens = max(1, min(page_tokens, tokens) if tokens else 1)

    per_tok = [math.prod(x.shape[1:]) for x in tok]
    tok_order = tuple(sorted(range(len(tok)), key=lambda i: (-per_tok[i], i)))
    tok_p = [tok[i] for i in tok_order]
    offsets, off = {}, 0
    for i in tok_order:
        offsets[i] = off
        off += per_tok[i]
    leaf_views = tuple((tok_names[i], offsets[i], tuple(tok[i].shape[1:]))
                       for i in range(len(tok)))

    tok_spec = tm.pack_spec(tok_p, lead_ndim=1) if tok else None
    res_spec = tm.pack_spec(res, lead_ndim=0)
    dispatch.note("serve_cache", "packed" if tok else "resident",
                  f"C={tokens} T={page_tokens} "
                  f"W={tok_spec.total if tok_spec else 0}")
    return PageLayout(
        treedef=treedef, token_axes=tuple(axes),
        batch_axes=tuple(batch_axes), tok_order=tok_order,
        leaf_views=leaf_views, tok_spec=tok_spec, res_spec=res_spec,
        tokens=tokens, page_tokens=page_tokens,
        pages_per_slot=math.ceil(tokens / page_tokens) if tokens else 0,
        width=tok_spec.total if tok_spec else 0,
        res_width=res_spec.total,
        empty_rows=tm.tree_pack(tok_p, lead_ndim=1) if tok else None,
        empty_res=(tm.tree_pack(res) if res
                   else torch.zeros((0,), device=dev)))


class PagedDecodeCache:
    """Host-side page accounting + the device tensors the serve step runs on.

    The device state is ``pages [num_pages + 1, T, W]`` (last index = null
    page) and ``resident [slots, res_width]``, both updated in place. Page
    tables and the free list are plain numpy/python: they change only on
    join/evict, between steps."""

    def __init__(self, layout: PageLayout, slots: int,
                 num_pages: Optional[int] = None, lazy: bool = False,
                 device=None):
        pps = layout.pages_per_slot
        self.layout, self.slots = layout, slots
        self.lazy = lazy
        self.num_pages = slots * pps if num_pages is None else num_pages
        if pps and not lazy and self.num_pages < pps:
            # The gather route reads every page slot of a ring (a null-page
            # row would alias position 0), so a slot needs its full page
            # complement. The paged route masks null-page rows in the kernel
            # and allocates lazily, which lets the pool sit far below
            # slots * pages_per_slot.
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold one slot ({pps} pages)")
        if pps and lazy and self.num_pages < 1:
            raise ValueError("lazy paging still needs at least one page")
        dev = layout.empty_res.device if device is None else torch.device(device)
        self.pages = torch.zeros(
            (self.num_pages + 1, layout.page_tokens, layout.width), device=dev)
        self.resident = layout.empty_res.to(dev)[None].repeat(slots, 1)
        self.tables = np.full((slots, max(pps, 1)), self.null_page, np.int32)
        self.free_list: List[int] = list(range(self.num_pages))

    @property
    def null_page(self) -> int:
        return self.num_pages

    @property
    def free_pages(self) -> int:
        return len(self.free_list)

    def can_alloc(self) -> bool:
        return len(self.free_list) >= self.layout.pages_per_slot

    def pages_needed(self, prompt_rows: int, new_tokens: int) -> List[int]:
        """Page slots a request will touch: ring rows [0, prompt_rows) plus
        the cursor rows ``p % C`` of each generated position. Under the
        paged route only these are allocated; the rest of the slot's table
        stays on the null page (masked in the kernel)."""
        lay = self.layout
        if not lay.has_tokens:
            return []
        c, t = lay.tokens, lay.page_tokens
        rows = set(range(min(prompt_rows, c)))
        for p in range(prompt_rows, prompt_rows + max(new_tokens, 0)):
            if len(rows) >= c:
                break
            rows.add(p % c)
        return sorted({r // t for r in rows})

    def alloc(self, slot: int,
              page_slots: Optional[Sequence[int]] = None) -> Sequence[int]:
        """Claim pages for ``slot`` from the free list (LIFO: the most
        recently evicted request's pages are reused first). ``page_slots``
        restricts allocation to those table positions (the lazy/paged
        route); the default is the full slot complement."""
        if (self.tables[slot] != self.null_page).any():
            raise ValueError(f"slot {slot} already holds pages")
        if page_slots is None:
            page_slots = range(self.layout.pages_per_slot)
        page_slots = list(page_slots)
        if len(self.free_list) < len(page_slots):
            raise ValueError(f"page pool exhausted "
                             f"({len(self.free_list)} < {len(page_slots)})")
        got = [self.free_list.pop() for _ in page_slots]
        if got:
            self.tables[slot, page_slots] = np.asarray(got, np.int32)
        return got

    def free(self, slot: int) -> Sequence[int]:
        """Return ``slot``'s pages to the free list; its table row now points
        at the null page, so in-flight masked writes land harmlessly."""
        got = [int(p) for p in self.tables[slot] if p != self.null_page]
        self.free_list.extend(got)
        self.tables[slot] = self.null_page
        return got

    def write_rows(self, slot: int, rows: Optional[torch.Tensor],
                   res: torch.Tensor) -> None:
        """Write a full slot image (the admission path): the slot's
        allocated pages (table entries on the null page are skipped), plus
        its resident row."""
        lay = self.layout
        if lay.has_tokens:
            pad = lay.padded_tokens - rows.shape[0]
            if pad:
                rows = F.pad(rows, (0, 0, 0, pad))
            paged = rows.reshape(lay.pages_per_slot, lay.page_tokens, lay.width)
            held = np.nonzero(self.tables[slot] != self.null_page)[0]
            dev = self.pages.device
            self.pages[torch.as_tensor(self.tables[slot, held],
                                       device=dev).long()] = \
                paged[torch.as_tensor(held, device=dev)]
        if lay.res_width:
            self.resident[slot] = res

    def table_device(self) -> torch.Tensor:
        return torch.as_tensor(self.tables, device=self.pages.device)
