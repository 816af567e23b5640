"""CUDA kernel: serve-decode attention read in place from the packed page
pool (``csrc/paged_attention.cu``), the port of
``repro/kernels/paged_attention.py``.

One query token per slot attends over its ring rows, read through the page
table straight out of ``pages [P+1, T, W]``, plus its just-projected K/V,
with the ring, null-page and sliding-window masks and GQA; fp32 online
softmax in a fixed order, so two calls on the same inputs are equal bit for
bit. Any head width up to 256 and any column offset run (no alignment
contract).

Split-KV: each (slot, kv head) is cut into ``n_split`` chunks of the rows
its slot holds, scored by separate blocks into a workspace, then merged in
split order by a second kernel (one launch counted per call).
:func:`choose_split` picks ``n_split`` from the shapes alone.

It computes the JAX oracle's function (``repro/kernels/ref.py``), which is
the gather -> decode route's: on a ring that has wrapped with no window at
or below its length, the cursor row's old token is dropped, which the
Pallas ``_kernel`` keeps (see the note in the CUDA source).

Dtypes: the wrapper casts q, k_new and v_new (bf16 at full width, fp32 in
the reduced configs; small operands) up to fp32 and the output back to
v_new's dtype; the pages are read as fp32, as the Pallas kernel reads them.
CPU tensors go to ``kernels/ref.py`` through ``kernels/dispatch.py``, never
through here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SMS = 132             # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 2     # the chooser's target
MIN_CHUNK_ROWS = 16   # fewest ring rows a chunk is given
MAX_GROUP = 8         # q heads a block (kMaxGroup in the CUDA source)


def choose_split(slots: int, heads: int, kv_heads: int, tokens: int) -> int:
    """Chunks per (slot, kv head): the count whose blocks come nearest to
    BLOCKS_PER_SM on each SM (all in one wave), but no chunk of a full ring
    under MIN_CHUNK_ROWS rows."""
    groups = -(-(heads // kv_heads) // MAX_GROUP)
    blocks = slots * kv_heads * groups
    want = (2 * BLOCKS_PER_SM * SMS + blocks) // (2 * blocks)   # rounded
    return max(1, min(want, -(-tokens // MIN_CHUNK_ROWS)))


def workspace_shape(slots: int, heads: int, kv_heads: int, head_dim: int,
                    n_split: int) -> tuple:
    """[S, Hkv, n_split, H/Hkv, hd + 2]: a chunk's (acc[hd], m, l) per q
    head."""
    return (slots, kv_heads, n_split, heads // kv_heads, head_dim + 2)


def paged_attention(q, k_new, v_new, pages, tables, pos, layer: int, *,
                    k_off: int, v_off: int, kv_heads: int, head_dim: int,
                    tokens: int, page_tokens: int, window: int = 0):
    """q [S,H,hd]; k_new/v_new [S,Hkv,hd]; pages [P+1,T,W] fp32 (page P is
    the null page); tables [S,PPS] and pos [S] int32; ``layer`` selects the
    column blocks at ``k_off + layer * Hkv*hd`` and ``v_off + ...``.
    Returns [S,H,hd] in v_new's dtype."""
    if q.dim() != 3:
        raise ValueError("paged_attention: q must be [S, H, hd]")
    s, h, hd = q.shape
    hkv = kv_heads
    if hd != head_dim or hkv < 1 or h % hkv:
        raise ValueError(f"paged_attention: H={h}, Hkv={hkv}, hd={hd} "
                         f"(head_dim={head_dim}) do not form GQA groups")
    if hd > 256:
        raise ValueError(f"paged_attention: head_dim={hd} > 256 (a lane "
                         "holds at most 8 elements of a row)")
    dev = pages.device
    if pages.dim() != 3:
        raise ValueError("paged_attention: pages must be [P+1, T, W]")
    n_pages, t, width = pages.shape
    if t != page_tokens:
        raise ValueError(f"paged_attention: pages hold {t} rows a page, "
                         f"page_tokens={page_tokens}")
    build.check_operand("paged_attention", "pages", pages, tuple(pages.shape),
                        dev)
    kvsz = hkv * hd
    k_col, v_col = k_off + layer * kvsz, v_off + layer * kvsz
    for name, col in (("k", k_col), ("v", v_col)):
        if col < 0 or col + kvsz > width:
            raise ValueError(f"paged_attention: {name} columns [{col}, "
                             f"{col + kvsz}) fall outside the row width "
                             f"{width}")
    pps = tables.shape[1]
    for name, t_, shape in (("tables", tables, (s, pps)), ("pos", pos, (s,))):
        if (t_.device != dev or t_.dtype != torch.int32
                or tuple(t_.shape) != shape or not t_.is_contiguous()):
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"int32 {shape} tensor on {dev}")
    qf = q.float().contiguous()
    knf = k_new.float().reshape(s, hkv, hd).contiguous()
    vnf = v_new.float().reshape(s, hkv, hd).contiguous()
    for name, x in (("q", qf), ("k_new", knf), ("v_new", vnf)):
        build.check_operand("paged_attention", name, x, tuple(x.shape), dev)
    n_split = choose_split(s, h, hkv, tokens)
    out = torch.empty((s, h, hd), device=dev)
    ws = torch.empty(workspace_shape(s, h, hkv, hd, n_split), device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_paged_attention_f32(
            out.data_ptr(), qf.data_ptr(), knf.data_ptr(), vnf.data_ptr(),
            pages.data_ptr(), tables.data_ptr(), pos.data_ptr(),
            ws.data_ptr(), s, h, hkv, hd, pps, page_tokens, width, k_col,
            v_col, tokens, window, n_pages - 1, n_split,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out.to(v_new.dtype)


paged_attention.launches = 0
