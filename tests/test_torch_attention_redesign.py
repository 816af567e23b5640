"""The algorithms of the two redesigned attention kernels, emulated on the CPU
and held against the JAX package.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). What they compute is emulated here in fp32 torch, step by
step as the kernels order it, on the same numpy-seeded inputs the JAX side
gets:

(a) ``flash_attention``'s bf16 tensor-core path
    (``csrc/flash_attention.cu``, ``flash_mma_kernel``): 64-key tiles, an
    online softmax per tile, and P fed to the P.V product as a bf16 pair
    hi = bf16(p), lo = bf16(p - hi) against bf16 V with fp32 accumulation.
    Held against the JAX oracle (``repro.kernels.ref.flash_attention``) and
    the Pallas kernel in interpret mode within one bf16 rounding of the
    output (rtol 2^-7, atol 1e-5: chip_smoke.py's TOL_FLASH_BF16). The same
    loop with P rounded once to bf16 (hi alone) is shown to leave that
    tolerance, which is why the kernel carries lo.
(b) ``paged_attention``'s split-KV design (``csrc/paged_attention.cu``):
    each (slot, kv head) cut into n_split chunks of its rows
    [0, min(pos, tokens)), a partial (acc, m, l) per chunk, and the merge in
    split order starting from the new token, eight chunks at a time. Held
    against the JAX oracle (``repro.kernels.ref.paged_attention``) at fp32
    tolerance (1e-5, as tests/test_torch_paged_attention.py holds the plain
    version).
(c) The wrapper's split-count chooser and the workspace shape it implies.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfl
from repro.kernels import ref as jref
from repro_torch.kernels import paged_attention as tpa

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

# One bf16 rounding of the output (chip_smoke.py's TOL_FLASH_BF16).
TOL_FLASH_BF16 = dict(rtol=2 ** -7, atol=1e-5)
TOL_PAGED = 1e-5
BLOCK_K = 64          # flash_mma_kernel's key tile (hd <= 128)
MERGE_BATCH = 8       # chunks whose loads the merge kernel keeps in flight

# The JAX oracles compiled whole, once a case: run op by op, each of their
# ops would be compiled on its own for every new shape, five times slower.
flash_oracle = jax.jit(jref.flash_attention,
                       static_argnames=("causal", "window"))
paged_oracle = jax.jit(jref.paged_attention, static_argnames=(
    "k_off", "v_off", "kv_heads", "head_dim", "tokens", "page_tokens",
    "window"))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_flash_bf16(q, k, v, causal: bool, window: int,
                       hi_lo: bool = True) -> torch.Tensor:
    """flash_mma_kernel's arithmetic: q [B,Sq,H,hd], k/v [B,Sk,Hkv,hd]
    (bf16) -> [B,Sq,H,hd] bf16. Scores are fp32 sums of exact bf16
    products; per 64-key tile the row max, the rescale alpha, the
    probabilities and l follow the kernel; P.V takes hi and lo (or hi
    alone) against bf16 V with fp32 sums."""
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qf = q.float().reshape(b, sq, hkv, g, hd)
    kf, vf = k.float(), v.float()
    pos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, hkv, g, sq), -1e30)
    l = torch.zeros((b, hkv, g, sq))
    acc = torch.zeros((b, hkv, g, sq, hd))
    for k0 in range(0, sk, BLOCK_K):
        kt, vt = kf[:, k0:k0 + BLOCK_K], vf[:, k0:k0 + BLOCK_K]
        s = torch.einsum("bsngd,bknd->bngsk", qf, kt) * scale
        key = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = torch.ones((sq, kt.shape[1]), dtype=torch.bool)
        if causal or window:
            ok = key <= pos
        if window:
            ok = ok & (key > pos - window)
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = _bf16(p)
        pv = torch.einsum("bngsk,bknd->bngsd", hi, vt)
        if hi_lo:
            pv = pv + torch.einsum("bngsk,bknd->bngsd", _bf16(p - hi), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(torch.bfloat16)


# (B, Sq, Sk, H, Hkv, hd, causal, window): Sq and Sk off the 64-key tile,
# one query over 2,085 keys, a window that bites, bidirectional, hd 80
# (danube) and 128, GQA groups of 1, 2 and 4.
FLASH_CASES = [
    (2, 100, 130, 4, 2, 80, True, 0),
    (1, 1, 2085, 4, 1, 80, True, 0),
    (1, 77, 77, 2, 2, 128, True, 0),
    (2, 90, 150, 4, 2, 128, True, 40),
    (1, 70, 70, 4, 1, 80, False, 0),
    (1, 65, 191, 8, 2, 64, True, 100),
]


def _flash_inputs(b, sq, sk, h, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, sq, h, hd), f(b, sk, hkv, hd), f(b, sk, hkv, hd)


def _close(got, want, rtol, atol) -> bool:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal,window", FLASH_CASES)
def test_flash_tiles_with_hi_lo_p_match_oracle_and_pallas(b, sq, sk, h, hkv,
                                                          hd, causal, window):
    arrays = _flash_inputs(b, sq, sk, h, hkv, hd, seed=sq + sk + hd)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    got = emulate_flash_bf16(q, k, v, causal, window)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    oracle = np.asarray(flash_oracle(jq, jk, jv, causal=causal,
                                     window=window), np.float32)
    assert _close(got, oracle, **TOL_FLASH_BF16)
    pallas = np.asarray(jfl.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=32, block_k=64,
        interpret=True), np.float32)
    assert _close(got, pallas, **TOL_FLASH_BF16)


def test_flash_tiles_with_p_rounded_once_leave_the_tolerance():
    """P rounded to bf16 alone (one product against V) moves outputs near
    zero by more than one output rounding: the lo part is needed to
    compute the TPU kernel's fp32 function."""
    b, sq, sk, h, hkv, hd, causal, window = FLASH_CASES[0]
    arrays = _flash_inputs(b, sq, sk, h, hkv, hd, seed=sq + sk + hd)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    oracle = np.asarray(flash_oracle(jq, jk, jv, causal=causal,
                                     window=window), np.float32)
    hi_only = emulate_flash_bf16(q, k, v, causal, window, hi_lo=False)
    assert not _close(hi_only.float().numpy(), oracle, **TOL_FLASH_BF16)


def _row_counts(r: int, p: int, tokens: int, window: int) -> bool:
    """The kernel's ring mask: row r of a slot at position p holds position
    p - 1 - ((p - 1 - r) mod tokens); the cursor row p mod tokens is the
    new token's."""
    if r >= tokens:
        return False
    md = (p - 1 - r) % tokens
    spos = p - 1 - md
    return spos >= 0 and md != tokens - 1 and (window <= 0
                                                or spos > p - window)


def emulate_paged_split(q, k_new, v_new, pages, tables, pos, layer, *, k_off,
                        v_off, kv_heads, head_dim, tokens, page_tokens,
                        window, n_split):
    """paged_split_kernel + paged_merge_kernel, fp32: per (slot, kv head)
    the rows [0, min(pos, tokens, PPS*T)) cut into n_split chunks of
    ceil(rows / n_split); a chunk's (acc, m, l) from its valid rows (an
    empty chunk gives (0, -1e30, 0)); the merge starts from the new token
    (max = its score, den = 1, num = v_new) and folds the chunks in split
    order, MERGE_BATCH at a time under one shared max."""
    s, h, hd = q.shape
    hkv = kv_heads
    g = h // hkv
    pps = tables.shape[1]
    null = pages.shape[0] - 1
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    out = torch.empty((s, h, hd))
    for si in range(s):
        p = int(pos[si])
        rows = min(pps * page_tokens, tokens, p)
        length = -(-rows // n_split)
        for n in range(hkv):
            kc = k_off + layer * hkv * hd + n * hd
            vc = v_off + layer * hkv * hd + n * hd
            qn = q[si, n * g:(n + 1) * g].float()                 # [G, hd]
            parts = []
            for c in range(n_split):
                lo, hi = min(rows, c * length), min(rows, c * length + length)
                keep = [r for r in range(lo, hi)
                        if _row_counts(r, p, tokens, window)
                        and int(tables[si, r // page_tokens]) != null]
                if not keep:
                    parts.append((torch.zeros(g, hd), torch.full((g,), -1e30),
                                  torch.zeros(g)))
                    continue
                pids = [int(tables[si, r // page_tokens]) for r in keep]
                offs = [r % page_tokens for r in keep]
                kr = pages[pids, offs, kc:kc + hd]                 # [R, hd]
                vr = pages[pids, offs, vc:vc + hd]
                sc = (qn @ kr.T) * scale                           # [G, R]
                m = sc.amax(-1)
                e = torch.exp(sc - m[:, None])
                parts.append((e @ vr, m, e.sum(-1)))
            mx = (qn @ k_new[si, n].float()) * scale               # [G]
            den = torch.ones(g)
            num = v_new[si, n].float()[None, :].repeat(g, 1)
            for c0 in range(0, n_split, MERGE_BATCH):
                batch = parts[c0:c0 + MERGE_BATCH]
                bm = torch.stack([mx] + [m for _, m, _ in batch]).amax(0)
                f = torch.exp(mx - bm)
                den, num = den * f, num * f[:, None]
                for acc, m, l_ in batch:
                    fu = torch.exp(m - bm)
                    den = den + l_ * fu
                    num = num + acc * fu[:, None]
                mx = bm
            out[si, n * g:(n + 1) * g] = num / den.clamp_min(1e-30)[:, None]
    return out


S, HD, LAYERS = 4, 32, 2


def _paged_case(h, hkv, t, tokens, pos, seed, null_slot=None):
    """A [P+1, T, W] pool (LAYERS K blocks, then V blocks, then a trailing
    leaf); slot 0 lazily allocated (its later page slots on the null
    page); ``null_slot`` holds only null pages."""
    rng = np.random.default_rng(seed)
    kvsz = hkv * HD
    pps = -(-tokens // t)
    n_pages = S * pps
    width = 2 * LAYERS * kvsz + LAYERS
    pages = rng.standard_normal((n_pages + 1, t, width)).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(S, pps).astype(np.int32)
    tables[0, max(pps // 2, 1):] = n_pages
    if null_slot is not None:
        tables[null_slot] = n_pages
    ops = dict(q=rng.standard_normal((S, h, HD)).astype(np.float32),
               k_new=rng.standard_normal((S, hkv, HD)).astype(np.float32),
               v_new=rng.standard_normal((S, hkv, HD)).astype(np.float32),
               pages=pages, tables=tables, pos=np.asarray(pos, np.int32))
    kw = dict(k_off=0, v_off=LAYERS * kvsz, kv_heads=hkv, head_dim=HD,
              tokens=tokens, page_tokens=t)
    return ops, kw


_ORDER = ("q", "k_new", "v_new", "pages", "tables", "pos")

# (H, Hkv, T, tokens, positions, window, n_split, null slot, layer):
# wrapped rings (pos > tokens), a slot at position 0, windows below and at
# the ring length, T not dividing the ring, one chunk, the chooser's count,
# more chunks than any slot has rows (most of them empty), more than one
# merge batch, a slot of null pages only (every chunk empty), layers 0, 1.
PAGED_CASES = [
    (4, 2, 4, 16, [7, 30, 0, 41], 0, 1, None, 0),
    (4, 2, 4, 16, [7, 30, 0, 41], 8, 3, None, 1),
    (4, 1, 4, 16, [3, 21, 0, 16], 16, 5, 3, 1),
    (4, 2, 3, 10, [2, 14, 0, 9], 5, 40, None, 0),
    (8, 2, 8, 24, [6, 17, 0, 55], 0, 11, 1, 1),
    (2, 2, 4, 16, [16, 37, 5, 0], 0, None, None, 0),
]


@pytest.mark.parametrize(
    "h,hkv,t,tokens,pos,window,n_split,null_slot,layer", PAGED_CASES)
def test_paged_split_and_merge_match_the_oracle(h, hkv, t, tokens, pos,
                                                window, n_split, null_slot,
                                                layer):
    ops, kw = _paged_case(h, hkv, t, tokens, pos, seed=h + t + tokens + layer,
                          null_slot=null_slot)
    if n_split is None:
        n_split = tpa.choose_split(S, h, hkv, tokens)
    args = [torch.from_numpy(ops[k]) for k in _ORDER]
    got = emulate_paged_split(*args, layer, window=window, n_split=n_split,
                              **kw).numpy()
    jargs = [jnp.asarray(ops[k]) for k in _ORDER]
    want = np.asarray(paged_oracle(*jargs, layer, window=window, **kw),
                      np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= TOL_PAGED


# The serve cell's shape and chip_smoke.py's PAGED_GRID shapes: (slots, H,
# Hkv, hd, tokens).
SPLIT_SHAPES = [
    (8, 32, 8, 80, 512),       # h2o-danube-1.8b (the serve cell)
    (8, 32, 32, 128, 1100),    # deepseek-7b
    (8, 40, 8, 128, 512),      # qwen3-14b
    (1, 32, 8, 80, 512),       # one slot
    (8, 4, 1, 32, 24),         # a short ring
]


@pytest.mark.parametrize("slots,h,hkv,hd,tokens", SPLIT_SHAPES)
def test_split_count_and_workspace_follow_the_shapes(slots, h, hkv, hd,
                                                     tokens):
    n = tpa.choose_split(slots, h, hkv, tokens)
    assert n == tpa.choose_split(slots, h, hkv, tokens)
    cap = -(-tokens // tpa.MIN_CHUNK_ROWS)
    assert 1 <= n <= cap
    per_chunk = slots * hkv * -(-(h // hkv) // tpa.MAX_GROUP)
    target = tpa.BLOCKS_PER_SM * tpa.SMS
    # the count whose blocks come nearest to the target, unless the ring
    # is too short to give each chunk MIN_CHUNK_ROWS rows
    if n < cap:
        assert all(abs(n * per_chunk - target) <= abs(m * per_chunk - target)
                   for m in range(1, cap + 1))
    shape = tpa.workspace_shape(slots, h, hkv, hd, n)
    assert shape == (slots, hkv, n, h // hkv, hd + 2)
    assert math.prod(shape) * 4 < 64 << 20      # a few MB at most


def test_split_count_at_the_serve_cell():
    """danube's serve cell (8 slots x 8 kv heads, one head group): four
    chunks a (slot, kv head), 256 blocks for 132 SMs."""
    assert tpa.choose_split(8, 32, 8, 512) == 4
