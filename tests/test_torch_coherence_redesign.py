"""The summation order of the redesigned ``coherence_dots`` kernel, emulated
on the CPU and held against the JAX package.

The CUDA kernel (``csrc/coherence.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Its order of additions is
emulated here in fp32 torch, step by step, on numpy-seeded inputs that the
JAX side gets too: the wrapper's grid (``coherence.choose_grid``: blocks,
chunk, cascade fold), each thread's trips kThreads units apart (a trip's
four products as a tree, the U trips of an iteration as a tree), the
three-level cascade over iterations, the warp shuffle tree, the 8 warps as
a tree, and the final grid's sum of each output's block partials (a
warp a column: an 8-slot tree in each lane, then the shuffle tree). The
emulation is held against

- fp64, normwise: ``|x - x64| <= COHERENCE_C * eps * sum |terms|`` with
  ``COHERENCE_C = 64``, the bound of ``tests/test_torch_cuda.py`` and
  ``chip_smoke.py``;
- the Pallas kernel in interpret mode and the JAX oracle
  (``repro.kernels.ref.coherence_dots``), fp32 sums in other orders: each
  side within that bound of fp64, so the two within twice it.

The same emulation run over rounding counts instead of values gives the
longest chain of roundings from a term to its output, which must not
exceed ``coherence.chain_length`` (the count the kernel's header and the
tolerance comments cite); ``chain_length`` itself stays within
``COHERENCE_C`` at the DNN and LM shapes. Small SM counts make many
iterations a thread, so the cascade's folds are exercised at small D.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import coherence as jkco
from repro.kernels import ref as jref
from repro_torch.kernels import coherence as tco

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

COHERENCE_C = 64
WARP = 32
WARPS = tco.THREADS // WARP
DNN_WIDTH = 335_872          # the Fig. 1(e)(f) DNN's D_pad
LM_WIDTH = 441_737_216       # the 4-layer danube ring legs' D_pad
H100_SMS = 132


class Values:
    """fp32 arithmetic (fma rounded once from the exact fp64 product)."""
    zero = staticmethod(lambda shape: torch.zeros(shape))

    @staticmethod
    def of(x):
        return x

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()


class Roundings:
    """The same order over rounding counts: -1 marks an exact zero (a
    masked unit, an empty accumulator), which an addition passes through
    exactly; any other addition or product adds one rounding to the
    deepest of its operands."""
    zero = staticmethod(lambda shape: torch.full(shape, -1))

    @staticmethod
    def of(x):
        return torch.where(x != 0, 0, -1)

    @staticmethod
    def add(a, b):
        both = (a >= 0) & (b >= 0)
        return torch.maximum(a, b) + both.long()

    @staticmethod
    def mul(a, b):
        return torch.where((a >= 0) & (b >= 0), torch.maximum(a, b) + 1, -1)

    @staticmethod
    def fma(a, b, c):
        prod = torch.where((a >= 0) & (b >= 0), 0, -1)
        return Roundings.add(prod, c)


def _tree(x, op, dim=-1):
    """x's last (or ``dim``) axis, a power of two long, summed as the
    kernel's ``tree`` and ``warp_sum`` do: halves added pairwise."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = op.add(x[..., :h], x[..., h:])
    return x[..., 0]


def _trip(a, b, op, vec: bool):
    """A unit's products: [..., 4] float4 components as
    fma(x, x', y y') + fma(z, z', w w'), or one product."""
    if not vec:
        return op.mul(a, b)
    lo = op.fma(a[..., 0], b[..., 0], op.mul(a[..., 1], b[..., 1]))
    hi = op.fma(a[..., 2], b[..., 2], op.mul(a[..., 3], b[..., 3]))
    return op.add(lo, hi)


def _block_partials(h, g, op, vec, blocks, chunk, fold, u, levels):
    """[blocks, K] partials of one row group: h [R, n(, 4)], g [n(, 4)]
    (rows padded to R by repeating the last), K = 2R + 1 outputs (dots,
    squares, g^2)."""
    r, n = h.shape[0], g.shape[0]
    step = u * tco.THREADS
    iters = -(-chunk // step)
    tail = (4,) if vec else ()

    def lay(x):
        # [..., n(, 4)] -> [..., blocks, iters, U, THREADS(, 4)]: block b's
        # unit b * chunk + i * U * THREADS + j * THREADS + t, zero past its
        # chunk (masked loads) and past n.
        lead = x.shape[:x.dim() - 1 - len(tail)]
        out = torch.zeros(lead + (blocks, iters * step) + tail, dtype=x.dtype)
        for b in range(blocks):
            lo, hi = b * chunk, min(n, (b + 1) * chunk)
            if hi > lo:
                out[..., b, :hi - lo, *[slice(None)] * len(tail)] = x[
                    ..., lo:hi, *[slice(None)] * len(tail)]
        return op.of(out.reshape(lead + (blocks, iters, u, tco.THREADS)
                                 + tail))

    hl, gl = lay(h), lay(g)
    # Per output: [blocks, iters, U, THREADS] trip values, then the U tree.
    vals = ([_trip(hl[k], gl, op, vec) for k in range(r)]
            + [_trip(hl[k], hl[k], op, vec) for k in range(r)]
            + [_trip(gl, gl, op, vec)])
    v = torch.stack([_tree(x, op, dim=2) for x in vals], -1)
    # v: [blocks, iters, THREADS, K]; the cascade over iterations.
    shape = (blocks, tco.THREADS, 2 * r + 1)
    acc = [op.zero(shape) for _ in range(levels)]
    c1 = c2 = 0
    for i in range(iters):
        acc[0] = op.add(acc[0], v[:, i])
        if levels == 3:
            c1 += 1
            if c1 == fold:
                c1 = 0
                acc[1], acc[0] = op.add(acc[1], acc[0]), op.zero(shape)
                c2 += 1
                if c2 == fold:
                    c2 = 0
                    acc[2], acc[1] = op.add(acc[2], acc[1]), op.zero(shape)
    s = acc[-1]
    for lvl in range(levels - 2, -1, -1):
        s = op.add(s, acc[lvl])
    # Warp shuffle trees, then the 8 warps as a tree.
    s = s.reshape(blocks, WARPS, WARP, 2 * r + 1)
    s = _tree(s, op, dim=2)                       # [blocks, WARPS, K]
    return _tree(s, op, dim=1)                    # [blocks, K]


def emulate(h: torch.Tensor, g: torch.Tensor, sms: int, op=Values,
            aligned: bool = True):
    """The kernel's (dots, hist_sq, g_sq) on h [W, D], g [D] (fp32), in its
    order of additions, for a card with ``sms`` SMs; with ``op=Roundings``
    the rounding count of each output's deepest term instead."""
    w, d = h.shape
    r = tco.row_group(w)
    u, levels = tco.TUNE[r]
    vec, n = tco.units(d, aligned)
    blocks, chunk, fold = tco.choose_grid(w, d, aligned, sms)
    hv = h.reshape(w, n, 4) if vec else h
    gv = g.reshape(n, 4) if vec else g
    dots, sqs, gsq = [], [], None
    for r0 in range(0, w, r):
        rows = min(r, w - r0)
        idx = [r0 + min(k, rows - 1) for k in range(r)]
        part = _block_partials(hv[idx], gv, op, vec, blocks, chunk, fold, u,
                               levels)
        dots += [part[:, k] for k in range(rows)]
        sqs += [part[:, r + k] for k in range(rows)]
        if r0 == 0:
            gsq = part[:, 2 * r]
    cols = dots + sqs + [gsq]
    # The final grid: a warp a column; lane l takes the partials of blocks
    # l, l + 32, ... (SLOTS of them, zero past `blocks`) as a tree, then
    # the shuffle tree.
    out = []
    for col in cols:
        pad = op.zero((tco.MAX_BLOCKS,))
        pad[:blocks] = col
        slots = pad.reshape(tco.SLOTS, WARP)                  # [slot, lane]
        out.append(_tree(_tree(slots, op, dim=0), op))
    out = torch.stack(out)
    return out[:w], out[w:2 * w], out[2 * w]


def _inputs(w, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((w, d)).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


def excess(out, h, g, want=None) -> float:
    """Largest error of (dots, hist_sq, g_sq) against fp64 (or ``want``),
    in units of eps * sum |terms|."""
    h64, g64 = h.double(), g.double()
    if want is None:
        want = (h64 @ g64, (h64 * h64).sum(-1), (g64 * g64).sum())
    scale = (h64.abs() @ g64.abs(), (h64 * h64).sum(-1), (g64 * g64).sum())
    eps = torch.finfo(torch.float32).eps
    return max(float(((a.double() - torch.tensor(np.asarray(x)).double())
                      .abs() / (eps * sc).clamp(min=1e-300)).max())
               for a, x, sc in zip(out, want, scale))


@pytest.mark.parametrize("w", [1, 3, 8, 16, 17])
@pytest.mark.parametrize("d,sms", [(4096, H100_SMS), (4096, 2), (1_003, 1),
                                   (262_144, 1), (DNN_WIDTH, H100_SMS)])
def test_emulated_order_matches_pallas_oracle_and_fp64(w, d, sms):
    hn, gn = _inputs(w, d, seed=w * 7 + d % 97)
    h, g = torch.from_numpy(hn), torch.from_numpy(gn)
    got = emulate(h, g, sms)
    assert [tuple(x.shape) for x in got] == [(w,), (w,), ()]
    assert excess(got, h, g) <= COHERENCE_C
    # The Pallas kernel takes D in whole 2048-wide blocks; the ragged D
    # goes to the oracle alone.
    pallas = (jkco.coherence_dots(jnp.asarray(hn), jnp.asarray(gn),
                                  interpret=True) if d % 2048 == 0 else None)
    oracle = jref.coherence_dots(jnp.asarray(hn), jnp.asarray(gn))
    assert excess(got, h, g, oracle) <= 2 * COHERENCE_C
    if pallas is not None:
        assert excess(got, h, g, pallas) <= 2 * COHERENCE_C


@pytest.mark.parametrize("w,d,sms,aligned", [
    (1, 4096, 1, True), (4, 4096, 1, True), (8, 3000, 1, True),
    (3, 1_003, 1, False), (16, 4096, 1, True), (17, 2048, 2, True),
    (1, 262_144, 1, True), (4, 262_144, 1, True), (8, 262_144, 1, True),
    (3, 200_003, 1, False), (16, 65_536, 1, True),
    (8, DNN_WIDTH, H100_SMS, True), (16, DNN_WIDTH, H100_SMS, True)])
def test_emulated_chain_stays_within_chain_length(w, d, sms, aligned):
    """The deepest term of every output passes through no more roundings
    than chain_length counts (ones, so no term is an exact zero). One SM
    gives a few blocks many iterations, which runs the cascade's folds."""
    ones = torch.ones((w, d)), torch.ones(d)
    depth = emulate(*ones, sms, op=Roundings, aligned=aligned)
    deepest = max(int(x.max()) for x in depth)
    assert 0 < deepest <= tco.chain_length(w, d, aligned, sms)


@pytest.mark.parametrize("w,d,aligned", [
    (8, DNN_WIDTH, True), (16, DNN_WIDTH, True), (3, 1_000_003, True),
    (4, LM_WIDTH, True), (4, LM_WIDTH, False), (1, LM_WIDTH, True),
    (2, LM_WIDTH, True)])
def test_chain_length_within_the_tolerance(w, d, aligned):
    """At the DNN shapes, the smoke's ragged case and the LM width (also
    on the scalar path that misaligned operands take) the bound the tests
    hold the kernel to covers its longest chain."""
    assert tco.chain_length(w, d, aligned, H100_SMS) <= COHERENCE_C


@pytest.mark.parametrize("w,d,want", [
    (8, DNN_WIDTH, (239, 352, 1)), (16, DNN_WIDTH, (239, 352, 1)),
    (3, 1_000_003, (255, 3936, 2)), (4, LM_WIDTH, (256, 431392, 9)),
    (17, DNN_WIDTH, (132, 640, 1)), (40, DNN_WIDTH, (88, 960, 1))])
def test_grid_at_the_h100(w, d, want):
    """The grid at the shapes the main paths run, on 132 SMs: one wave
    (blocks x row groups within the resident blocks), no more blocks than
    the final sum's slots, a chunk in whole warps' cache lines, covering
    D."""
    blocks, chunk, fold = tco.choose_grid(w, d, True, H100_SMS)
    assert (blocks, chunk, fold) == want
    groups = -(-w // tco.row_group(w))
    _, n = tco.units(d, True)
    assert blocks * groups <= tco.BLOCKS_PER_SM * H100_SMS
    assert blocks <= tco.MAX_BLOCKS
    assert chunk % 32 == 0 and (blocks - 1) * chunk < n <= blocks * chunk


def test_grid_is_a_function_of_its_inputs():
    """Replay holds bit for bit only if the grid depends on (W, D,
    alignment, SM count) alone: the same inputs give the same grid, and a
    misaligned operand takes float units."""
    assert tco.choose_grid(8, DNN_WIDTH, True, 132) == tco.choose_grid(
        8, DNN_WIDTH, True, 132)
    assert tco.units(DNN_WIDTH, False) == (False, DNN_WIDTH)
    assert tco.units(1_003, True) == (False, 1_003)
    assert tco.units(DNN_WIDTH, True) == (True, DNN_WIDTH // 4)
