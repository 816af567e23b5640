"""CUDA kernel: the Definition-1 reduction (``csrc/coherence.cu``).

``dots = H @ g``, ``hist_sq[w] = <H[w], H[w]>`` and ``g_sq = <g, g>`` in one
pass over the probe-gradient history, the port of
``repro/kernels/coherence.py``. No float atomics: every sum has a fixed
order, so two calls on the same inputs are equal bit for bit.

Two grids, both programmatic dependent launches. The first is sized to the
card: :func:`choose_grid` gives two blocks an SM (all of D in one wave), each
a contiguous chunk of D, and the fold of the kernel's per-thread cascade
that keeps the longest chain of roundings (:func:`chain_length`) short;
each block writes its partials to a workspace. The second, one block of 32
warps, sums each output's partials in block order with a fixed tree (one
launch counted per call). The kernel takes contiguous fp32 CUDA tensors, any
W >= 1 and any D (it masks its own ragged tail); anything else raises. CPU
tensors go to ``kernels/ref.py`` through ``kernels/dispatch.py``, never
through here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

THREADS = 256        # kThreads: a block of the first grid
BLOCKS_PER_SM = 2    # kBlocksPerSm: what its __launch_bounds__ keep resident
SLOTS = 8            # kSlots: partials a lane of the final sum takes
MAX_BLOCKS = 32 * SLOTS
ROWS = 16            # kRows: history rows a block
# Tune<R> of the CUDA source: R -> (U trips an iteration, L cascade levels).
TUNE = {1: (4, 3), 2: (4, 3), 4: (2, 3), 8: (2, 3), 16: (1, 1)}


def row_group(w: int) -> int:
    """Rows a block reads: the smallest power of two >= W, at most ROWS."""
    return ROWS if w > 8 else 8 if w > 4 else 4 if w > 2 else w


def units(d: int, aligned: bool) -> tuple:
    """(vec, n): 16-byte units where D % 4 == 0 and both operands are
    16-byte aligned (the CUDA source's rule), else floats."""
    vec = d % 4 == 0 and aligned
    return vec, d // 4 if vec else d


def cascade(iters: int, fold: int, levels: int) -> int:
    """Roundings a thread's first value passes through in the kernel's
    cascade over ``iters`` iterations: each level adds up to ``fold`` of
    the level below, the top all that is left; then the levels are added
    top down."""
    if levels == 1:
        return max(iters - 1, 0)
    return (2 * (min(fold, iters) - 1) + max(-(-iters // fold ** 2) - 1, 0)
            + 2)


def choose_grid(w: int, d: int, aligned: bool, sms: int) -> tuple:
    """(blocks, chunk, fold) for a [W, D] history on a card with ``sms``
    SMs. Blocks: BLOCKS_PER_SM an SM, shared by the row groups (one wave),
    no more than the units need (one a thread) and at most MAX_BLOCKS (the
    final sum's slots). Chunk: the units a block owns, a multiple of 32
    (whole cache lines for a warp). Fold: the cascade's fan-in that gives
    the shortest chain over a thread's iterations."""
    r = row_group(w)
    u, levels = TUNE[r]
    groups = -(-w // r)
    _, n = units(d, aligned)
    blocks = max(1, min(BLOCKS_PER_SM * sms // groups, -(-n // THREADS),
                        MAX_BLOCKS))
    chunk = -(-(-(-n // blocks)) // 32) * 32
    blocks = -(-n // chunk)
    iters = -(-chunk // (u * THREADS))
    fold = min(range(1, 65), key=lambda f: cascade(iters, f, levels))
    return blocks, chunk, fold


def chain_length(w: int, d: int, aligned: bool, sms: int) -> int:
    """The longest chain of roundings from a term to its output in the
    kernel's order (the normwise error bound is this times eps times the
    sum of |terms|): a trip's tree, the U trips' tree, the cascade, the
    warp and block trees, and the final sum's 8-slot and shuffle trees."""
    u, levels = TUNE[row_group(w)]
    vec, _ = units(d, aligned)
    _, chunk, fold = choose_grid(w, d, aligned, sms)
    iters = -(-chunk // (u * THREADS))
    return ((3 if vec else 1) + int(math.log2(u))
            + cascade(iters, fold, levels) + 5 + 3
            + int(math.log2(SLOTS)) + 5)


def coherence_dots(history: torch.Tensor, g: torch.Tensor):
    """history [W, D], g [D] (fp32, CUDA) -> (dots [W], hist_sq [W],
    g_sq []), views of one [2W + 1] output."""
    if history.dim() != 2:
        raise ValueError("coherence_dots: history must be [W, D]")
    w, d = history.shape
    if w < 1:
        raise ValueError("coherence_dots: history needs at least one row")
    build.check_operand("coherence_dots", "history", history, (w, d),
                        history.device)
    build.check_operand("coherence_dots", "g", g, (d,), history.device)
    # The kernel writes every output; with D = 0 the sums are empty (zero).
    dev = history.device
    out = (torch.empty if d else torch.zeros)((2 * w + 1,), device=dev)
    if d > 0:
        aligned = history.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks, chunk, fold = choose_grid(w, d, aligned, sms)
        ws = torch.empty(((2 * w + 1) * blocks,), device=dev)
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.repro_coherence_f32(
                out.data_ptr(), ws.data_ptr(), history.data_ptr(),
                g.data_ptr(), w, d, blocks, chunk, fold,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "coherence_dots")
        coherence_dots.launches += 1
    return out[:w], out[w:2 * w], out[2 * w]


coherence_dots.launches = 0
