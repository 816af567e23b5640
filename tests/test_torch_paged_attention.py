"""Port parity: the plain ``repro_torch.kernels.ref.paged_attention`` (what a
CPU tensor runs, and what the CUDA kernel is held against on the card)
against the JAX package's oracle ``repro.kernels.ref.paged_attention`` and
its Pallas kernel in interpret mode, as the JAX package's own tests run it.

Cases: rings wrapped (pos > tokens) and not, lazily allocated slots (null
pages) and an empty slot, window 0 and window < tokens, GQA groups g in
{1, 2, 4}, T not dividing the ring, layer > 0, and bf16 operands.

Tolerances: fp32 operands, the two packages' einsum/softmax round
differently, ~1e-6 on outputs of size O(1): held at 1e-5. bf16 operands
(the full-width cache dtype): both round K/V and the probabilities to bf16,
so the outputs (O(1), bf16 ulp <= 2^-7 relative) may differ by a few ulps:
held at 2^-5 absolute.

One reference fault is pinned here rather than papered over: on a ring
that has wrapped with no window at or below its length, the Pallas kernel
keeps the cursor row's old token (position pos - tokens), which the oracle
and the gather -> decode route overwrite with the new token. The port (its
plain version and its CUDA kernel) computes the oracle's function.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

S, HD, LAYERS = 3, 32, 2
TOL32 = 1e-5
TOL_BF16 = 2 ** -5


def _case(h, hkv, t, tokens, pos, seed=0, lazy=True):
    """numpy operands: a [P+1, T, W] pool holding LAYERS K blocks then
    LAYERS V blocks then a trailing int leaf; slot 0 lazily allocated (its
    later page slots on the null page), slot S-1 empty when ``lazy``."""
    rng = np.random.default_rng(seed)
    kvsz = hkv * HD
    pps = -(-tokens // t)
    n_pages = S * pps
    width = 2 * LAYERS * kvsz + LAYERS
    pages = rng.standard_normal((n_pages + 1, t, width)).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(S, pps).astype(np.int32)
    if lazy:
        tables[0, max(pps // 2, 1):] = n_pages
        tables[-1] = n_pages
    ops = dict(q=rng.standard_normal((S, h, HD)).astype(np.float32),
               k_new=rng.standard_normal((S, hkv, HD)).astype(np.float32),
               v_new=rng.standard_normal((S, hkv, HD)).astype(np.float32),
               pages=pages, tables=tables, pos=np.asarray(pos, np.int32))
    kw = dict(k_off=0, v_off=LAYERS * kvsz, kv_heads=hkv, head_dim=HD,
              tokens=tokens, page_tokens=t)
    return ops, kw


_ORDER = ("q", "k_new", "v_new", "pages", "tables", "pos")


def _port(ops, layer, dtype=torch.float32, **kw):
    args = [torch.from_numpy(ops[k]) for k in _ORDER]
    args[:3] = [a.to(dtype) for a in args[:3]]
    return ref.paged_attention(*args, layer, **kw).float().numpy()


def _jax_ref(ops, layer, dtype=jnp.float32, **kw):
    args = [jnp.asarray(ops[k]) for k in _ORDER]
    args[:3] = [a.astype(dtype) for a in args[:3]]
    return np.asarray(jref.paged_attention(*args, layer, **kw), np.float32)


def _pallas(ops, layer, **kw):
    args = [jnp.asarray(ops[k]) for k in _ORDER]
    return np.asarray(jpa.paged_attention(*args, layer, interpret=True, **kw))


def _err(a, b):
    return float(np.abs(a - b).max())


# (H, Hkv, T, tokens, pos per slot, window): g = H / Hkv in {1, 2, 4}.
CASES = [
    (4, 4, 4, 16, [5, 9, 0], 0),        # g = 1, no wrap
    (4, 2, 4, 16, [7, 30, 0], 8),       # g = 2, wrapped, window < tokens
    (4, 1, 4, 16, [3, 21, 0], 16),      # g = 4, wrapped, window == tokens
    (4, 2, 3, 10, [2, 14, 0], 5),       # T does not divide the ring
    (4, 1, 8, 24, [6, 17, 0], 0),       # g = 4, full causal, no wrap
]


@pytest.mark.parametrize("h,hkv,t,tokens,pos,window", CASES)
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_jax_oracle_and_pallas(h, hkv, t, tokens, pos, window,
                                             layer):
    ops, kw = _case(h, hkv, t, tokens, pos, seed=h + t + tokens + layer)
    got = _port(ops, layer, window=window, **kw)
    assert got.shape == (S, h, HD) and np.isfinite(got).all()
    assert _err(got, _jax_ref(ops, layer, window=window, **kw)) <= TOL32
    assert _err(got, _pallas(ops, layer, window=window, **kw)) <= TOL32


@pytest.mark.parametrize("window", [0, 40])
def test_wrapped_ring_without_window_follows_the_oracle(window):
    """A ring that has wrapped (pos >= tokens) with no window at or below
    its length: the port equals the JAX oracle; the Pallas kernel also
    attends to the cursor row's old token (position pos - tokens) and so
    differs by O(1) (a fault of the reference, pinned here)."""
    ops, kw = _case(4, 2, 4, 16, [16, 37, 5], seed=11, lazy=False)
    got = _port(ops, 1, window=window, **kw)
    assert _err(got, _jax_ref(ops, 1, window=window, **kw)) <= TOL32
    pallas = _pallas(ops, 1, window=window, **kw)
    # slots 0 and 1 have wrapped; slot 2 (pos 5) has not
    assert _err(got[:2], pallas[:2]) > 1e-2
    assert _err(got[2:], pallas[2:]) <= TOL32


@pytest.mark.parametrize("h,hkv,t,tokens,pos,window", CASES[1:4])
def test_plain_bf16_matches_jax_oracle(h, hkv, t, tokens, pos, window):
    """bf16 q/k_new/v_new, as at full width: both packages round the
    gathered K/V and the probabilities to bf16 (see the module note)."""
    ops, kw = _case(h, hkv, t, tokens, pos, seed=7)
    got = _port(ops, 1, dtype=torch.bfloat16, window=window, **kw)
    want = _jax_ref(ops, 1, dtype=jnp.bfloat16, window=window, **kw)
    assert _err(got, want) <= TOL_BF16


def test_dispatch_routes_cpu_tensors_to_plain():
    ops, kw = _case(4, 2, 4, 16, [5, 9, 0])
    dispatch.reset_report()
    args = [torch.from_numpy(ops[k]) for k in _ORDER]
    got = dispatch.paged_attention(*args, 1, window=8, **kw)
    assert dispatch.report()["paged_attention"].startswith("ref")
    assert torch.equal(got, ref.paged_attention(*args, 1, window=8, **kw))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never quietly runs the plain version: CPU tensors
    raise before anything is built or launched."""
    ops, kw = _case(4, 2, 4, 16, [5, 9, 0])
    args = [torch.from_numpy(ops[k]) for k in _ORDER]
    before = tpa.paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(*args, 1, window=8, **kw)
    assert tpa.paged_attention.launches == before
