"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA GPU.
The file imports only torch and the port (the GPU machine need not have
JAX), so it runs there with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

``chip_smoke.py`` runs the same checks at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import coherence as tcoh
from repro_torch.kernels import coherence as tco
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import flash_attention as tfl
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import sparsify as tsp
from repro_torch.kernels import stale_accum as tsa

# Adam repeats the plain version's operations in its order, one rounding
# each; the plain version divides by a scalar as a multiply by its
# reciprocal, so elements may differ by about one ulp.
TOL_ADAM = dict(rtol=1e-5, atol=1e-7)
# coherence_dots, normwise against fp64: |x - x64| <= C * eps * sum_i |t_i|
# for the terms t_i of each sum. The kernel's longest chain of roundings
# from a term to its output (a trip's tree, the U trips' tree, its
# per-thread cascade, the warp and block trees, the final grid's 8-slot
# and shuffle trees; kernels/coherence.py::chain_length) is at most 31 at
# these shapes on an H100 (48 at the LM width), under 64, so C = 64 is its
# worst-case bound; the plain version's sums are held to the same bound.
COHERENCE_C = 64
# paged_attention, fp32 operands: the kernel's online softmax and the plain
# version's one-shot softmax round differently; outputs are convex
# combinations of O(1) values, so a few ulps of 1.
TOL_PAGED = dict(rtol=1e-5, atol=1e-5)
# flash_attention, fp32 operands: the kernel's online softmax (a running max
# and rescale per 32-key tile) and the plain version's one-shot softmax
# round differently; outputs are convex combinations of O(1) values.
TOL_FLASH = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _accum_inputs(s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d).astype(np.float32),
            rng.standard_normal((s, d)).astype(np.float32),
            rng.uniform(0.1, 1.0, s).astype(np.float32))


def _adam_inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.standard_normal(d).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.0, 0.1, d).astype(np.float32)
    return p, 0.1 * m, v, g


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048 * 4, 1_003])
@pytest.mark.parametrize("s", [1, 4])
def test_stale_accum_kernel_matches_plain(cuda_device, s, d):
    p, buf, w = (torch.from_numpy(x).to(cuda_device)
                 for x in _accum_inputs(s, d))
    if s == 1:
        w = torch.ones_like(w)
    before = tsa.stale_accum.launches
    got = tsa.stale_accum(p, buf, w)
    torch.cuda.synchronize()
    assert tsa.stale_accum.launches == before + 1
    want = ref.stale_accum(p, buf, w)
    if s == 1:
        assert torch.equal(got, want)      # one exact add per element
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048 * 4, 1_003])
@pytest.mark.parametrize("step", [1, 100])
def test_fused_adam_kernel_matches_plain(cuda_device, step, d):
    p, m, v, g = (torch.from_numpy(x).to(cuda_device)
                  for x in _adam_inputs(d))
    got = tfa.fused_adam(p, m, v, g, 1e-3, 0.9, 0.999, 1e-8, step)
    torch.cuda.synchronize()
    want = ref.fused_adam(p, m, v, g, 1e-3, 0.9, 0.999, 1e-8, step)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL_ADAM)


@pytest.mark.cuda
def test_dispatch_routes_cuda_tensors_to_kernels(cuda_device):
    dispatch.reset_report()
    p, buf, w = (torch.from_numpy(x).to(cuda_device)
                 for x in _accum_inputs(1, 4096))
    before = tsa.stale_accum.launches
    dispatch.stale_accum(p, buf, w)
    assert tsa.stale_accum.launches == before + 1
    assert dispatch.report()["stale_accum"] == "cuda"


def _update_inputs(r, d, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    acc = rng.standard_normal((r, d))
    return dict(p=t(rng.standard_normal(d)), m=t(0.1 * rng.standard_normal(d)),
                v=t(rng.uniform(0.0, 0.1, d)),
                stale=t(rng.standard_normal((r, d))),
                weights=t(np.full((r,), 1.0 / r)), acc=t(acc),
                thr=t(np.quantile(np.abs(acc), 0.9, axis=1)),
                fresh=t(np.arange(r) % 2 == 0),
                mom=t(0.1 * rng.standard_normal((r, d))))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048 * 4, 1_003])
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("variant", ["plain", "ef", "ef_mom"])
def test_fused_update_kernel_matches_plain(cuda_device, variant, r, d):
    """The split, the momentum mask and u (rows summed in the same order,
    one rounding each) are bitwise; p', m', v' are Adam's TOL_ADAM."""
    x = _update_inputs(r, d, cuda_device, seed=r)
    opt = {} if variant == "plain" else {k: x[k] for k in ("acc", "thr",
                                                           "fresh")}
    if variant == "ef_mom":
        opt["mom"] = x["mom"]
    args = [x[k] for k in ("p", "m", "v", "stale", "weights")]
    scale = torch.full((1,), 0.5, device=cuda_device)
    before = dict(tfu.fused_update.by_variant)
    got = tfu.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 5, scale, **opt)
    torch.cuda.synchronize()
    assert tfu.fused_update.by_variant[variant] == before[variant] + 1
    want = ref.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 5, scale, **opt)
    assert len(got) == len(want)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, **TOL_ADAM)
    for a, b in zip(got[3:], want[3:]):
        assert torch.equal(a, b)
    if variant != "plain":
        assert torch.equal(got[4] + got[5], x["acc"])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048 * 4, 1_003])
@pytest.mark.parametrize("variant", ["ef", "ef_mom"])
def test_fused_update_kernel_without_ring_matches_plain(cuda_device,
                                                        variant, d):
    """The sync tail's call: one row, no ring (stale and fresh None), so
    the row delivers this step's sent."""
    x = _update_inputs(1, d, cuda_device, seed=3)
    opt = {k: x[k] for k in ("acc", "thr")}
    if variant == "ef_mom":
        opt["mom"] = x["mom"]
    args = [x["p"], x["m"], x["v"], None, x["weights"]]
    scale = torch.full((1,), 0.5, device=cuda_device)
    before = dict(tfu.fused_update.by_variant)
    got = tfu.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 5, scale, **opt)
    torch.cuda.synchronize()
    assert tfu.fused_update.by_variant[variant] == before[variant] + 1
    want = ref.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 5, scale, **opt)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, **TOL_ADAM)
    for a, b in zip(got[3:], want[3:]):
        assert torch.equal(a, b)
    assert torch.equal(got[3], got[4][0])     # u is the one row's sent


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 2048 * 4), (3, 1_003), (2048 * 4,)])
def test_sparsify_kernel_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(0)
    acc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    thr = acc.abs().quantile(0.9, dim=-1)
    before = tsp.sparsify_topk.launches
    sent, resid = dispatch.sparsify_topk(acc, thr)
    torch.cuda.synchronize()
    assert tsp.sparsify_topk.launches == before + 1
    want = ref.sparsify_mask(acc, thr)
    assert torch.equal(sent, want[0]) and torch.equal(resid, want[1])
    assert torch.equal(sent + resid, acc)
    assert dispatch.report()["sparsify_topk"] == "cuda"


def coherence_excess(out, h, g):
    """Largest error of (dots, hist_sq, g_sq) against fp64, in units of
    eps * sum |terms| (the kernel passes when this is <= COHERENCE_C)."""
    h64, g64 = h.double(), g.double()
    want = (h64 @ g64, (h64 * h64).sum(-1), (g64 * g64).sum())
    scale = (h64.abs() @ g64.abs(), want[1], want[2])
    eps = torch.finfo(torch.float32).eps
    return max(float(((a.double() - w).abs() / (eps * sc).clamp(
        min=1e-300)).max()) for a, w, sc in zip(out, want, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048 * 4, 335_872, 1_003, 1])
@pytest.mark.parametrize("w", [1, 3, 8, 16, 17, 40])
def test_coherence_kernel_matches_fp64_and_replays(cuda_device, w, d):
    rng = np.random.default_rng(w)
    h = torch.from_numpy(rng.standard_normal((w, d)).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(
        cuda_device)
    before = tco.coherence_dots.launches
    got = tco.coherence_dots(h, g)
    again = tco.coherence_dots(h, g)
    torch.cuda.synchronize()
    assert tco.coherence_dots.launches == before + 2
    assert [tuple(x.shape) for x in got] == [(w,), (w,), ()]
    assert coherence_excess(got, h, g) <= COHERENCE_C
    assert coherence_excess(ref.coherence_dots(h, g), h, g) <= COHERENCE_C
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w,d", [(8, 335_872), (3, 1_003), (40, 2048 * 4)])
def test_coherence_kernel_replays_in_a_cuda_graph(cuda_device, w, d):
    """Four calls captured in one CUDA graph (each two programmatic
    dependent grids) and the graph replayed twice give the eager call's
    outputs bit for bit, and so does an eager call after the replays."""
    rng = np.random.default_rng(w + d)
    h = torch.from_numpy(rng.standard_normal((w, d)).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(
        cuda_device)
    want = [x.clone() for x in tco.coherence_dots(h, g)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tco.coherence_dots(h, g) for _ in range(4)]
    for _ in range(2):
        for out in outs:
            for x in out:
                x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for out in outs:
            for a, b in zip(out, want):
                assert torch.equal(a, b)
    for a, b in zip(tco.coherence_dots(h, g), want):   # eager again
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_coherence_kernel_back_to_back_shapes(cuda_device):
    """Calls on different shapes and grids, queued without a sync between
    them, each hold against fp64 and equal the same call made alone."""
    rng = np.random.default_rng(7)
    cases = [(8, 335_872), (1, 1_003), (17, 4096), (3, 1_000_003),
             (16, 335_872)]
    ops = [(torch.from_numpy(rng.standard_normal((w, d)).astype(np.float32))
            .to(cuda_device),
            torch.from_numpy(rng.standard_normal(d).astype(np.float32))
            .to(cuda_device)) for w, d in cases]
    alone = []
    for h, g in ops:
        alone.append(tco.coherence_dots(h, g))
        torch.cuda.synchronize()
    queued = [tco.coherence_dots(h, g) for h, g in ops]
    torch.cuda.synchronize()
    for (h, g), a, q in zip(ops, alone, queued):
        assert coherence_excess(q, h, g) <= COHERENCE_C
        for x, y in zip(a, q):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_coherence_dispatch_and_operand_checks(cuda_device):
    dispatch.reset_report()
    h = torch.randn(4, 4096, device=cuda_device)
    g = torch.randn(4096, device=cuda_device)
    before = tco.coherence_dots.launches
    dispatch.coherence_dots(h, g)
    assert tco.coherence_dots.launches == before + 1
    assert dispatch.report()["coherence_dots"] == "cuda"
    for bad_h, bad_g in ((h.double(), g), (h, g[:-1]), (h[:, ::2], g[::2]),
                         (h, g.cpu()), (h[:0], g)):
        with pytest.raises(ValueError):
            tco.coherence_dots(bad_h, bad_g)


@pytest.mark.cuda
def test_observe_with_the_kernel_matches_plain_on_the_card(cuda_device):
    """observe(kernels=True) on a block-padded ring against the plain
    three-op reduction, over a window filling and wrapping."""
    rng = np.random.default_rng(0)
    gs = rng.standard_normal((11, 3000)).astype(np.float32)
    st_k = tcoh.init_coherence(4096, 4, device=cuda_device)
    st_p = tcoh.init_coherence(3000, 4, device=cuda_device)
    for g in gs:
        g = torch.from_numpy(g).to(cuda_device)
        st_k, a = tcoh.observe(st_k, g, kernels=True)
        st_p, b = tcoh.observe(st_p, g, kernels=False)
        for key in ("mu", "cos_by_lag", "grad_norm"):
            torch.testing.assert_close(a[key], b[key], rtol=1e-5, atol=1e-6)


def _paged_case(dev, s=8, h=32, hkv=8, hd=80, t=8, tokens=37, layers=3,
                layer=2, pos=None, dtype=torch.float32, k_off=0, lazy=True,
                seed=0):
    """Random page pool and operands: slot 0 lazily allocated (its later
    page slots on the null page), the last slot empty (all null, position
    0); rings wrapped (pos > tokens) on some slots; ``k_off`` shifts the K
    block (and the V block after it) off any alignment."""
    rng = np.random.default_rng(seed)
    kvsz = hkv * hd
    pps = -(-tokens // t)
    n_pages = s * pps
    width = k_off + 2 * layers * kvsz + layers   # K blocks, V blocks, slot_pos
    pages = rng.standard_normal((n_pages + 1, t, width)).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(s, pps).astype(np.int32)
    if lazy:
        tables[0, pps // 2:] = n_pages
        tables[-1] = n_pages
    if pos is None:
        pos = rng.integers(0, 3 * tokens, s)
        pos[0], pos[-1] = min(pos[0], (pps // 2) * t - 1), 0
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    return dict(q=f(s, h, hd), k_new=f(s, hkv, hd), v_new=f(s, hkv, hd),
                pages=torch.from_numpy(pages).to(dev),
                tables=torch.from_numpy(tables).to(dev),
                pos=torch.from_numpy(np.asarray(pos, np.int32)).to(dev),
                layer=layer, kw=dict(k_off=k_off, v_off=k_off + layers * kvsz,
                                     kv_heads=hkv, head_dim=hd, tokens=tokens,
                                     page_tokens=t))


def _paged_args(c):
    return (c["q"], c["k_new"], c["v_new"], c["pages"], c["tables"],
            c["pos"], c["layer"])


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(32, 8, 80), (32, 32, 128), (40, 8, 128),
                                   (6, 3, 40)])
@pytest.mark.parametrize("t,tokens", [(8, 64), (16, 64), (8, 37)])
@pytest.mark.parametrize("window", [0, 16, 4096])
def test_paged_attention_kernel_matches_plain(cuda_device, heads, t, tokens,
                                              window):
    """fp32 operands at the danube, deepseek-7b and qwen3-14b head shapes
    and an odd width (Hkv 3, hd 40), with wrapped rings, null pages, T not
    dividing the ring and K/V blocks at an unaligned offset."""
    h, hkv, hd = heads
    c = _paged_case(cuda_device, h=h, hkv=hkv, hd=hd, t=t, tokens=tokens,
                    k_off=3 if hkv == 3 else 0, seed=t + tokens + window)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*_paged_args(c), window=window, **c["kw"])
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    want = ref.paged_attention(*_paged_args(c), window=window, **c["kw"])
    torch.testing.assert_close(got, want, **TOL_PAGED)
    again = tpa.paged_attention(*_paged_args(c), window=window, **c["kw"])
    assert torch.equal(got, again)        # fixed order, no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 16])
def test_paged_attention_kernel_bf16(cuda_device, window):
    """bf16 q/k_new/v_new (the full-width cache dtype): the kernel reads the
    fp32 pages and runs in fp32, so it equals the plain version on the
    upcast operands up to one bf16 rounding of the output (one ulp, at most
    2^-7 relative); the plain
    version on the bf16 operands (the JAX oracle's numerics) rounds the
    gathered K/V and the probabilities to bf16 first, which moves outputs
    of size O(1) by at most a few bf16 ulps (2^-8 each)."""
    c = _paged_case(cuda_device, dtype=torch.bfloat16, seed=5 + window)
    got = tpa.paged_attention(*_paged_args(c), window=window, **c["kw"])
    assert got.dtype == torch.bfloat16
    up = dict(c, q=c["q"].float(), k_new=c["k_new"].float(),
              v_new=c["v_new"].float())
    want32 = ref.paged_attention(*_paged_args(up), window=window, **c["kw"])
    torch.testing.assert_close(got.float(), want32, rtol=2 ** -7, atol=1e-5)
    want = ref.paged_attention(*_paged_args(c), window=window, **c["kw"])
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,tokens,layers", [((8, 8, 64), 448, 6),
                                                 ((32, 8, 128), 160, 40)])
def test_paged_attention_cross_family_heads(cuda_device, heads, tokens,
                                            layers, dtype):
    """The self-attention head shapes of whisper-base (8/8/64, GQA group 1)
    and llama-3.2-vision-11b (32/8/128) at their serves' ring lengths and
    depths, last layer's columns, 8 slots with wrapped rings, a lazy and an
    empty slot: fp32 within TOL_PAGED of the plain version, bf16 within one
    output rounding of the plain version on the upcast operands; two calls
    bitwise."""
    h, hkv, hd = heads
    c = _paged_case(cuda_device, h=h, hkv=hkv, hd=hd, t=8, tokens=tokens,
                    layers=layers, layer=layers - 1, dtype=dtype,
                    seed=tokens + layers)
    assert int(c["pos"].max()) >= tokens            # a wrapped ring
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*_paged_args(c), **c["kw"])
    assert tpa.paged_attention.launches == before + 1
    assert got.dtype == dtype
    up = dict(c, q=c["q"].float(), k_new=c["k_new"].float(),
              v_new=c["v_new"].float())
    want = ref.paged_attention(*_paged_args(up), **c["kw"])
    tol = TOL_PAGED if dtype == torch.float32 else dict(rtol=2 ** -7,
                                                         atol=1e-5)
    torch.testing.assert_close(got.float(), want, **tol)
    assert torch.equal(got, tpa.paged_attention(*_paged_args(c), **c["kw"]))


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [None, 1, 3, 200])
@pytest.mark.parametrize("heads", [(32, 8, 80), (40, 8, 128), (6, 3, 40)])
def test_paged_attention_split_counts_and_empty_chunks(cuda_device, heads,
                                                       n_split, monkeypatch):
    """The split-KV kernel at the chooser's count, one chunk, a few, and
    more chunks than any slot has rows (most chunks empty; a count other
    than the chooser's is forced by replacing it). Slot 1 sits at position
    0, slot 2 holds only null pages at a position past its ring (every
    chunk all null), slot 3's ring has wrapped; two calls bitwise."""
    if n_split is not None:
        monkeypatch.setattr(tpa, "choose_split", lambda *a: n_split)
    h, hkv, hd = heads
    c = _paged_case(cuda_device, h=h, hkv=hkv, hd=hd, t=8, tokens=64,
                    k_off=3 if hkv == 3 else 0, seed=hd + (n_split or 0))
    pos = c["pos"].cpu().numpy()
    pos[1], pos[2], pos[3] = 0, 150, 141
    c["pos"] = torch.from_numpy(pos).to(cuda_device)
    tables = c["tables"].clone()
    tables[2] = c["pages"].shape[0] - 1
    c["tables"] = tables
    for window in (0, 16):
        got = tpa.paged_attention(*_paged_args(c), window=window, **c["kw"])
        want = ref.paged_attention(*_paged_args(c), window=window, **c["kw"])
        torch.testing.assert_close(got, want, **TOL_PAGED)
        again = tpa.paged_attention(*_paged_args(c), window=window, **c["kw"])
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_paged_attention_dispatch_routes_cuda(cuda_device):
    dispatch.reset_report()
    c = _paged_case(cuda_device, h=4, hkv=1, hd=32, t=4, tokens=24)
    before = tpa.paged_attention.launches
    dispatch.paged_attention(*_paged_args(c), window=16, **c["kw"])
    assert tpa.paged_attention.launches == before + 1
    assert dispatch.report()["paged_attention"] == "cuda"


def _flash_case(dev, b, sq, sk, h, hkv, hd, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    return f(b, sq, h, hd), f(b, sk, hkv, hd), f(b, sk, hkv, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(32, 8, 80), (32, 32, 128), (40, 8, 128),
                                   (6, 3, 17), (4, 1, 256)])
@pytest.mark.parametrize("sq,sk", [(128, 128), (1, 300), (17, 77),
                                   (100, 260), (64, 64 + 31)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_attention_kernel_matches_plain(cuda_device, heads, sq, sk,
                                              causal, window):
    """fp32 at the danube, deepseek-7b and qwen3-14b head shapes, an odd
    head width and the widest; right-aligned q, Sk not a multiple of the
    32-key tile, a window that bites, and no mask at all."""
    h, hkv, hd = heads
    q, k, v = _flash_case(cuda_device, 2, sq, sk, h, hkv, hd,
                          seed=sq + sk + hd + window)
    before = tfl.flash_attention.launches
    got = tfl.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **TOL_FLASH)
    again = tfl.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)        # fixed order, no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 40])
def test_flash_attention_kernel_bf16(cuda_device, window):
    """bf16 operands: the kernel computes in fp32 from the same bf16 values
    the plain version upcasts, so the two differ by at most one bf16
    rounding of the output (one ulp, 2^-7 relative at most)."""
    q, k, v = _flash_case(cuda_device, 2, 96, 160, 32, 8, 80,
                          dtype=torch.bfloat16, seed=9 + window)
    got = tfl.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    want32 = ref.flash_attention(q.float(), k.float(), v.float(),
                                 causal=True, window=window)
    torch.testing.assert_close(got.float(), want32, rtol=2 ** -7, atol=1e-5)
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(8, 2, 64), (32, 8, 80), (40, 8, 128),
                                   (4, 4, 128), (6, 3, 17), (4, 1, 256)])
@pytest.mark.parametrize("sq,sk,window", [(100, 200, 0), (1, 300, 0),
                                          (77, 77, 0), (130, 190, 40),
                                          (64, 64 + 31, 0)])
def test_flash_attention_tensor_cores_bf16(cuda_device, heads, sq, sk,
                                           window):
    """The bf16 tensor-core kernel: Sq and Sk off the 64-row tile, Sq = 1,
    a window that bites, odd and wide head widths, and a bitwise replay.
    Against the plain version on the same bf16 values: one bf16 rounding
    of the output."""
    h, hkv, hd = heads
    q, k, v = _flash_case(cuda_device, 2, sq, sk, h, hkv, hd,
                          dtype=torch.bfloat16, seed=sq + sk + hd + window)
    got = tfl.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)
    again = tfl.flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(got, again)
    if sq == sk:
        got = tfl.flash_attention(q, k, v, causal=False)
        want = ref.flash_attention(q, k, v, causal=False)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_dispatch_and_operand_checks(cuda_device):
    dispatch.reset_report()
    q, k, v = _flash_case(cuda_device, 1, 40, 70, 4, 2, 32)
    before = tfl.flash_attention.launches
    dispatch.flash_attention(q, k, v, causal=True, window=16)
    assert tfl.flash_attention.launches == before + 1
    assert dispatch.report()["flash_attention"].startswith("cuda")
    with pytest.raises(ValueError, match="Sq=70 > Sk=40"):
        tfl.flash_attention(k.repeat(1, 1, 2, 1), q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="one dtype"):
        tfl.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        tfl.flash_attention(*_flash_case(cuda_device, 1, 4, 4, 2, 1, 257))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.flash_attention(q, k.cpu(), v)


# -- the paper's models on the card (no kernel of their own; their layouts
#    and determinism) ------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# cuDNN may pick other algorithms for the grouped convolution than for P
# separate ones (implicit GEMM, Winograd, FFT), and they round differently:
# ~1e-6 relative a layer, 8 convolutions deep in the forward pass and the
# backward pass's chain through 7 GroupNorms. Held in relative L2 per
# output and per gradient leaf.
RESNET_CARD_REL = 1e-4


@pytest.mark.cuda
def test_resnet_grouped_conv_equals_per_worker_loop_on_card(cuda_device):
    from repro_torch import treemath as tm
    from repro_torch.models import resnet
    from repro_torch.optim.optimizers import value_and_grad

    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.ResNetConfig(n=1)
    params, strides = resnet.init(0, cfg, device=cuda_device)
    p = 4
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    stacked = tm.tree_map(
        lambda a: a.unsqueeze(0) * (1 + 0.1 * torch.rand(
            (p,) + (1,) * a.dim(), generator=gen, device=cuda_device)),
        params)
    x = torch.randn((p, 8, 32, 32, 3), generator=gen, device=cuda_device)
    y = torch.randint(0, 10, (p, 8), generator=gen, device=cuda_device)
    loss = resnet.make_loss_fn(cfg, strides)
    got, g = value_and_grad(loss, stacked, (x, y))
    logits = resnet.apply(stacked, strides, x, cfg)
    for i in range(p):
        one = tm.tree_index(stacked, i)
        want, gi = value_and_grad(loss, one, (x[i], y[i]))
        assert _rel(got[i], want) <= RESNET_CARD_REL
        assert _rel(logits[i], resnet.apply(one, strides, x[i], cfg)) <= (
            RESNET_CARD_REL)
        for a, b in zip(tm.tree_leaves(g), tm.tree_leaves(gi)):
            assert _rel(a[i], b) <= RESNET_CARD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [7, 32])
def test_resnet_same_padding_on_card_matches_cpu(cuda_device, hw):
    from repro_torch.models import resnet

    rng = np.random.default_rng(hw)
    h = torch.from_numpy(rng.standard_normal((2, 6, hw, hw)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 3, 3, 3, 4)).astype(
        np.float32))
    for stride in (1, 2):
        want = resnet._conv(h, w, stride)
        got = resnet._conv(h.to(cuda_device), w.to(cuda_device), stride)
        assert got.shape == want.shape == (2, 8, -(-hw // stride),
                                           -(-hw // stride))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_mf_gradient_is_bitwise_deterministic_on_card(cuda_device):
    """Repeated rows in a batch: the one-hot product's backward sums them
    in a fixed order, so two calls agree bit for bit."""
    from repro_torch.models import mf
    from repro_torch.optim.optimizers import value_and_grad

    cfg = mf.MFConfig(num_users=6040, num_items=3706)
    params = mf.init(0, cfg, device=cuda_device)
    stacked = {k: v.unsqueeze(0).repeat(8, 1, 1) for k, v in params.items()}
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    rows = torch.randint(0, 60, (8, 500), generator=gen, device=cuda_device)
    cols = torch.randint(0, 40, (8, 500), generator=gen, device=cuda_device)
    vals = torch.randn((8, 500), generator=gen, device=cuda_device)
    first = value_and_grad(mf.make_loss_fn(cfg), stacked, (rows, cols, vals))
    for _ in range(3):
        again = value_and_grad(mf.make_loss_fn(cfg), stacked,
                               (rows, cols, vals))
        assert torch.equal(first[0], again[0])
        for key in ("L", "R"):
            assert torch.equal(first[1][key], again[1][key])


# The state-space families on the card against the CPU: fp32 (TF32 off),
# the same math in another summation order, so outputs within rtol 1e-4,
# atol 1e-4 of the CPU's (the SSD's exponentials and chunk carries over a
# few layers; the parity tests hold the CPU route against the JAX package).
SSM_CARD_TOL = dict(rtol=1e-4, atol=1e-4)


def _on(tree, dev):
    from repro_torch import treemath as tm
    return tm.tree_map(lambda x: x.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 13, 40])
def test_ssd_block_on_card_matches_cpu(cuda_device, t):
    """mamba_forward (the chunked scan, or the T = 1 recurrence) from a
    cache, on the card and on the CPU; and a finite gradient at 64 heads,
    chunk 256 (the masked-before-exp decay)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm

    cfg = ssm.SSMSettings(d_model=32, d_state=8, head_dim=8, chunk=16)
    p, _ = L.unzip(ssm.init_mamba_block(torch.Generator().manual_seed(0),
                                        cfg, device="cpu"))
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, 9 + t, 32)).astype(
        np.float32))
    _, cache = ssm.mamba_forward(p, x[:, :9], cfg)
    want, wcache = ssm.mamba_forward(p, x[:, 9:], cfg, cache=cache)
    got, gcache = ssm.mamba_forward(_on(p, cuda_device),
                                    x[:, 9:].to(cuda_device), cfg,
                                    cache=_on(cache, cuda_device))
    torch.testing.assert_close(got.cpu(), want, **SSM_CARD_TOL)
    for k in wcache:
        torch.testing.assert_close(gcache[k].cpu(), wcache[k], **SSM_CARD_TOL)

    wide = ssm.SSMSettings(d_model=64, d_state=16, head_dim=2, chunk=256)
    pw, _ = L.unzip(ssm.init_mamba_block(
        torch.Generator(device=cuda_device).manual_seed(1), wide,
        device=cuda_device))
    for v in pw.values():
        v.requires_grad_(True)
    xw = torch.randn((1, 256, 64), device=cuda_device)
    y, _ = ssm.mamba_forward(pw, xw, wide)
    grads = torch.autograd.grad(y.square().sum(), list(pw.values()))
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
def test_hybrid_forward_and_decode_on_card_match_cpu(cuda_device):
    """The reduced zamba2-7b at 5 layers (a tail layer): forward with its
    prefill cache, then two decode steps, on the card and on the CPU."""
    from repro_torch import configs as tcfg
    from repro_torch import treemath as tm

    api = tcfg.get("zamba2-7b").api(reduced=True,
                                    overrides={"num_layers": 5})
    params, _ = api.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 500, (2, 19)).astype(np.int32))
    with torch.no_grad():
        want, wcache = api.prefill(params, {"tokens": toks})
        got, gcache = api.prefill(_on(params, cuda_device),
                                  {"tokens": toks.to(cuda_device)})
        torch.testing.assert_close(got.cpu(), want, **SSM_CARD_TOL)
        for pos in (19, 20):
            tok = torch.full((2, 1), pos, dtype=torch.int32)
            want, wcache = api.decode(params, tok, wcache, pos)
            got, gcache = api.decode(_on(params, cuda_device),
                                     tok.to(cuda_device), gcache, pos)
            torch.testing.assert_close(got.cpu(), want, **SSM_CARD_TOL)
    for a, b in zip(tm.tree_leaves(gcache), tm.tree_leaves(wcache)):
        torch.testing.assert_close(a.cpu(), b, **SSM_CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_contract_f32_on_card_matches_fp32_product(cuda_device, n):
    """``layers.contract_f32`` of bf16 operands on the card (the tensor
    cores' fp32 result, its own backward) against both operands cast to
    fp32 first: forward and both gradients, within the fp32
    accumulation's reordering."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(3, 64, 4, 32, generator=gen, device=cuda_device)
    w = torch.randn(4, 32, 48, generator=gen, device=cuda_device)
    if n == 1:
        a, w = a.reshape(3, 64, 128), w.reshape(128, 48)
    a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    g = torch.randn(3, 64, 48, generator=gen, device=cuda_device).to(
        torch.bfloat16).float()
    got, want = [], []
    for fn, into in ((lambda x, y: L.contract_f32(x, y, n), got),
                     (lambda x, y: torch.tensordot(x.float(), y.float(), n),
                      want)):
        x, y = (v.clone().requires_grad_(True) for v in (a, w))
        out = fn(x, y)
        out.backward(g)
        into += [out.detach(), x.grad.float(), y.grad.float()]
    assert got[0].dtype == torch.float32
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    # The gradients round to bf16 once, from sums in another order.
    for u, v in zip(got[1:], want[1:]):
        torch.testing.assert_close(u, v, rtol=2 ** -7, atol=1e-2)
