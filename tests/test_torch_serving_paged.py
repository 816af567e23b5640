"""The port's paged serve plane (twin of ``tests/test_serving_paged.py``):
route resolution (off/auto/on), the paged route against the gather route
(greedy and sampled, and on a wrapped ring without a window), lazy allocation serving ``max_seq`` past the gathered
pool capacity, batched prefill admission in power-of-two chunks, the fp32
page-packing int-leaf guard and the packed row's column offsets.

On the CPU the paged route runs the plain ``paged_attention`` (the CUDA
kernel runs on the card: ``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.engine.plan import resolve_serve_paged
from repro_torch.kernels import dispatch
from repro_torch.serving import (PagedDecodeCache, Server, ServingConfig,
                                 build_layout, synthetic_requests)

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

ARCH = "deepseek-7b"       # reduced: 2-layer fp32 transformer, vocab 512
MAX_SEQ, PAGE_TOKENS, PROMPT = 24, 4, 8


def make_server(arch=ARCH, **kw):
    base = dict(arch=arch, reduced=True, slots=2, prompt_len=PROMPT,
                max_seq=MAX_SEQ, page_tokens=PAGE_TOKENS, temperature=0.0,
                seed=0, virtual_dt=0.01)
    base.update(kw)
    return Server(ServingConfig(**base), device="cpu")


def _served(server, n=2, gens=(5, 9), seed=3):
    reqs = synthetic_requests(n, PROMPT, 1, server.api.vocab_real, seed=seed)
    for r, g in zip(reqs, gens):
        r.max_new_tokens = g
    rep = server.run(reqs)
    return {r.rid: r.tokens for r in rep.completed}, rep


# -- route resolution --------------------------------------------------------

def test_route_resolution_tri_state():
    assert make_server(paged="auto").paged_route == "paged"
    assert make_server(paged="on").paged_route == "paged"
    srv = make_server(paged="off")
    assert srv.paged_route == "gather"
    assert srv.dispatch_report()["why"] == "config off"
    with pytest.raises(ValueError, match="off/auto/on"):
        make_server(paged="maybe")


def test_route_resolution_without_decode_paged():
    """A family without decode_paged takes the gather route under auto and
    refuses "on"; the FSDP placement vetoes the paged route as the JAX
    package's ``kernel_placement_ok`` does, even with no mesh: "auto"
    takes the gather route, "on" raises (``tests/test_serving_paged.py``)."""
    api = tcfg.get(ARCH).api(reduced=True)
    layout = build_layout(api, MAX_SEQ, PAGE_TOKENS, device="cpu")
    import dataclasses
    bare = dataclasses.replace(api, decode_paged=None)
    route, why = resolve_serve_paged(bare, layout, paged="auto")
    assert route == "gather" and "decode_paged" in why
    with pytest.raises(ValueError, match="decode_paged"):
        resolve_serve_paged(bare, layout, paged="on")
    fsdp = tcfg.get("deepseek-67b")
    lay = build_layout(fsdp.api(reduced=True), MAX_SEQ, PAGE_TOKENS,
                       device="cpu")
    assert resolve_serve_paged(fsdp.api(reduced=True), lay, fsdp, None,
                               "auto") == ("gather", "FSDP placement")
    with pytest.raises(ValueError, match="vetoed by placement"):
        resolve_serve_paged(fsdp.api(reduced=True), lay, fsdp, None, "on")
    assert make_server("deepseek-67b").paged_route == "gather"


# -- paged vs gather equivalence ---------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-7b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_paged_matches_gather(arch, temperature):
    """The same request stream through both routes: token for token,
    greedy AND sampled (both routes draw one [slots, vocab] block of
    uniforms per step from the server's generator)."""
    out = {}
    for mode in ("on", "off"):
        srv = make_server(arch=arch, paged=mode, temperature=temperature)
        out[mode], rep = _served(srv)
        assert len(rep.completed) == 2
    assert out["on"] == out["off"]
    if temperature:
        greedy, _ = _served(make_server(arch=arch, paged="on"))
        assert out["on"] != greedy       # the draws change the tokens


def test_paged_matches_gather_on_wrapped_ring():
    """deepseek-7b has no window: with a ring as long as the prompt every
    decode step reads a wrapped ring, whose cursor row holds position
    pos - PROMPT, which the paged route drops as the gather route's
    overwrite does (a route that kept it would change these tokens)."""
    out = {}
    for mode in ("on", "off"):
        srv = make_server(paged=mode, max_seq=PROMPT)
        assert srv.layout.tokens == PROMPT and not srv.api.cfg.swa_window
        out[mode], _ = _served(srv)
    assert out["on"] == out["off"]


def test_greedy_pinned_under_paged_on():
    dispatch.reset_report()
    a, rep_a = _served(make_server(paged="on"))
    b, rep_b = _served(make_server(paged="on"))
    assert a == b
    assert [len(t) for _, t in sorted(a.items())] == [5, 9]
    assert rep_a.decode_steps == rep_b.decode_steps
    assert dispatch.report()["paged_attention"].startswith("ref")


# -- lazy allocation / overcommit --------------------------------------------

def test_overcommit_serves_beyond_gathered_capacity():
    """max_seq=64 needs 16 pages per gathered slot (32 for the pool); the
    lazy paged route serves both slots on 8 in all because requests claim
    only the pages their prompt + budget touch."""
    kw = dict(max_seq=64, num_pages=8)
    srv = make_server(paged="on", **kw)
    assert srv.cache.num_pages < srv.cfg.slots * srv.layout.pages_per_slot
    served, _ = _served(srv, gens=(4, 6))
    assert sorted(len(t) for t in served.values()) == [4, 6]
    assert srv.cache.free_pages == srv.cache.num_pages
    # and the tokens are the gather route's on a full pool
    ref, _ = _served(make_server(paged="off", max_seq=64), gens=(4, 6))
    assert served == ref
    with pytest.raises(ValueError, match="cannot hold one slot"):
        make_server(paged="off", **kw)


def test_eager_pool_rejects_undercommit():
    layout = build_layout(tcfg.get(ARCH).api(reduced=True), MAX_SEQ,
                          PAGE_TOKENS, device="cpu")
    pps = layout.pages_per_slot
    with pytest.raises(ValueError):
        PagedDecodeCache(layout, slots=1, num_pages=pps - 1)
    assert PagedDecodeCache(layout, slots=1, num_pages=pps - 1,
                            lazy=True).num_pages == pps - 1
    with pytest.raises(ValueError):
        PagedDecodeCache(layout, slots=1, num_pages=0, lazy=True)


# -- batched prefill admission -----------------------------------------------

def test_batched_admission_equivalence_and_fewer_prefills():
    def serve(pfb):
        srv = make_server(slots=4, prefill_batch=pfb)
        rep = srv.run(synthetic_requests(4, PROMPT, 3, 500, seed=9))
        return {r.rid: r.tokens for r in rep.completed}, rep

    one, rep1 = serve(1)
    four, rep4 = serve(4)
    assert one == four and len(one) == 4
    assert rep1.prefill_calls == 4 and rep4.prefill_calls == 1
    assert rep4.phase_s["prefill"] > 0.0


def test_admission_chunks_to_powers_of_two():
    """slots=4, prefill_batch=3: a 4-burst admits as 2+2."""
    srv = make_server(slots=4, prefill_batch=3)
    rep = srv.run(synthetic_requests(4, PROMPT, 2, 500, seed=9))
    assert len(rep.completed) == 4 and rep.joins == 4
    assert rep.prefill_calls == 2
    assert (PROMPT, 2) in srv._prefill_plans
    assert (PROMPT, 3) not in srv._prefill_plans


# -- the fp32 page-packing int guard / column offsets ------------------------

class _FakeAPI:
    """init_cache surface for build_layout: one int token-id ring leaf and
    one K/V-like float leaf."""

    def __init__(self, vocab):
        self.vocab_real = vocab

    def init_cache(self, batch, seq, device=None):
        return ({"tok": torch.zeros((batch, seq), dtype=torch.int32,
                                    device=device),
                 "k": torch.zeros((2, batch, seq, 2, 8), device=device)},
                None)


def test_int_leaf_guard_at_build_layout():
    with pytest.raises(ValueError, match="2\\^24"):
        build_layout(_FakeAPI(1 << 24), MAX_SEQ, PAGE_TOKENS, device="cpu")
    lay = build_layout(_FakeAPI((1 << 24) - 1), MAX_SEQ, PAGE_TOKENS,
                       device="cpu")
    assert lay.has_tokens and lay.tokens == MAX_SEQ


@pytest.mark.parametrize("arch", ["deepseek-7b", "h2o-danube-1.8b",
                                  "qwen3-14b"])
def test_leaf_views_put_kv_blocks_first(arch):
    api = tcfg.get(arch).api(reduced=True)
    lay = build_layout(api, MAX_SEQ, PAGE_TOKENS, device="cpu")
    views = {n: (off, shape) for n, off, shape in lay.leaf_views}
    cfg = api.cfg
    kvsz = cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
    assert views["k"] == (0, (cfg.num_layers, 1, cfg.num_kv_heads,
                              cfg.head_dim))
    assert views["v"][0] == kvsz
    assert views["slot_pos"][0] == 2 * kvsz and lay.width == 2 * kvsz + \
        cfg.num_layers
    assert lay.tokens == min(MAX_SEQ, cfg.swa_window or MAX_SEQ)
    assert lay.pages_per_slot == -(-lay.tokens // PAGE_TOKENS)
    assert lay.empty_rows.shape == (lay.tokens, lay.width)
    # empty rows: zero K/V, slot_pos -1 (as floats)
    assert torch.equal(lay.empty_rows[:, 2 * kvsz:],
                       torch.full((lay.tokens, cfg.num_layers), -1.0))
    assert float(lay.empty_rows[:, :2 * kvsz].abs().max()) == 0.0
    assert np.prod(views["k"][1]) == kvsz
