"""Port parity: ``repro_torch.serving`` against ``repro.serving``.

Layout detection, ``leaf_views`` and ``tok_order`` against the JAX layout;
pack round trips (and the packed rows equal JAX's); page alloc, free, LIFO
reuse and exhaustion in lockstep with the JAX cache; the queue and batcher
against JAX's on the same inputs; the served greedy tokens of the port's
server equal the JAX server's on shared params, on both routes, with equal
join/evict/decode-step/prefill-call counts; deadline eviction; and snapshot
refresh from checkpoints the JAX package wrote.

Reduced ``deepseek-7b`` (2 layers, fp32, vocab 512), 2 slots, prompts of 8,
``max_seq`` 24, 4 rows a page, a virtual clock, as in the JAX package's
serving tests.

Greedy token equality is only as strong as the margins behind it: along
JAX's served trajectory every step's logits are compared (max |port - jax|
<= 1e-5 x max |jax|) and the JAX top-2 margin is asserted above 100x that
tolerance, so a near-tie fails loudly here instead of flipping a token.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import serving as js
from repro.checkpoint import checkpoint as jckpt
from repro_torch import configs as tcfg
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch import serving as ts
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

ARCH = "deepseek-7b"
MAX_SEQ, PAGE_TOKENS, PROMPT = 24, 4, 8
REL = 1e-5
GENS = (5, 9, 7, 3, 6)
ARRIVALS = (0.0, 0.0, 0.02, 0.03, 0.05)


@pytest.fixture(scope="module")
def apis():
    return jcfg.get(ARCH).api(reduced=True), tcfg.get(ARCH).api(reduced=True)


@pytest.fixture(scope="module")
def layouts(apis):
    japi, tapi = apis
    return (js.build_layout(japi, MAX_SEQ, PAGE_TOKENS),
            ts.build_layout(tapi, MAX_SEQ, PAGE_TOKENS, device="cpu"))


@pytest.fixture(scope="module")
def params(apis):
    jp, _ = apis[0].init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _cfg(mod, **kw):
    base = dict(arch=ARCH, reduced=True, slots=2, prompt_len=PROMPT,
                max_seq=MAX_SEQ, page_tokens=PAGE_TOKENS, temperature=0.0,
                seed=0, virtual_dt=0.01)
    base.update(kw)
    return mod.ServingConfig(**base)


def _requests(mod, n=5, seed=3):
    reqs = mod.synthetic_requests(n, PROMPT, 1, 500, arrivals=ARRIVALS[:n],
                                  seed=seed)
    for r, g in zip(reqs, GENS):
        r.max_new_tokens = g
    return reqs


def _filled_cache(api, seed=0):
    """init_cache(1, MAX_SEQ) leaves filled with distinct numpy values."""
    rng = np.random.default_rng(seed)
    cache = api.init_cache(1, MAX_SEQ)[0]
    return jax.tree.map(
        lambda x: (rng.integers(-1, 1000, x.shape).astype(np.int32)
                   if jnp.issubdtype(x.dtype, jnp.integer)
                   else rng.standard_normal(x.shape).astype(np.float32)),
        cache)


# -- layout / packing --------------------------------------------------------

def test_layout_matches_jax(layouts):
    jl, tl = layouts
    for f in ("token_axes", "batch_axes", "tok_order", "leaf_views", "tokens",
              "page_tokens", "pages_per_slot", "width", "res_width"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.has_tokens and tl.tokens == MAX_SEQ
    np.testing.assert_array_equal(tl.empty_rows.numpy(),
                                  np.asarray(jl.empty_rows))
    views = {n: (off, shape) for n, off, shape in tl.leaf_views}
    kvsz = int(np.prod(views["k"][1]))
    assert views["k"][0] == 0 and views["v"][0] == kvsz
    assert views["slot_pos"][0] == 2 * kvsz        # small leaves trail


def test_pack_roundtrip_matches_jax(layouts):
    jl, tl = layouts
    japi = jcfg.get(ARCH).api(reduced=True)
    caches = [_filled_cache(japi, seed=s) for s in (1, 2)]
    for c in caches:
        jrows, jres = jl.pack_rows(jax.tree.map(jnp.asarray, c))
        tcache = params_from_jax(c, device="cpu")
        rows, res = tl.pack_rows(tcache)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        back = tl.unpack_slots(rows, res, lead=0)
        for a, b in zip(tm.tree_leaves(tcache), tm.tree_leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    stacked = tm.tree_stack([params_from_jax(c, device="cpu") for c in caches])
    rows, res = tl.pack_rows(stacked, lead=1)
    assert tuple(rows.shape) == (2, tl.tokens, tl.width)
    back = tl.unpack_slots(rows, res, lead=1)
    for a, b in zip(tm.tree_leaves(stacked), tm.tree_leaves(back)):
        assert torch.equal(a, b)


# -- page accounting ---------------------------------------------------------

def test_page_alloc_free_reuse_in_lockstep(layouts):
    jl, tl = layouts
    pps = tl.pages_per_slot
    jc, tc = js.PagedDecodeCache(jl, slots=2), ts.PagedDecodeCache(tl, slots=2)
    assert tc.num_pages == jc.num_pages == 2 * pps
    for op, slot in (("alloc", 0), ("alloc", 1), ("free", 0), ("alloc", 0),
                     ("free", 1), ("free", 0)):
        assert getattr(tc, op)(slot) == getattr(jc, op)(slot)
        np.testing.assert_array_equal(tc.tables, jc.tables)
        assert tc.free_list == jc.free_list
    got0 = tc.alloc(0)
    tc.alloc(1)
    assert not tc.can_alloc() and tc.free_pages == 0
    with pytest.raises(ValueError):
        tc.alloc(0)                       # double alloc
    freed = tc.free(0)
    assert sorted(freed) == sorted(got0)
    assert (tc.tables[0] == tc.null_page).all()
    got = tc.alloc(0)
    assert got[0] == freed[-1]            # LIFO reuse


def test_page_pool_exhaustion(layouts):
    tl = layouts[1]
    pps = tl.pages_per_slot
    cache = ts.PagedDecodeCache(tl, slots=2, num_pages=pps)
    cache.alloc(0)
    assert not cache.can_alloc()
    with pytest.raises(ValueError):
        cache.alloc(1)
    with pytest.raises(ValueError):
        ts.PagedDecodeCache(tl, slots=1, num_pages=pps - 1)


# -- queue / batcher against JAX's -------------------------------------------

def test_queue_matches_jax():
    def run(mod):
        reqs = [mod.Request(rid=i, prompt=np.zeros(4, np.int32),
                            max_new_tokens=2, arrival_s=t, deadline_s=dl)
                for i, (t, dl) in enumerate([(0.5, None), (0.0, 0.2),
                                             (1.0, 5.0), (0.2, 0.25)])]
        q = mod.AdmissionQueue(reqs)
        log = [getattr(q.pop_ready(0.0), "rid", None),
               getattr(q.pop_ready(0.0), "rid", None)]
        q.push_front(reqs[1])
        log.append([r.rid for r in q.expire(0.3)])
        log += [getattr(q.pop_ready(0.6), "rid", None), len(q),
                q.next_arrival()]
        arr = (mod.poisson_arrivals(5, 3.0, seed=2),
               mod.burst_arrivals(5, 2, 0.5), mod.uniform_arrivals(3, 0.1))
        syn = [(r.rid, r.prompt.tolist(), r.arrival_s, r.deadline_s)
               for r in mod.synthetic_requests(3, 6, 4, 500, arrivals=arr[2],
                                               deadline_slack_s=1.0, seed=4)]
        return log, arr, syn
    assert run(ts) == run(js)


def test_batcher_matches_jax():
    def run(mod):
        b = mod.ContinuousBatcher(3)
        r = mod.Request(rid=5, prompt=np.zeros(4, np.int32), max_new_tokens=3)
        b.join(1, mod.SlotState(request=r, next_token=42, pos=7, remaining=2,
                                join_s=0.0, ttft_s=0.0, tokens=[42]))
        arrays = [a.tolist() for a in b.arrays()]
        with pytest.raises(ValueError):
            b.join(1, mod.SlotState(request=r, next_token=0, pos=0,
                                    remaining=1, join_s=0.0, ttft_s=0.0))
        rid = b.evict(1).request.rid
        return arrays, rid, b.free_slot(), b.joins, b.evicts, b.any_active
    assert run(ts) == run(js)


# -- end-to-end: the port's server against the JAX server --------------------

def _serve_pair(params, paged, **kw):
    jp, tp = params
    jsrv = js.Server(_cfg(js, paged=paged, **kw), params=jp)
    tsrv = ts.Server(_cfg(ts, paged=paged, **kw), params=tp, device="cpu")
    return jsrv, jsrv.run(_requests(js)), tsrv, tsrv.run(_requests(ts))


def _tokens(rep):
    return {r.rid: r.tokens for r in rep.completed}


@pytest.mark.parametrize("paged", ["on", "off"])
def test_served_tokens_equal_jax(params, paged):
    jsrv, jrep, tsrv, trep = _serve_pair(params, paged)
    assert tsrv.paged_route == jsrv.paged_route
    assert _tokens(trep) == _tokens(jrep)
    assert [len(t) for _, t in sorted(_tokens(trep).items())] == list(GENS)
    for f in ("decode_steps", "joins", "evicts", "prefill_calls"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.joins == 5 > tsrv.cfg.slots        # slots were recycled
    assert tsrv.cache.free_pages == tsrv.cache.num_pages
    assert (tsrv.cache.tables == tsrv.cache.null_page).all()


def test_fsdp_arch_served_tokens_equal_jax():
    """Reduced deepseek-67b, an FSDP arch (``embed`` on data on a mesh;
    its placement vetoes the paged route in both packages, so both serve
    it on the gather route): the port's greedy tokens and counts equal the
    JAX server's on the same params. ``test_torch_mesh_engine.py`` holds
    the port's 2x1 serve on its data blocks to this one process bit for
    bit."""
    arch = "deepseek-67b"
    jp, _ = jcfg.get(arch).api(reduced=True).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jsrv, jrep, tsrv, trep = _serve_pair((jp, tp), "auto", arch=arch)
    assert tsrv.paged_route == jsrv.paged_route == "gather"
    assert _tokens(trep) == _tokens(jrep)
    for f in ("decode_steps", "joins", "evicts", "prefill_calls"):
        assert getattr(trep, f) == getattr(jrep, f), f


def test_logits_along_jax_trajectory_have_margin(apis, params):
    """Each served request replayed through both packages' prefill + decode
    on JAX's served tokens: logits agree within REL and the JAX top-2
    margin clears 100 x that tolerance at every step."""
    japi, tapi = apis
    jp, tp = params
    jsrv = js.Server(_cfg(js, paged="on"), params=jp)
    reqs = _requests(js)
    served = _tokens(jsrv.run(reqs))
    jprefill, jdecode = jax.jit(japi.prefill), jax.jit(japi.decode)
    margins = []
    for r in reqs:
        toks = served[r.rid]
        jl, jc = jprefill(jp, {"tokens": jnp.asarray(r.prompt[None])})
        tl, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(r.prompt[None])})
        jc = jax.tree.map(
            lambda dst, src: dst.at[tuple(slice(0, d) for d in src.shape)]
            .set(src), japi.init_cache(1, MAX_SEQ)[0], jc)
        full = tapi.init_cache(1, MAX_SEQ, device="cpu")[0]
        for k in ("k", "v"):
            full[k][:, :, :PROMPT] = tc[k]
        full["slot_pos"][:, :PROMPT] = tc["slot_pos"]
        tc = full
        for j, tok in enumerate(toks):
            jrow = np.asarray(jl[0, -1], np.float64)
            trow = tl[0, -1].double().numpy()
            scale = np.abs(jrow[:500]).max()
            assert np.abs(trow - jrow)[:500].max() <= REL * scale
            top2 = np.sort(jrow)[-2:]
            margins.append((top2[1] - top2[0]) / scale)
            assert int(np.argmax(jrow)) == tok
            if j + 1 == len(toks):
                break
            jl, jc = jdecode(jp, jnp.asarray([[tok]], jnp.int32), jc,
                             jnp.int32(PROMPT + j))
            with torch.no_grad():
                tl, tc = tapi.decode(tp, torch.tensor([[tok]]), tc, PROMPT + j)
    assert min(margins) > 100 * REL, min(margins)


def test_deadline_eviction(params):
    srv = ts.Server(_cfg(ts), params=params[1], device="cpu")
    dt = srv.cfg.virtual_dt
    reqs = ts.synthetic_requests(2, PROMPT, 1, 500, seed=5)
    reqs[0].max_new_tokens = 50
    reqs[0].deadline_s = 4.5 * dt
    reqs[1].max_new_tokens = 4
    rep = srv.run(reqs)
    by_rid = {r.rid: r for r in rep.completed}
    assert by_rid[0].reason == "deadline"
    assert 0 < len(by_rid[0].tokens) < 50
    assert by_rid[1].reason == "done" and len(by_rid[1].tokens) == 4
    assert srv.cache.free_pages == srv.cache.num_pages


def test_snapshot_refresh_from_jax_checkpoints(params, tmp_path):
    """The JAX package publishes four snapshots; the port's server restores
    them. Never refreshing stays 4 publishes behind; refreshing every step
    swaps to step 4 and serves what the JAX server serves from it."""
    jp, tp = params
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        jckpt.save(jckpt.step_path(d, s),
                   jax.tree.map(lambda x: x * (1 + 0.05 * s), jp), step=s,
                   extra={"published_at": 0.0})

    def serve(mod, srv, every):
        srv.make_refresher(d, every_steps=every)
        rep = srv.run(mod.synthetic_requests(2, PROMPT, 6, 500, seed=7))
        return rep, rep.staleness_summary()["mean_steps_behind"]

    rep_off, stale_off = serve(ts, ts.Server(_cfg(ts), params=tp,
                                             device="cpu"), 0)
    tsrv = ts.Server(_cfg(ts), params=tp, device="cpu")
    rep_on, stale_on = serve(ts, tsrv, 1)
    assert rep_off.refreshes == 0 and stale_off == 4.0
    assert rep_on.refreshes == 1 and tsrv.refresher.current_step == 4
    assert stale_on < stale_off
    assert all(len(r.staleness) == len(r.tokens) for r in rep_on.completed)
    jrep_on, _ = serve(js, js.Server(_cfg(js), params=jp), 1)
    assert _tokens(rep_on) == _tokens(jrep_on)
    assert _tokens(rep_on) != _tokens(rep_off)    # the swap changed output

    # restore_params serves the latest snapshot bit for bit
    srv = ts.Server(_cfg(ts), params=tp, device="cpu")
    assert srv.restore_params(d) == 4
    want, _, _ = jckpt.restore(jckpt.step_path(d, 4), like=jp)
    for a, b in zip(tm.tree_leaves(srv.params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _CountedLead:
    """A one-rank stand-in for ``engine/placement.py::ServePlacement`` that
    counts the host broadcasts (``decide``); values come back as floats,
    as a broadcast returns them. Its params are restored whole and served
    as restored (no model axis)."""
    is_lead = True
    model_compute, model_compute_fallback = None, ""

    def __init__(self):
        self.decides = 0

    def decide(self, values):
        self.decides += 1
        return [None if v is None else float(v) for v in values]

    def blocks(self):
        return None

    def serve(self, shards):
        return shards

    def all_ok(self, flag):
        return flag


def test_one_host_broadcast_between_decode_steps(params, tmp_path):
    """A serve on a mesh broadcasts rank 0's host decisions once between
    decode steps (the clock, the stamp and the snapshot step to swap in,
    together), once a prefill call and once at each end of a run, a swap
    landing mid-serve; its tokens and stamps are the mesh-less
    server's."""
    _, tp = params
    d = str(tmp_path)
    for step in (1, 2):
        ckpt.save(ckpt.step_path(d, step),
                  tm.tree_map(lambda x: x * (1 + 0.05 * step), tp),
                  step=step, extra={"published_at": 0.0})

    def serve(lead):
        srv = ts.Server(_cfg(ts), params=tp, device="cpu")
        srv.placement = lead
        srv.run(_requests(ts, n=1, seed=4))     # 4 decode steps
        srv.make_refresher(d, every_steps=8, base_step=1)
        if lead is not None:
            lead.decides = 0
        return srv.run(_requests(ts)), srv.decode_steps - 4

    ref, _ = serve(None)
    lead = _CountedLead()
    rep, steps = serve(lead)
    assert rep.refreshes == ref.refreshes == 1
    assert _tokens(rep) == _tokens(ref)
    assert {r.rid: [b for b, _ in r.staleness] for r in rep.completed} == \
        {r.rid: [b for b, _ in r.staleness] for r in ref.completed}
    assert {0, 1} <= {b for r in rep.completed for b, _ in r.staleness}
    assert lead.decides == 2 + steps + rep.prefill_calls


def test_server_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.Server(_cfg(ts))
