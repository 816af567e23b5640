"""The transformer's decode steps read their params through the ambient
fetch (``sharding.rules.use_fetch``), as ``forward`` does: on a mesh an FSDP
arch's fetch gathers one layer from its data-axis blocks at a time, so
whatever the decode reads directly would be a rank's block, not the layer.

One process, reduced archs on the CPU, with a recording fetch that hands
each read back as a copy: every param is read once a decode step (the
gather route's ``decode_slots`` steps every slot through a layer before it
reads the next), and the logits, caches and served tokens are bit for bit
those of a run with no fetch. A fetch that zeros the layers' reads changes
the logits, so the layers are read through it and nowhere else.
"""
from collections import Counter

import pytest
import torch

from repro_torch import configs as cfglib
from repro_torch import treemath as tm
from repro_torch.models import transformer as tr
from repro_torch.sharding import rules as rules_lib

torch.set_num_threads(1)

ARCH = "deepseek-67b"
SERVE = dict(reduced=True, slots=2, prompt_len=8, max_seq=24, page_tokens=4,
             seed=0, virtual_dt=0.01)
GENS = (5, 7, 3)


class Recording:
    """A fetch that records each read's name and returns copies of the
    subtree's leaves (``zero``: the leaves of reads so named as zeros)."""

    def __init__(self, zero: str = ""):
        self.names, self.zero = [], zero

    def __call__(self, tree, name):
        self.names.append(name)
        return tm.tree_map(lambda x: torch.zeros_like(x) if name == self.zero
                           else x.clone(), tree)


def _model():
    api = cfglib.get(ARCH).api(reduced=True)
    return api, api.init(0, device="cpu")[0]


def _step_inputs(api, n: int):
    """``n`` slots' decode inputs: a token, a cache prefilled from a
    prompt of 5 and the position after it."""
    gen = torch.Generator().manual_seed(7)
    out = []
    for j in range(n):
        prompt = torch.randint(0, api.vocab_real, (1, 5 + j), generator=gen)
        _, cache = api.prefill(_model()[1], {"tokens": prompt})
        full = api.init_cache(1, SERVE["max_seq"], device="cpu")[0]
        s = prompt.shape[1]
        for k in ("k", "v"):
            full[k][:, :, :s] = cache[k]
        full["slot_pos"][:, :s] = cache["slot_pos"]
        out.append((torch.randint(0, api.vocab_real, (1, 1), generator=gen),
                    full, s))
    return out


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tm.tree_leaves(a),
                                                 tm.tree_leaves(b)))


def test_decode_step_reads_each_param_once_through_the_fetch():
    """``decode_step`` under a recording fetch: ``embed``, each layer,
    ``final_ln`` and ``head`` read once, and the logits and cache bitwise
    those of the step with no fetch; zeroed layer reads change the
    logits."""
    api, params = _model()
    (token, cache, pos), = _step_inputs(api, 1)
    want = tr.decode_step(params, token, cache, pos, api.cfg)
    rec = Recording()
    with rules_lib.use_fetch(rec):
        got = tr.decode_step(params, token, cache, pos, api.cfg)
    assert rec.names == (["embed"] + ["layers"] * api.cfg.num_layers
                         + ["final_ln", "head"])
    assert _equal(got, want)
    with rules_lib.use_fetch(Recording(zero="layers")):
        zeroed = tr.decode_step(params, token, cache, pos, api.cfg)[0]
    assert not torch.equal(zeroed, want[0])


def test_decode_slots_is_each_slots_decode_step():
    """``decode_slots`` over three slots at their own positions reads each
    param once for all of them, and gives each slot bitwise the logits and
    cache of its own ``decode_step``."""
    api, params = _model()
    slots = _step_inputs(api, 3)
    rec = Recording()
    with rules_lib.use_fetch(rec):
        logits, caches = tr.decode_slots(
            params, *[list(x) for x in zip(*slots)], api.cfg)
    assert Counter(rec.names) == Counter(
        {"embed": 1, "layers": api.cfg.num_layers, "final_ln": 1, "head": 1})
    for (token, cache, pos), lg, nc in zip(slots, logits, caches):
        want = tr.decode_step(params, token, cache, pos, api.cfg)
        assert _equal((lg, nc), want)


@pytest.mark.parametrize("arch,paged", [("deepseek-67b", "off"),
                                        ("deepseek-7b", "on")])
def test_served_steps_read_each_param_once_a_step(arch, paged):
    """A server's decode steps (the gather route's ``decode_slots``; the
    paged route's ``decode_step_paged``; deepseek-67b's FSDP placement
    vetoes the paged route, so deepseek-7b serves it) under a recording
    fetch: every param read once a decode step whatever the slots, and the
    served tokens and counts bitwise those of the server with none."""
    from repro_torch.serving import Server, ServingConfig, synthetic_requests

    def serve(fetch):
        server = Server(ServingConfig(arch=arch, paged=paged, **SERVE),
                        device="cpu")
        reqs = synthetic_requests(len(GENS), SERVE["prompt_len"], 1,
                                  server.api.vocab_real, seed=3)
        for r, g in zip(reqs, GENS):
            r.max_new_tokens = g
        steps = []
        if fetch is not None:
            server._fetch, plan = fetch, server.splan

            def step(*args):
                fetch.names = []
                out = plan(*args)
                steps.append(Counter(fetch.names))
                return out
            server.splan = step
        rep = server.run(reqs)
        return server, rep, steps

    server, want, _ = serve(None)
    _, got, steps = serve(Recording())
    assert server.paged_route == ("paged" if paged == "on" else "gather")
    assert {r.rid: r.tokens for r in got.completed} == \
        {r.rid: r.tokens for r in want.completed}
    assert (got.decode_steps, got.prefill_calls) == (want.decode_steps,
                                                    want.prefill_calls)
    assert len(steps) == got.decode_steps
    layers = server.api.cfg.num_layers
    assert all(s == Counter({"embed": 1, "layers": layers, "final_ln": 1,
                             "head": 1}) for s in steps)
