"""Port parity: the cross-attention families on the serving plane,
``repro_torch`` against ``repro``.

The reduced ``whisper-base`` and ``llama-3.2-vision-11b`` with every cross
gate at 0.5 (``test_torch_lm_train.with_gates``; at 0 the features would not
reach a token). Each request carries its own features (``frames`` /
``cross_feats``, numpy) but one, which the prefill fills with zeros, as the
JAX server does. Compared: the cache layout (the cross K/V ``xk``/``xv``
are resident leaves: their length is the feature count, which does not
grow with ``max_seq``, and their batch axis is 1), the route each family
takes, and the greedy tokens and loop counts of the port's ``Server``
against the JAX ``Server`` on shared weights: whisper on the paged route
(as ``tests/test_serving_paged.py`` runs it), the VLM on the paged and the
gather route. The serve CLI takes the paged route for both.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro import serving as js
from repro_torch import configs as tcfg
from repro_torch import serving as ts

from test_torch_cross import VISION, VOCAB_REAL, WHISPER, models

PROMPT, MAX_SEQ, PAGE_TOKENS = 8, 24, 4
GENS = (5, 9, 7, 3, 6)


def _feature(arch):
    return "frames" if arch == WHISPER else "cross_feats"


def _params(arch):
    """(gated JAX params, the same on the port) of the reduced config."""
    return models({VISION: "vision", WHISPER: "whisper"}[arch])[2:]


def _serve_cfg(mod, arch, paged):
    return mod.ServingConfig(arch=arch, reduced=True, slots=2,
                             prompt_len=PROMPT, max_seq=MAX_SEQ,
                             page_tokens=PAGE_TOKENS, temperature=0.0,
                             seed=0, virtual_dt=0.01, paged=paged)


def _requests(mod, arch):
    """Five requests over two slots; request 3 has no features."""
    cfg = tcfg.get(arch).make_config(reduced=True)
    shape = ((1, cfg.num_frames, cfg.d_model) if arch == WHISPER
             else (1, cfg.cross_tokens, cfg.cross_dim))
    rng = np.random.default_rng(11)
    reqs = mod.synthetic_requests(len(GENS), PROMPT, 1, VOCAB_REAL,
                                  arrivals=(0.0, 0.0, 0.02, 0.03, 0.05),
                                  seed=3)
    for r, g in zip(reqs, GENS):
        r.max_new_tokens = g
        feats = rng.standard_normal(shape).astype(np.float32)
        r.features = None if r.rid == 3 else {_feature(arch): feats}
    return reqs


@pytest.mark.parametrize("arch", [VISION, WHISPER])
def test_cross_kv_rides_in_the_resident_row(arch):
    api = tcfg.get(arch).api(reduced=True)
    cfg = api.cfg.decoder_cfg() if arch == WHISPER else api.cfg
    layout = ts.build_layout(api, MAX_SEQ, PAGE_TOKENS, device="cpu")
    names = ["k", "slot_pos", "v", "xk", "xv"]
    tok = dict(zip(names, layout.token_axes))
    batch = dict(zip(names, layout.batch_axes))
    assert (tok["xk"], tok["xv"]) == (None, None)
    assert (batch["xk"], batch["xv"]) == (1, 1)
    assert (tok["k"], tok["slot_pos"]) == (2, 1)
    assert layout.tokens == MAX_SEQ
    per_leaf = (cfg.num_cross_layers * cfg.cross_tokens * cfg.num_kv_heads
                * cfg.head_dim)
    assert layout.res_width == 2 * per_leaf
    assert [n for n, _, _ in layout.leaf_views] == ["k", "slot_pos", "v"]


@pytest.mark.parametrize("arch,paged,route", [(WHISPER, "auto", "paged"),
                                              (VISION, "auto", "paged"),
                                              (VISION, "off", "gather")])
def test_serve_equals_jax(arch, paged, route):
    """The same route, the same greedy tokens and the same join / evict /
    step / prefill counts as the JAX server."""
    jp, tp = _params(arch)
    jsrv = js.Server(_serve_cfg(js, arch, paged), params=jp)
    tsrv = ts.Server(_serve_cfg(ts, arch, paged), params=tp, device="cpu")
    assert tsrv.paged_route == jsrv.paged_route == route
    jrep, trep = jsrv.run(_requests(js, arch)), tsrv.run(_requests(ts, arch))
    tokens = lambda rep: {r.rid: r.tokens for r in rep.completed}
    assert tokens(trep) == tokens(jrep)
    assert [len(t) for _, t in sorted(tokens(trep).items())] == list(GENS)
    for f in ("decode_steps", "joins", "evicts", "prefill_calls"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert tsrv.cache.free_pages == tsrv.cache.num_pages


@pytest.mark.parametrize("arch", [VISION, WHISPER])
def test_serve_cli_takes_the_paged_route(arch, capsys):
    """``launch/serve.py`` draws each request's features and serves the
    reduced config on the paged route."""
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--reduced", "--cpu", "--greedy",
                 "--batch", "2", "--prompt-len", "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert "serve dispatch: paged=paged on cpu" in out
    assert "decode: 8 tokens over 3 continuous-batch steps" in out
