"""Port parity: repro_torch.models.lda and ``experiments.lda_experiment``
against the JAX package.

The collapsed Gibbs sweep samples with ``jax.random.categorical``, which
torch cannot reproduce; one update with JAX's Gumbel noise injected (the
key chain rebuilt: a split per document, then one per token) gives the same
assignments and count deltas bit for bit, since every count is an exact
integer in fp32 and both take ``argmax(logits + g)``. The sampler itself is
checked by a chi-square test of its frequencies against
``softmax(logits)``. A whole run is random on each side, so it is held by
properties (counts conserved after ``drain``, the log-likelihood rising)
and by its final log-likelihood lying within 5% of JAX's from the same
start: JAX's own finals over seeds 0-3 at this size span -999 to -1103
(+-5% about their mean).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.engine import EngineConfig as JConfig
from repro.engine import build_engine as jbuild
from repro.models import lda as jlda
from repro_torch import experiments
from repro_torch.core import drain
from repro_torch.data import synthetic
from repro_torch.models import lda as tlda

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import common  # noqa: E402

V, K, N_DOCS, DOC_LEN, P = 30, 4, 40, 12, 2
RUN = dict(workers=P, k_topics=K, sweeps=8, n_docs=N_DOCS, doc_len=DOC_LEN,
           vocab=V)


@pytest.fixture(scope="module")
def corpus():
    corp = synthetic.lda_corpus(seed=0, n_docs=N_DOCS, doc_len=DOC_LEN,
                                vocab=V, k_true=K)
    cfg = jlda.LDAConfig(vocab=V, num_topics=K, batch_docs=3)
    z0 = jlda.init_assignments(jax.random.PRNGKey(0),
                               jnp.asarray(corp.tokens), cfg)
    return corp, cfg, np.array(z0)


def _tcfg(cfg):
    return tlda.LDAConfig(vocab=cfg.vocab, num_topics=cfg.num_topics,
                          batch_docs=cfg.batch_docs)


def test_counts_and_log_likelihood_match_jax(corpus):
    corp, cfg, z0 = corpus
    jc = jlda.init_counts(jnp.asarray(corp.tokens), jnp.asarray(z0), cfg)
    toks, z = torch.tensor(corp.tokens), torch.tensor(z0)
    tc = tlda.init_counts(toks, z, _tcfg(cfg))
    for key in ("phi", "phi_tilde"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    np.testing.assert_allclose(
        float(tlda.log_likelihood(tc, toks, z, _tcfg(cfg))),
        float(jlda.log_likelihood(jc, jnp.asarray(corp.tokens),
                                  jnp.asarray(z0), cfg)), rtol=1e-5)
    st = tlda.init_worker_state(toks[:4], z[:4])
    assert st["cursor"].dtype == torch.int32 and st["cursor"].dim() == 0


def _jax_gumbel(key, cfg):
    """The Gumbel noise the JAX sweep adds for one worker's key: split per
    document, then per token in the scan (``key, kk = split(key)``)."""
    docs = []
    for dkey in jax.random.split(key, cfg.batch_docs):
        row = []
        for _ in range(DOC_LEN):
            dkey, kk = jax.random.split(dkey)
            row.append(np.asarray(jax.random.gumbel(kk, (cfg.num_topics,),
                                                    jnp.float32)))
        docs.append(row)
    return np.array(docs)


def test_update_with_injected_noise_matches_jax_bit_for_bit(corpus):
    corp, cfg, z0 = corpus
    per = N_DOCS // P
    wt = corp.tokens[: per * P].reshape(P, per, DOC_LEN)
    wz = z0[: per * P].reshape(P, per, DOC_LEN)
    jc = jlda.init_counts(jnp.asarray(corp.tokens), jnp.asarray(z0), cfg)
    # Stale caches that differ by worker, as the engine's do.
    jcs = {"phi": jnp.stack([jc["phi"], jc["phi"] + 1.0]),
           "phi_tilde": jnp.stack([jc["phi_tilde"], jc["phi_tilde"] + V])}
    cursor = np.array([5, 5], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    jd, js, jm = jax.vmap(jlda.make_update_fn(cfg))(
        jcs, {"tokens": jnp.asarray(wt), "z": jnp.asarray(wz),
              "cursor": jnp.asarray(cursor)}, jnp.zeros((P, 1)), keys)
    noise = np.stack([_jax_gumbel(k, cfg) for k in keys])
    td, ts, tm_ = tlda.make_update_fn(_tcfg(cfg))(
        {k: torch.tensor(np.asarray(v)) for k, v in jcs.items()},
        {"tokens": torch.tensor(wt), "z": torch.tensor(wz),
         "cursor": torch.tensor(cursor)}, None, None,
        gumbel_noise=torch.tensor(noise))
    for key in ("phi", "phi_tilde"):
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]))
    np.testing.assert_array_equal(ts["z"].numpy(), np.asarray(js["z"]))
    np.testing.assert_array_equal(ts["cursor"].numpy(),
                                  np.asarray(js["cursor"]))
    assert ts["cursor"].dtype == torch.int32
    np.testing.assert_allclose(tm_["frac_moved"].numpy(),
                               np.asarray(jm["frac_moved"]), rtol=1e-6)
    assert not np.array_equal(ts["z"].numpy(), wz)     # the sweep moved


def test_sampler_frequencies_follow_softmax():
    """Gumbel-max over fixed logits draws topic k with probability
    softmax(logits)[k]: chi-square over 20,000 draws."""
    logits = torch.tensor([0.3, -1.2, 2.0, 0.0, -0.5, 1.1])
    gen = torch.Generator().manual_seed(0)
    g = tlda.gumbel((20000, 6), gen, torch.device("cpu"))
    counts = torch.bincount(torch.argmax(logits + g, dim=-1), minlength=6)
    expected = torch.softmax(logits.double(), 0).numpy() * 20000
    _, pvalue = stats.chisquare(counts.numpy(), expected)
    assert pvalue > 1e-3


@pytest.fixture(scope="module")
def port_run(corpus):
    corp, _, z0 = corpus
    runs = {k: experiments.lda_run(s=3, z0=z0, kernels=k, device="cpu",
                                   **RUN) for k in ("on", "off")}
    return runs


def test_lda_run_conserves_counts_and_routes(port_run):
    curve, engine, state, cfg, toks = port_run["on"]
    # The custom update_fn runs on packed delivery, with the JAX engine's
    # routing verdict.
    jeng = jbuild(None, None, JConfig(mode="simulate", num_workers=P, s=3,
                                      kernels="on"),
                  update_fn=jlda.make_update_fn(jlda.LDAConfig(
                      vocab=V, num_topics=K, batch_docs=cfg.batch_docs)))
    assert engine.meta["kernels"] == jeng.meta["kernels"]
    assert engine.meta["kernels"]["delivery"] == "packed"
    inner = drain(state.inner)
    z = inner.update_state["z"].reshape(-1, DOC_LEN)
    want = tlda.init_counts(toks, z, cfg)
    for key in ("phi", "phi_tilde"):
        caches = inner.caches[key]
        for i in range(P):             # every worker holds the same counts
            torch.testing.assert_close(caches[i], want[key], rtol=0, atol=0)
    assert float(inner.caches["phi"][0].sum()) == toks.numel()
    torch.testing.assert_close(inner.caches["phi_tilde"][0],
                               inner.caches["phi"][0].sum(0))
    # kernels on (packed delivery through stale_accum) and off (tree) add
    # the same integers: the runs agree bit for bit.
    off = port_run["off"][2].inner
    assert torch.equal(state.inner.update_state["z"],
                       off.update_state["z"])
    for key in ("phi", "phi_tilde"):
        assert torch.equal(state.inner.caches[key], off.caches[key])


def test_lda_experiment_raises_ll_within_band_of_jax(corpus, port_run):
    _, _, z0 = corpus
    curve = port_run["on"][0]
    assert curve == experiments.lda_experiment(s=3, z0=z0, kernels="on",
                                               device="cpu", **RUN)
    jcurve = common.lda_experiment(s=3, seed=0, **RUN)
    assert [d for d, _ in curve] == [d for d, _ in jcurve]
    assert curve[-1][1] > curve[0][1] + 100
    assert abs(curve[-1][1] - jcurve[-1][1]) <= 0.05 * abs(jcurve[-1][1])
