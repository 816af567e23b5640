"""Port parity: repro_torch.compensate against repro.compensate.

The grammar, the top-k count and threshold (exact and strided-sample
branches, padded rows), the EF split, the LR factors and the Compensator's
state layout per engine mode. Thresholds are k-th largest magnitudes of the
same fp32 values, so they compare exactly; the LR factors are fp32 formulas
in the reference's operation order and compare to rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compensate as jcomp
from repro.core import coherence as jcoh
from repro_torch import compensate as tcomp
from repro_torch.compensate import lr as tlr
from repro_torch.core import coherence as tcoh
from repro_torch.engine import EngineConfig, build_engine
from repro_torch.models import mlp as tmlp
from repro_torch.optim import sgd

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)


def test_parse_compress_grammar_matches_jax():
    for text in ("none", None, "topk:0.1", "topk:128", "thresh:0.05",
                 " topk:0.5 "):
        assert tcomp.parse_compress(text) == jcomp.parse_compress(text)
    for bad in ("topk", "thresh", "topk:0", "topk:-1", "thresh:-0.5",
                "gzip:2", "none:1", "topk:abc"):
        with pytest.raises(ValueError):
            tcomp.parse_compress(bad)
        with pytest.raises(ValueError):
            jcomp.parse_compress(bad)


@pytest.mark.parametrize("amount,n", [(0.1, 1000), (128, 1000),
                                      (0.0001, 1000), (5000, 1000),
                                      (0.25, 970), (0.1, 335_114)])
def test_topk_count_matches_jax(amount, n):
    assert tcomp.topk_count(amount, n) == jcomp.topk_count(amount, n)


@pytest.mark.parametrize("rows,width,true_size", [
    (1, 4096, 4096),            # exact branch
    (4, 2048, 970),             # exact, padded row
    (8, 100_000, 100_000),      # strided-sample branch
    (3, 69_632, 66_001),        # padded row wider than 65536
])
def test_topk_threshold_matches_jax(rows, width, true_size):
    rng = np.random.default_rng(rows)
    a = rng.standard_normal((rows, width)).astype(np.float32)
    a[:, true_size:] = 0.0
    k = tcomp.topk_count(0.1, true_size)
    want = np.asarray(jcomp.topk_threshold(jnp.abs(jnp.asarray(a)), k,
                                           true_size))
    got = tcomp.topk_threshold(torch.from_numpy(a).abs(), k, true_size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (rows,)
    # A [D] row gives a scalar threshold.
    flat = tcomp.topk_threshold(torch.from_numpy(a[0]).abs(), k, true_size)
    assert flat.dim() == 0 and float(flat) == want[0]


def test_sparsify_with_feedback_matches_jax_and_conserves():
    rng = np.random.default_rng(3)
    vec, resid = (rng.standard_normal((4, 2048)).astype(np.float32)
                  for _ in range(2))
    vec[:, 1500:] = resid[:, 1500:] = 0.0
    for kind, amount in (("topk", 0.2), ("thresh", 0.8)):
        js, jr, jsp = jcomp.sparsify_with_feedback(
            jnp.asarray(vec), jnp.asarray(resid), kind, amount, 1500)
        ts, tr, tsp = tcomp.sparsify_with_feedback(
            torch.from_numpy(vec), torch.from_numpy(resid), kind, amount,
            1500)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert float(tsp) == float(jsp)
        acc = torch.from_numpy(vec) + torch.from_numpy(resid)
        assert torch.equal(ts + tr, acc)
        assert float(ts[:, 1500:].abs().sum()) == 0.0


@pytest.mark.parametrize("step", [0, 7])
def test_lr_factors_match_jax(step):
    stale = np.array([0.0, 1.0, 2.5, 7.0], np.float32)
    got = tlr.lr_factor("inverse", {}, torch.from_numpy(stale), step, 4)
    want = jcomp.lr_factor("inverse", {}, jnp.asarray(stale), step, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tlr.lr_factor("inverse", {}, 0.0, step, 4) == 1.0
    sig = {"mu": 0.3, "lip": 2.0}
    tsig = {k: torch.tensor(v) for k, v in sig.items()}
    jsig = {k: jnp.float32(v) for k, v in sig.items()}
    for s in (0, 3):
        got = tlr.lr_factor("theorem1", tsig, torch.from_numpy(stale), step, s)
        want = jcomp.lr_factor("theorem1", jsig, jnp.asarray(stale), step, s)
        assert got.shape == (4,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        one = tcoh.theorem1_stepsize(torch.tensor(-1.0), s, torch.tensor(0.0),
                                     0)
        np.testing.assert_allclose(
            float(one), float(jcoh.theorem1_stepsize(jnp.float32(-1.0), s,
                                                     jnp.float32(0.0), 0.0)),
            rtol=1e-6)
    with pytest.raises(ValueError):
        tlr.lr_factor("cosine", {}, 0.0, 0, 1)


def test_scale_tree_per_worker_rows():
    tree = {"w": torch.ones((4, 3, 2)), "b": torch.ones((4,), dtype=torch.float64)}
    out = tlr.scale_tree(tree, torch.tensor([1.0, 0.5, 0.25, 0.125]))
    assert out["w"][:, 0, 0].tolist() == [1.0, 0.5, 0.25, 0.125]
    assert out["b"].dtype == torch.float64
    assert float(tlr.scale_tree(tree, 0.5)["w"].sum()) == 12.0


def test_config_validation_matches_jax():
    for kw in (dict(lr_scale="cosine"), dict(compress="gzip:1"),
               dict(ef_momentum=1.0), dict(ef_momentum=0.5)):
        with pytest.raises(ValueError):
            tcomp.CompensateConfig(**kw)
        with pytest.raises(ValueError):
            jcomp.CompensateConfig(**kw)
        with pytest.raises(ValueError):
            EngineConfig(mode="simulate", **kw)
    assert not tcomp.CompensateConfig().active
    assert tcomp.CompensateConfig(lr_scale="inverse").active


_PARAMS = {"layers": [{"w": torch.zeros((5, 3)), "b": torch.zeros((3,))}]}


@pytest.mark.parametrize("mode,per_worker,layout", [
    ("simulate", True, (4, 2048)), ("stale-psum", True, (4, 2048)),
    ("ssp", True, (4, 2048)), ("stale-psum", False, (2048,)),
    ("sync", True, (2048,))])
def test_comp_state_layout_per_mode(mode, per_worker, layout):
    """The residual follows the source layout: [P, D] where each worker
    sends its own payload, one [D] row for the aggregate and sync forms;
    momentum rows sit beside it, theorem1's signals are fp32 scalars."""
    eng = build_engine(
        tmlp.loss_fn, sgd(0.1),
        EngineConfig(mode=mode, num_workers=4, s=2, compress="topk:0.5",
                     ef_momentum=0.5, lr_scale="theorem1", ssp_steps=8,
                     per_worker_delays=per_worker), device="cpu")
    state = eng.init(0, params=_PARAMS)
    assert sorted(state.comp) == ["lip", "mom", "mu", "resid"]
    assert tuple(state.comp["resid"].shape) == layout
    assert tuple(state.comp["mom"].shape) == layout
    assert state.comp["mu"].dtype == torch.float32
    assert state.comp["mu"].dim() == 0


def test_with_lr_signals():
    eng = build_engine(tmlp.loss_fn, sgd(0.1),
                       EngineConfig(mode="stale-psum", num_workers=2, s=2,
                                    lr_scale="theorem1"), device="cpu")
    state = eng.init(0, params=_PARAMS)
    state2 = eng.with_lr_signals(state, 0.25, lip=4.0)
    assert float(state2.comp["mu"]) == 0.25 and float(state2.comp["lip"]) == 4.0
    assert float(state.comp["mu"]) == 1.0          # the input is untouched
    state3 = eng.with_lr_signals(state2, torch.tensor(0.5))
    assert float(state3.comp["mu"]) == 0.5 and float(state3.comp["lip"]) == 4.0
    batch = (np.ones((4, 5), np.float32), np.zeros((4,), np.int64))
    _, m = eng.step(state3, batch)
    k, s = 1, 2
    assert float(m["lr_scale"]) == pytest.approx(0.5 / (s * 4.0 * k ** 0.5))
    plain = build_engine(tmlp.loss_fn, sgd(0.1),
                         EngineConfig(mode="stale-psum", num_workers=2, s=2,
                                      lr_scale="inverse"), device="cpu")
    with pytest.raises(ValueError, match="theorem1"):
        plain.with_lr_signals(plain.init(0, params=_PARAMS), 0.5)
