"""Port parity: the port's kernels and their plain versions.

On the CPU the plain versions (``repro_torch.kernels.ref``) are held
against the JAX package's Pallas kernels run in interpret mode. The CUDA
kernels themselves run only on the card: see ``test_torch_cuda.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_adam as jfa
from repro.kernels import fused_update as jfu
from repro.kernels import sparsify as jsp
from repro.kernels import stale_accum as jsa
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels import coherence as tco
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import sparsify as tsp
from repro_torch.kernels import stale_accum as tsa

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

# fp32 tolerances: stale_accum sums <= 3 weighted O(1) terms in another
# order than Pallas' reduction (a few ulps); Adam repeats the same
# operations, but XLA may contract or reorder them differently.
TOL_ACCUM = dict(rtol=1e-6, atol=1e-6)
TOL_ADAM = dict(rtol=1e-5, atol=1e-7)
# fused_update: the delivered sum u adds R <= 4 weighted rows in row order
# where Pallas reduces them in its own order (a few ulps of O(1) values);
# the Adam part is TOL_ADAM's, after which p' = p - scale * update.
TOL_UPDATE = dict(rtol=1e-5, atol=1e-6)


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


@pytest.mark.parametrize("s", [1, 3])
def test_plain_stale_accum_matches_pallas_interpret(s):
    p, buf, w = _accum_inputs(s, 2048)
    want = np.asarray(jsa.stale_accum(jnp.asarray(p), jnp.asarray(buf),
                                      jnp.asarray(w), interpret=True))
    got = ref.stale_accum(*map(torch.from_numpy, (p, buf, w)))
    np.testing.assert_allclose(got.numpy(), want, **TOL_ACCUM)


@pytest.mark.parametrize("step", [1, 10])
def test_plain_fused_adam_matches_pallas_interpret(step):
    p, m, v, g = _adam_inputs(4096)
    want = jfa.fused_adam(*map(jnp.asarray, (p, m, v, g)), 1e-3, 0.9, 0.999,
                          1e-8, step, interpret=True)
    got = ref.fused_adam(*map(torch.from_numpy, (p, m, v, g)), 1e-3, 0.9,
                         0.999, 1e-8, step)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_ADAM)


def _update_inputs(r, d, seed=0):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.standard_normal(d).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.0, 0.1, d).astype(np.float32)
    stale, acc = (rng.standard_normal((r, d)).astype(np.float32)
                  for _ in range(2))
    mom = 0.1 * rng.standard_normal((r, d)).astype(np.float32)
    weights = np.full((r,), 1.0 / r, np.float32)
    thr = np.quantile(np.abs(acc), 0.75, axis=1).astype(np.float32)
    fresh = (np.arange(r) % 2 == 0).astype(np.float32)
    return dict(p=p, m=0.1 * m, v=v, stale=stale, weights=weights, acc=acc,
                thr=thr, fresh=fresh, mom=mom)


@pytest.mark.parametrize("variant", ["plain", "ef", "ef_mom"])
@pytest.mark.parametrize("r", [1, 4])
def test_plain_fused_update_matches_pallas_interpret(variant, r):
    x = _update_inputs(r, 4096, seed=r)
    opt = {} if variant == "plain" else dict(acc=x["acc"], thr=x["thr"],
                                             fresh=x["fresh"])
    if variant == "ef_mom":
        opt["mom"] = x["mom"]
    args = [x[k] for k in ("p", "m", "v", "stale", "weights")]
    scalars = jfu._stack_scalars(1e-3, 0.9, 0.999, 1e-8, 3, 0.5)
    want = jfu.fused_update(*map(jnp.asarray, args), scalars,
                            **{k: jnp.asarray(v) for k, v in opt.items()},
                            interpret=True)
    got = ref.fused_update(*map(torch.from_numpy, args), 1e-3, 0.9, 0.999,
                           1e-8, 3, torch.tensor(0.5),
                           **{k: torch.from_numpy(v) for k, v in opt.items()})
    assert len(got) == len(want) == {"plain": 4, "ef": 6, "ef_mom": 7}[variant]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_UPDATE)
    for a, b in zip(got[4:], want[4:]):   # split and momentum: exact
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if variant != "plain":
        sent, resid = got[4:6]
        assert torch.equal(sent + resid, torch.from_numpy(x["acc"]))


@pytest.mark.parametrize("variant", ["ef", "ef_mom"])
@pytest.mark.parametrize("r", [1, 4])
def test_plain_fused_update_without_ring_matches_pallas_interpret(variant, r):
    """``stale=None, fresh=None`` (the sync tail's call) delivers sent for
    every row: the Pallas kernel with every row fresh, whatever its ring
    rows hold, gives the same outputs."""
    x = _update_inputs(r, 4096, seed=20 + r)
    opt = dict(acc=x["acc"], thr=x["thr"])
    if variant == "ef_mom":
        opt["mom"] = x["mom"]
    scalars = jfu._stack_scalars(1e-3, 0.9, 0.999, 1e-8, 3, 0.5)
    want = jfu.fused_update(
        *map(jnp.asarray, (x["p"], x["m"], x["v"], x["stale"], x["weights"])),
        scalars, fresh=jnp.ones((r,), jnp.float32),
        **{k: jnp.asarray(v) for k, v in opt.items()}, interpret=True)
    got = ref.fused_update(
        *map(torch.from_numpy, (x["p"], x["m"], x["v"])), None,
        torch.from_numpy(x["weights"]), 1e-3, 0.9, 0.999, 1e-8, 3,
        torch.tensor(0.5), **{k: torch.from_numpy(v) for k, v in opt.items()})
    assert len(got) == len(want)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_UPDATE)
    for a, b in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("r", [1, 3])
def test_plain_sparsify_mask_matches_pallas_interpret(r):
    x = _update_inputs(r, 2048, seed=10 + r)
    want = jsp.sparsify_topk(jnp.asarray(x["acc"]), jnp.asarray(x["thr"]),
                             interpret=True)
    got = ref.sparsify_mask(torch.from_numpy(x["acc"]),
                            torch.from_numpy(x["thr"]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sent, resid = got
    assert torch.equal(sent + resid, torch.from_numpy(x["acc"]))
    kept = (sent != 0).sum(dim=1).numpy()
    assert (np.abs(kept - 0.25 * 2048) <= 1).all()


def test_adam_scalars_are_fp32_values():
    lr, b1, b2, eps, omb1, omb2, bc1, bc2 = ref.adam_scalars(
        1e-3, 0.9, 0.999, 1e-8, 3)
    for x in (lr, b1, b2, eps, omb1, omb2, bc1, bc2):
        assert float(np.float32(x)) == x
    assert omb1 == float(np.float32(1) - np.float32(0.9))
    assert bc1 == pytest.approx(1 - 0.9 ** 3, rel=1e-6)


def test_dispatch_routes_cpu_tensors_to_plain_version():
    dispatch.reset_report()
    p, buf, w = map(torch.from_numpy, _accum_inputs(2, 1000))  # ragged D
    torch.testing.assert_close(dispatch.stale_accum(p, buf, w),
                               ref.stale_accum(p, buf, w), rtol=0, atol=0)
    pa, ma, va, ga = map(torch.from_numpy, _adam_inputs(1000))
    for a, b in zip(dispatch.fused_adam(pa, ma, va, ga, 1e-3, step=4),
                    ref.fused_adam(pa, ma, va, ga, 1e-3, 0.9, 0.999, 1e-8, 4)):
        assert torch.equal(a, b)
    x = {k: torch.from_numpy(v) for k, v in _update_inputs(2, 1000).items()}
    sent, resid = dispatch.sparsify_topk(x["acc"][0], x["thr"][0])
    assert sent.shape == (1000,) and torch.equal(sent + resid, x["acc"][0])
    for a, b in zip(dispatch.sparsify_topk(x["acc"], x["thr"]),
                    ref.sparsify_mask(x["acc"], x["thr"])):
        assert torch.equal(a, b)
    args = [x[k] for k in ("p", "m", "v", "stale", "weights")]
    ef = {k: x[k] for k in ("acc", "thr", "fresh", "mom")}
    for a, b in zip(dispatch.fused_update(*args, 1e-3, step=2, scale=0.5,
                                          **ef),
                    ref.fused_update(*args, 1e-3, 0.9, 0.999, 1e-8, 2, 0.5,
                                     **ef)):
        assert torch.equal(a, b)
    h, g = x["stale"], x["p"]
    for a, b in zip(dispatch.coherence_dots(h, g), ref.coherence_dots(h, g)):
        assert torch.equal(a, b)
    rep = dispatch.report()
    for op in ("stale_accum", "fused_adam", "sparsify_topk", "fused_update",
               "coherence_dots"):
        assert rep[op] == "ref (cpu tensor)"
    assert any("stale_accum" in line for line in dispatch.report_lines())
    assert dispatch.fuses(p) is False
    dispatch.note("fused_adam", "tree", "why")
    assert dispatch.report()["fused_adam"] == "tree (why)"
    dispatch.reset_report()
    assert dispatch.report() == {}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never quietly runs the plain version: CPU tensors
    raise before anything is built or launched."""
    count = lambda: (tsa.stale_accum.launches, tfa.fused_adam.launches,
                     tsp.sparsify_topk.launches,
                     sum(tfu.fused_update.by_variant.values()),
                     tco.coherence_dots.launches)
    before = count()
    p, buf, w = map(torch.from_numpy, _accum_inputs(1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tsa.stale_accum(p, buf, w)
    pa, ma, va, ga = map(torch.from_numpy, _adam_inputs(64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.fused_adam(pa, ma, va, ga, 1e-3, 0.9, 0.999, 1e-8, 1)
    x = {k: torch.from_numpy(v) for k, v in _update_inputs(2, 64).items()}
    with pytest.raises(ValueError, match="CUDA"):
        tsp.sparsify_topk(x["acc"], x["thr"])
    with pytest.raises(ValueError, match="CUDA"):
        tfu.fused_update(x["p"], x["m"], x["v"], x["stale"], x["weights"],
                         1e-3, 0.9, 0.999, 1e-8, 1, torch.ones(1))
    # Without a ring every row is fresh: stale and fresh are None together.
    for stale, fresh in ((None, x["fresh"]), (x["stale"], None)):
        with pytest.raises(ValueError, match="fresh"):
            tfu.fused_update(x["p"], x["m"], x["v"], stale, x["weights"],
                             1e-3, 0.9, 0.999, 1e-8, 1, torch.ones(1),
                             acc=x["acc"], thr=x["thr"], fresh=fresh)
    with pytest.raises(ValueError, match="stale"):
        tfu.fused_update(x["p"], x["m"], x["v"], None, x["weights"],
                         1e-3, 0.9, 0.999, 1e-8, 1, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        tco.coherence_dots(x["stale"], x["p"])
    assert count() == before
    assert tfu.variant() == "plain"
    assert tfu.variant(acc=x["acc"]) == "ef"
    assert tfu.variant(acc=x["acc"], mom=x["mom"]) == "ef_mom"


def test_build_declares_every_c_entry_point():
    """Each ``extern "C"`` function in csrc/ has a ctypes signature, and
    the build targets sm_90a."""
    srcs = build.sources()
    assert {s.name for s in srcs} == {"stale_accum.cu", "fused_adam.cu",
                                      "fused_update.cu", "sparsify.cu",
                                      "coherence.cu", "paged_attention.cu",
                                      "flash_attention.cu"}
    names = set()
    for src in srcs:
        names |= set(re.findall(r'extern "C" (?:int|long long) (\w+)\(',
                                src.read_text()))
    assert names == set(build.SIGNATURES)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2] == "build"
