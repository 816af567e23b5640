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

from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import sparsify as tsp
from repro_torch.kernels import stale_accum as tsa

# Adam repeats the plain version's operations in its order, one rounding
# each; the plain version divides by a scalar as a multiply by its
# reciprocal, so elements may differ by about one ulp.
TOL_ADAM = dict(rtol=1e-5, atol=1e-7)


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
