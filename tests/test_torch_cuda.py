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
