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
from repro.kernels import stale_accum as jsa
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels import fused_adam as tfa
from repro_torch.kernels import stale_accum as tsa

# fp32 tolerances: stale_accum sums <= 3 weighted O(1) terms in another
# order than Pallas' reduction (a few ulps); Adam repeats the same
# operations, but XLA may contract or reorder them differently.
TOL_ACCUM = dict(rtol=1e-6, atol=1e-6)
TOL_ADAM = dict(rtol=1e-5, atol=1e-7)


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
    rep = dispatch.report()
    assert rep["stale_accum"] == "ref (cpu tensor)"
    assert rep["fused_adam"] == "ref (cpu tensor)"
    assert any("stale_accum" in line for line in dispatch.report_lines())
    assert dispatch.fuses(p) is False
    dispatch.note("fused_adam", "tree", "why")
    assert dispatch.report()["fused_adam"] == "tree (why)"
    dispatch.reset_report()
    assert dispatch.report() == {}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never quietly runs the plain version: CPU tensors
    raise before anything is built or launched."""
    before = (tsa.stale_accum.launches, tfa.fused_adam.launches)
    p, buf, w = map(torch.from_numpy, _accum_inputs(1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tsa.stale_accum(p, buf, w)
    pa, ma, va, ga = map(torch.from_numpy, _adam_inputs(64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.fused_adam(pa, ma, va, ga, 1e-3, 0.9, 0.999, 1e-8, 1)
    assert (tsa.stale_accum.launches, tfa.fused_adam.launches) == before


def test_build_declares_every_c_entry_point():
    """Each ``extern "C"`` function in csrc/ has a ctypes signature, and
    the build targets sm_90a."""
    srcs = build.sources()
    assert {s.name for s in srcs} == {"stale_accum.cu", "fused_adam.cu"}
    names = set()
    for src in srcs:
        names |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert names == set(build.SIGNATURES)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.parts[-2] == "build"
