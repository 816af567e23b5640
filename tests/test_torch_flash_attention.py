"""Port parity: ``flash_attention``'s plain version
(``repro_torch.kernels.ref``) and dispatcher against ``repro``.

The plain version is held against the JAX oracle
(``repro.kernels.ref.flash_attention``) and against the Pallas kernel run
in interpret mode, as ``tests/test_kernels.py`` runs it, over that test's
grid (right-aligned Sq < Sk, Sk not a multiple of the block, GQA, windows,
bf16), plus bidirectional attention and the head shapes of the reduced
configs. Its twin of the model check holds the dispatcher against the
port's own transformer attention (``_attend``) under the causal and the
sliding-window mask. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: fp32 max |port - jax| <= 1e-5 x max |jax| (the same fp32
products summed in other orders); bf16 outputs within one bf16 rounding
(rtol 2^-7), since both compute in fp32 and round once at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfl
from repro.kernels import ref as jref
from repro_torch import configs as tcfg
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import flash_attention as tfl
from repro_torch.models import layers as L
from repro_torch.models import transformer as ttr

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

REL = 1e-5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_kernels.py::test_flash_attention_sweep's grid, then
# bidirectional, windows wider than the sequence, and hd 80 (danube).
GRID = [
    (128, 128, 4, 2, 64, 0, "float32", True),
    (100, 260, 8, 8, 32, 0, "float32", True),
    (64, 192, 4, 1, 128, 48, "float32", True),
    (1, 300, 4, 2, 64, 0, "float32", True),
    (96, 96, 2, 2, 64, 0, "bfloat16", True),
    (33, 77, 6, 3, 16, 20, "float32", True),
    (40, 70, 4, 2, 80, 0, "float32", False),
    (17, 50, 4, 1, 80, 4096, "float32", True),
]


def _inputs(b, sq, sk, h, hkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v = f(b, sq, h, hd), f(b, sk, hkv, hd), f(b, sk, hkv, hd)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(x, jdt) for x in (q, k, v)],
            [torch.from_numpy(x).to(tdt) for x in (q, k, v)])


def _check(got, want, dtype):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "float32":
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= REL * scale
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("sq,sk,h,hkv,hd,win,dtype,causal", GRID)
def test_plain_matches_oracle_and_pallas(sq, sk, h, hkv, hd, win, dtype,
                                         causal):
    (jq, jk, jv), (q, k, v) = _inputs(2, sq, sk, h, hkv, hd, dtype,
                                      seed=sq + sk)
    got = ref.flash_attention(q, k, v, causal=causal, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    _check(got, jref.flash_attention(jq, jk, jv, causal=causal, window=win),
           dtype)
    pallas = jfl.flash_attention(jq, jk, jv, causal=causal, window=win,
                                 block_q=32, block_k=64, interpret=True)
    _check(got, pallas, dtype)


def test_dispatcher_runs_the_plain_version_on_cpu_and_reports_it():
    dispatch.reset_report()
    _, (q, k, v) = _inputs(1, 20, 45, 4, 2, 32, "float32")
    before = tfl.flash_attention.launches
    got = dispatch.flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(got, ref.flash_attention(q, k, v, causal=True,
                                                window=8))
    assert tfl.flash_attention.launches == before
    assert dispatch.report()["flash_attention"] == (
        "ref (cpu tensor; B=1 Sq=20 Sk=45 H=4/Hkv=2 hd=32)")


def test_kernel_wrapper_refuses_tensors_off_the_card():
    """A CPU tensor never reaches the kernel through the wrapper, and a
    device the port has no path for raises in the dispatcher: nothing
    falls back silently."""
    _, (q, k, v) = _inputs(1, 8, 8, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfl.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no kernel path"):
        dispatch.flash_attention(*(x.to("meta") for x in (q, k, v)))


@pytest.mark.parametrize("arch,window", [("deepseek-7b", 0),
                                         ("h2o-danube-1.8b", 16)])
def test_dispatcher_matches_the_model_attention(arch, window):
    """Twin of tests/test_kernels.py::test_flash_attention_matches_model_
    attention: the port's transformer attention at the reduced config's
    head shapes, under its own causal or sliding-window mask."""
    cfg = tcfg.get(arch).make_config(reduced=True)
    assert (cfg.swa_window or 0) == window
    b, s = 2, 40
    _, (q, k, v) = _inputs(b, s, s, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, "float32", seed=7)
    mask = (L.sliding_window_mask(s, s, 0, window) if window
            else L.causal_mask(s, s, 0))
    want = ttr._attend(q, k, v, mask[None], cfg)
    got = dispatch.flash_attention(q, k, v, causal=True, window=window)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL * scale
