"""Port parity: repro_torch.core.coherence (+ the coherence_dots plain
version) against repro.core.coherence and the Pallas kernel.

Identical numpy inputs go through both packages. mu, the cosine profile and
the gradient norm are ratios of fp32 sums of <= 4096 products, summed in
another order by XLA and torch: they agree to a few ulps of the sums,
rtol 1e-5 (atol 1e-6 for cosines near 0). The controller's ``allowed_s``
sequence is integer arithmetic on those mus, so it is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coherence as jcoh
from repro.kernels import coherence as jkco
from repro.kernels import ref as jref
from repro.models import mlp as jmlp
from repro_torch.convert import params_from_jax
from repro_torch.core import coherence as tcoh
from repro_torch.kernels import dispatch
from repro_torch.models import mlp as tmlp

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _grads(n, dim, seed):
    """n probe gradients that share a common direction (so mu moves around
    zero rather than sitting at it), fp32."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(dim).astype(np.float32)
    noise = rng.standard_normal((n, dim)).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, (n, 1)).astype(np.float32)
    return (scale * (0.5 * base + noise)).astype(np.float32)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("window,n", [(1, 1), (1, 3), (4, 3), (4, 9),
                                      (8, 5), (8, 19)])
def test_observe_matches_jax(window, n, kernels):
    """n observations into a window-W ring: count below and above W, with
    the plain reduction and through dispatch.coherence_dots."""
    dim = 4096
    gs = _grads(n, dim, seed=window * 100 + n)
    js = jcoh.init_coherence(dim, window)
    ts = tcoh.init_coherence(dim, window, device="cpu")
    for g in gs:
        js, jout = jcoh.observe(js, jnp.asarray(g), kernels=kernels)
        ts, tout = tcoh.observe(ts, torch.from_numpy(g), kernels=kernels)
        for key in ("mu", "cos_by_lag", "grad_norm"):
            np.testing.assert_allclose(tout[key].numpy(),
                                       np.asarray(jout[key]), **TOL,
                                       err_msg=key)
        assert (ts.head, ts.count) == (int(js.head), int(js.count))
    np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))


def test_observe_pads_to_a_padded_ring():
    """A block-padded ring (CoherenceHook(kernels=True)) takes an unpadded
    gradient: the zero tail changes nothing."""
    gs = _grads(5, 3000, seed=7)
    padded = tcoh.init_coherence(4096, 4, device="cpu")
    plain = tcoh.init_coherence(3000, 4, device="cpu")
    for g in gs:
        padded, a = tcoh.observe(padded, torch.from_numpy(g), kernels=True)
        plain, b = tcoh.observe(plain, torch.from_numpy(g))
        for key in ("mu", "cos_by_lag", "grad_norm"):
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), **TOL)
    assert float(padded.history[:, 3000:].abs().sum()) == 0.0


def test_identical_and_opposed_gradients():
    st = tcoh.init_coherence(8, 4, device="cpu")
    _, out = tcoh.observe(st, torch.ones(8))
    assert float(out["mu"]) == 1.0          # no history yet: neutral
    for _ in range(5):
        st, out = tcoh.observe(st, torch.ones(8))
    np.testing.assert_allclose(float(out["mu"]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(out["cos_by_lag"].numpy(), 1.0, rtol=1e-6)
    st, out = tcoh.observe(st, -torch.ones(8))
    assert float(out["mu"]) < 0


@pytest.mark.parametrize("w,d", [(1, 2048), (3, 4096), (8, 8192),
                                 (16, 2048)])
def test_plain_coherence_dots_matches_pallas_interpret_and_ref(w, d):
    rng = np.random.default_rng(w)
    h = rng.standard_normal((w, d)).astype(np.float32)
    g = rng.standard_normal(d).astype(np.float32)
    got = dispatch.coherence_dots(torch.from_numpy(h), torch.from_numpy(g))
    pallas = jkco.coherence_dots(jnp.asarray(h), jnp.asarray(g),
                                 interpret=True)
    oracle = jref.coherence_dots(jnp.asarray(h), jnp.asarray(g))
    for a, b, c in zip(got, pallas, oracle):
        # Sums of d products of unit normals: a few ulps of sqrt(d)-sized
        # values, in another order on each side.
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-3)
    assert dispatch.report()["coherence_dots"].startswith("ref")


def test_probe_gradient_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    y = rng.integers(0, 10, 64)
    jp = jmlp.init(jax.random.PRNGKey(0), jmlp.MLPConfig(12, 8, 2))
    want = jcoh.probe_gradient(jmlp.loss_fn, jp, (jnp.asarray(x),
                                                  jnp.asarray(y)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = tcoh.probe_gradient(tmlp.loss_fn, tp, (torch.from_numpy(x),
                                                 torch.from_numpy(y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert all(not t.requires_grad for t in tp["layers"][0].values())


def test_secant_lipschitz_matches_jax():
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((6, 50)).astype(np.float32)
    gs = rng.standard_normal((6, 50)).astype(np.float32)
    js, ts = jcoh.init_secant(50), tcoh.init_secant(50, device="cpu")
    for x, g in zip(xs, gs):
        js = jcoh.update_secant(js, jnp.asarray(x), jnp.asarray(g))
        ts = tcoh.update_secant(ts, torch.from_numpy(x), torch.from_numpy(g))
        np.testing.assert_allclose(float(ts.l_hat), float(js.l_hat),
                                   rtol=1e-6)
    assert ts.seen and bool(js.seen)


def test_secant_lipschitz_quadratic():
    """For f = 0.5 c x^2, L = c exactly; the secant estimate finds it."""
    c = 3.0
    st = tcoh.init_secant(4, device="cpu")
    x = torch.ones(4)
    for _ in range(5):
        g = c * x
        st = tcoh.update_secant(st, x, g)
        x = x - 0.1 * g
    np.testing.assert_allclose(float(st.l_hat), c, rtol=0.2)


_MUS = [0.5, -0.2, -0.1, 0.4, 0.9, 0.31, 0.3, 0.3000000119, 0.2999999,
        -1e-9, 0.0, 0.8, 0.8, 0.8, 0.8, -0.5, 0.95, 0.95, 0.95]


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("s_max,lo,hi,patience", [
    (16, 0.0, 0.3, 2), (16, 0.0, 0.25, 20), (8, 0.3, 0.3, 1),
    (4, -0.15, 0.8, 3)])
def test_controller_sequence_matches_jax(s_max, lo, hi, patience, on_device):
    """allowed_s over a fixed mu sequence (values on, just above and just
    below the fp32 thresholds), with host numbers or device tensors."""
    jc = jcoh.CoherenceController(s_max=s_max, lo=lo, hi=hi,
                                  patience=patience)
    tc = tcoh.CoherenceController(s_max=s_max, lo=lo, hi=hi,
                                  patience=patience)
    js, ts = jc.init(), tc.init()
    want, got = [], []
    for mu in np.asarray(_MUS, np.float32):
        js = jc.step(js, jnp.float32(mu))
        ts = tc.step(ts, torch.tensor(mu) if on_device else float(mu))
        want.append((int(js["allowed_s"]), int(js["healthy"])))
        got.append((int(ts["allowed_s"]), int(ts["healthy"])))
        assert torch.is_tensor(ts["allowed_s"]) == on_device
    assert got == want


@pytest.mark.parametrize("args", [(0.5, 1.0, 10.0, 2.0, 1000),
                                  (0.1, 3.0, 0.5, 0.01, 1),
                                  (-0.2, 2.0, 1e-40, 1.0, 50)])
def test_optimal_staleness_matches_jax(args):
    want = float(jcoh.optimal_staleness(*args))
    got_host = float(tcoh.optimal_staleness(*args))
    got_dev = float(tcoh.optimal_staleness(*(torch.tensor(a) for a in args)))
    np.testing.assert_allclose(got_host, want, rtol=1e-6)
    np.testing.assert_allclose(got_dev, want, rtol=1e-6)
