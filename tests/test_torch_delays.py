"""Port parity: repro_torch.delays against repro.delays.

Deterministic specs (Schedule, Constant, Zero) give the same delays element
for element. Samplers draw from torch.Generators, which cannot reproduce
jax.random's bits, so they are checked by property: bound, range, mean.
"""
import jax
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro_torch import delays as tdel

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("shape", [(4, 4), (4,)])
def test_schedule_rows_match_jax(shape):
    table = np.random.default_rng(0).integers(0, 5, (7, 4))
    jsrc = jdel.Schedule(table).realize(num_workers=4)
    tsrc = tdel.Schedule(table).realize(num_workers=4)
    assert tsrc.bound == jsrc.bound
    for step in range(10):                       # wraps past T = 7
        want = np.asarray(jsrc.delays(jax.random.PRNGKey(0), step, shape))
        got = tsrc.delays(_gen(), step, shape)
        np.testing.assert_array_equal(got.numpy(), want)
    # simulate broadcast: r[src, dst] = table[t mod T, src]
    r = tsrc.delays(_gen(), 9, (4, 4))
    assert torch.equal(r, torch.as_tensor(table[9 % 7])[:, None].expand(4, 4))


def test_schedule_aggregate_and_validation():
    src = tdel.Schedule([0, 2, 1]).realize()
    assert int(src.delays(_gen(), 4, ())) == 2
    assert torch.equal(src.delays(_gen(), 1, (3,)), torch.full((3,), 2))
    with pytest.raises(ValueError):
        tdel.Schedule(np.zeros((0, 2)))
    with pytest.raises(ValueError):
        tdel.Schedule([[1, -1]])
    with pytest.raises(ValueError):
        tdel.Schedule(np.zeros((3, 2))).realize(num_workers=4)
    with pytest.raises(ValueError):
        tdel.Schedule(np.zeros((3, 2))).realize().delays(_gen(), 0, ())
    spec = tdel.Schedule(np.array([[0, 3], [1, 1]]))
    jspec = jdel.Schedule(np.array([[0, 3], [1, 1]]))
    assert spec.bound == jspec.bound == 3
    assert spec.mean_total_delay == jspec.mean_total_delay
    assert isinstance(tdel.as_spec(np.zeros((2, 3), np.int32)), tdel.Schedule)
    assert tdel.as_spec(None) is None


@pytest.mark.parametrize("s", [0, 1, 2, 5, 16])
def test_uniform_bound_range_and_mean(s):
    spec = tdel.UniformDelay(s)
    assert spec.bound == jdel.UniformDelay(s).bound == max(s - 1, 0)
    assert spec.mean_total_delay == jdel.UniformDelay(s).mean_total_delay
    draws = spec.realize().delays(_gen(s), 0, (200, 50))
    assert draws.dtype == torch.int64
    assert int(draws.min()) >= 0 and int(draws.max()) <= spec.bound
    if s > 1:
        assert int(draws.max()) == s - 1        # every value is reachable
    np.testing.assert_allclose(float(draws.float().mean()),
                               spec.mean_total_delay - 1, atol=0.1)


def test_constant_and_zero():
    for tspec, jspec in ((tdel.ConstantDelay(3), jdel.ConstantDelay(3)),
                         (tdel.Zero(), jdel.Zero())):
        want = np.asarray(jspec.sample(jax.random.PRNGKey(0), (3, 3)))
        got = tspec.sample(_gen(), (3, 3))
        np.testing.assert_array_equal(got.numpy(), want)
        assert tspec.bound == jspec.bound
        assert tspec.mean_total_delay == jspec.mean_total_delay


def test_geometric_bound_and_straggler():
    spec = tdel.GeometricDelay(p_normal=0.5, p_straggler=0.05, trunc=20)
    draws = torch.stack([spec.sample(_gen(i), (6, 6)) for i in range(300)])
    assert int(draws.min()) >= 0 and int(draws.max()) <= 20
    # one straggler SOURCE per draw: its row's mean dominates the others
    row_means = draws.float().mean(dim=2)               # [draws, src]
    top = row_means.argmax(dim=1)
    assert float(row_means.gather(1, top[:, None]).mean()) > 3 * float(
        row_means.median())
    assert spec.bound == 20


def test_matched_geometric_matches_jax():
    for s, p in ((8, 4), (16, 8), (2, 2)):
        assert tdel.matched_geometric(s, p) == tdel.GeometricDelay(
            **vars(jdel.matched_geometric(s, p)))


def test_core_exports_match_jax():
    """ROADMAP A.14: ``repro_torch.core`` exports every name ``repro.core``
    exports (the delay samplers and ``draw_delay_matrix`` included), and no
    other."""
    import inspect
    import repro.core as jcore
    import repro_torch.core as tcore

    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    assert names(tcore) == names(jcore)
    assert tcore.UniformDelay is tdel.UniformDelay
    assert tcore.matched_geometric is tdel.matched_geometric


SAMPLERS = {"uniform": tdel.UniformDelay(5), "constant": tdel.ConstantDelay(3),
            "zero": tdel.Zero(),
            "geometric": tdel.matched_geometric(8, 4, trunc=12)}


@pytest.mark.parametrize("name", list(SAMPLERS))
@pytest.mark.parametrize("p", [1, 3, 8])
def test_draw_delay_matrix_and_histogram(name, p):
    """``draw_delay_matrix`` is the sampler's ``[p, p]`` draw (bitwise, and
    within ``[0, bound]``); ``effective_staleness_histogram`` counts
    ``1 + r`` over ``steps`` such draws: length ``bound + 2``, total
    ``steps * p^2``, nothing at 0; the constant and zero delays land all
    their mass on ``1 + value``."""
    from repro_torch.core import draw_delay_matrix
    from repro_torch.core.staleness import effective_staleness_histogram
    spec, steps = SAMPLERS[name], 7
    r = draw_delay_matrix(_gen(p), spec, p)
    assert r.shape == (p, p) and r.dtype == torch.int64
    assert torch.equal(r, spec.sample(_gen(p), (p, p)))
    assert int(r.min()) >= 0 and int(r.max()) <= spec.bound
    hist = effective_staleness_histogram(spec, _gen(p + 1), p, steps)
    assert hist.shape == (spec.bound + 2,)
    assert int(hist.sum()) == steps * p * p and int(hist[0]) == 0
    gen = _gen(p + 1)
    draws = torch.stack([spec.sample(gen, (p, p)) for _ in range(steps)])
    assert torch.equal(hist, torch.bincount(draws.reshape(-1) + 1,
                                            minlength=spec.bound + 2))
    if name in ("constant", "zero"):
        want = torch.zeros(spec.bound + 2, dtype=torch.int64)
        want[spec.bound + 1] = steps * p * p
        assert torch.equal(hist, want)
