"""Port parity: repro_torch.core.staleness against repro.core.staleness.

The tree step, ``packed_step`` and ``packed_fused_step`` run side by side
with the JAX package's over a few steps at P = 4, from the same weights,
batches and a ``[T, P]`` Schedule of delays, with rings of B = 1 and B = 4
slots. The JAX packed steps reach the Pallas kernels in interpret mode, as
its own tests run them on the CPU.

Tolerances: SGD trajectories are fp32-roundoff close (rtol 1e-5). Adam
normalises each gradient element, so roundoff in a near-zero element can
move its update by up to 2 * lr; over five steps at lr = 1e-3 that stays
within atol 1e-5 here, and the losses stay at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro.core import staleness as jst
from repro.models import mlp as jmlp
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.core import staleness as tst
from repro_torch.data import ShardedBatches
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as topt

P, STEPS = 4, 5
TOL = {"sgd": dict(rtol=1e-5, atol=1e-6), "adam": dict(rtol=1e-5, atol=1e-5)}


def _setup(b_slots):
    cfg = jmlp.MLPConfig(in_dim=32, hidden=16, depth=2)
    jp = jmlp.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(b_slots)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.int32)
    batches = [b for _, b in zip(range(STEPS), ShardedBatches([x, y], P, 8))]
    table = rng.integers(0, b_slots, (3, P))
    table[0, 0] = b_slots - 1               # ring of exactly b_slots slots
    return jp, batches, table


def _fused_kw(opt, loss):
    sp = opt.spec
    return dict(loss=loss, takes_key=False, lr=sp["lr"], b1=sp["b1"],
                b2=sp["b2"], eps=sp["eps"], weight_decay=sp["weight_decay"])


def _run_jax(layout, algo, jp, batches, table):
    opt = jopt.paper_default(algo)
    cfg = jst.StalenessConfig(num_workers=P, delay=jdel.Schedule(table),
                              kernels=layout != "tree")
    fused = _fused_kw(opt, jmlp.loss_fn) if layout == "fused" else None
    if fused:
        width = jst._packed_width(jp)
        ust = {"m": jnp.zeros((width,)), "v": jnp.zeros((width,))}
    else:
        ust = opt.init(jp)
    state = jst.init_sim_state(jp, ust, cfg, jax.random.PRNGKey(0))
    step = jax.jit(jst.make_sim_step(
        jopt.make_sgd_update_fn(jmlp.loss_fn, opt), cfg, fused=fused))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(np.asarray(m["loss"]))
    return state, np.stack(losses)


def _run_torch(layout, algo, jp, batches, table):
    opt = topt.paper_default(algo)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    cfg = tst.StalenessConfig(num_workers=P, delay=tdel.Schedule(table),
                              kernels=layout != "tree")
    fused = _fused_kw(opt, tmlp.loss_fn) if layout == "fused" else None
    if fused:
        width = tst._packed_width(params)
        ust = {"m": torch.zeros(width), "v": torch.zeros(width)}
    else:
        ust = opt.init(params)
    state = tst.init_sim_state(params, ust, cfg, 0)
    step = tst.make_sim_step(topt.make_sgd_update_fn(tmlp.loss_fn, opt), cfg,
                             fused=fused)
    losses = []
    for x, y in batches:
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        losses.append(m["loss"].numpy())
    return state, np.stack(losses)


def _close(j, t, tol):
    jl, tl = jax.tree.leaves(j), tm.tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


@pytest.mark.parametrize("b_slots", [1, 4])
@pytest.mark.parametrize("layout,algo", [("tree", "sgd"), ("tree", "adam"),
                                         ("packed", "sgd"),
                                         ("packed", "adam"),
                                         ("fused", "adam")])
def test_step_matches_jax(layout, algo, b_slots):
    jp, batches, table = _setup(b_slots)
    js, jl = _run_jax(layout, algo, jp, batches, table)
    ts, tl = _run_torch(layout, algo, jp, batches, table)
    tol = TOL[algo]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    _close(js.caches, ts.caches, tol)
    _close(js.pending, ts.pending, tol)      # tree ring, or ring + arrived
    assert ts.step == int(js.step) == STEPS
    if algo == "adam":
        _close({k: js.update_state[k] for k in ("m", "v")},
               {k: ts.update_state[k] for k in ("m", "v")}, tol)
    if layout != "tree":
        width = tst._packed_width(tm.tree_index(ts.caches, 0))
        assert tuple(ts.pending["ring"].shape) == (P, b_slots, width)


def _quad_setup(p, delay, kernels, seed=0):
    def loss(params, batch):
        x, y = batch
        return ((x @ params["w"].unsqueeze(-1)).squeeze(-1) - y).pow(2).mean(-1)

    opt = topt.sgd(0.05)
    raw = topt.make_sgd_update_fn(loss, opt)

    def logging_update(params, ust, batch, gen):
        delta, new, m = raw(params, ust, batch, gen)
        return delta, new, dict(m, delta=delta["w"])

    cfg = tst.StalenessConfig(num_workers=p, delay=delay, kernels=kernels)
    params = {"w": torch.zeros(4)}
    state = tst.init_sim_state(params, opt.init(params), cfg, seed)
    return tst.make_sim_step(logging_update, cfg), state, raw, loss


def _quad_batches(p, n, seed=1):
    rng = np.random.default_rng(seed)
    w_true = torch.tensor([1.0, -2.0, 3.0, 0.5])
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.standard_normal((p, 8, 4)).astype(np.float32))
        out.append((x, x @ w_true))
    return out


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("p,s", [(1, 0), (3, 4), (5, 7)])
def test_drain_conserves_updates(kernels, p, s):
    """After draining, every cache equals x0 + the sum of ALL updates: no
    update is lost or duplicated by either ring layout."""
    step, state, _, _ = _quad_setup(p, tdel.UniformDelay(s), kernels, seed=s)
    total = torch.zeros(4)
    for b in _quad_batches(p, 6):
        state, m = step(state, b)
        total += m["delta"].sum(0)
    drained = tst.drain(state)
    for i in range(p):
        torch.testing.assert_close(drained.caches["w"][i], total, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_s0_p1_equals_sequential(kernels):
    step, state, raw, _ = _quad_setup(1, tdel.Zero(), kernels)
    batches = _quad_batches(1, 8)
    for b in batches:
        state, _ = step(state, b)
    got = tst.drain(state).caches["w"][0]
    want = tst.sequential_reference(raw, {"w": torch.zeros(4)}, {"step": 0},
                                    [(x[0], y[0]) for x, y in batches])
    torch.testing.assert_close(got, want["w"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernels", [False, True])
def test_constant_delay_lands_exactly(kernels):
    """ConstantDelay(d): an update from step t arrives at t + 1 + d."""
    d, p, steps = 3, 2, 10

    def unit(params, ust, batch, gen):
        return {"w": torch.ones(p, 4)}, ust, {}

    cfg = tst.StalenessConfig(num_workers=p, delay=tdel.ConstantDelay(d),
                              kernels=kernels)
    state = tst.init_sim_state({"w": torch.zeros(4)}, (), cfg, 0)
    step = tst.make_sim_step(unit, cfg)
    for _ in range(steps):
        state, _ = step(state, torch.zeros(p, 1))
    torch.testing.assert_close(state.caches["w"][0],
                               torch.full((4,), 2.0 * (steps - d - 1)))


def test_packed_replay_is_deterministic():
    runs = []
    for _ in range(2):
        step, state, _, _ = _quad_setup(4, tdel.UniformDelay(5), True, seed=3)
        for b in _quad_batches(4, 6):
            state, _ = step(state, b)
        runs.append(state)
    assert torch.equal(runs[0].caches["w"], runs[1].caches["w"])
    assert torch.equal(runs[0].pending["ring"], runs[1].pending["ring"])


def test_packed_ring_in_place_and_arrived_is_a_copy():
    """The ring is updated in place (the state passed in is consumed), and
    the prefetched row is its own storage: with B = 1 every step zeroes and
    refills slot 0, which must not change a held ``arrived``."""
    step, state, _, _ = _quad_setup(2, tdel.Zero(), True)
    ring = state.pending["ring"]
    for b in _quad_batches(2, 3):
        state, _ = step(state, b)
    assert state.pending["ring"] is ring
    arrived = state.pending["arrived"]
    assert (arrived.untyped_storage().data_ptr()
            != ring.untyped_storage().data_ptr())
    held = arrived.clone()
    step(state, _quad_batches(2, 1, seed=9)[0])
    assert torch.equal(arrived, held)


def test_bound_clamps_delays():
    """bound=0 delivers everything at the next step, whatever the spec."""
    step, state, _, _ = _quad_setup(3, tdel.ConstantDelay(4), True)
    state, m = step(state, _quad_batches(3, 1)[0], bound=0)
    nxt = state.pending["arrived"][:, :4]
    torch.testing.assert_close(nxt, m["delta"].sum(0).expand(3, 4))


def test_unported_options_raise():
    """Every option is ported (the server_side ablation, A.2, included);
    what raises now is what the JAX package refuses: server_side with the
    packed layout, server_side without a server_apply, and a fused step
    without kernels."""
    with pytest.raises(ValueError, match="server_side"):
        tst.StalenessConfig(num_workers=2, delay=tdel.Zero(),
                            server_side=True, kernels=True)
    with pytest.raises(ValueError, match="server_side"):
        jst.StalenessConfig(num_workers=2, delay=jdel.Zero(),
                            server_side=True, kernels=True)
    srv = tst.StalenessConfig(num_workers=2, delay=tdel.Zero(),
                              server_side=True)
    with pytest.raises(ValueError, match="server_apply"):
        tst.make_sim_step(lambda *a: a, srv)
    assert callable(tst.make_sim_step(lambda *a: a, srv,
                                      server_apply=lambda *a: a))
    cfg = tst.StalenessConfig(num_workers=2, delay=tdel.Zero())
    # Without server_side a server_apply is ignored, as in the reference.
    assert callable(tst.make_sim_step(lambda *a: a, cfg,
                                      server_apply=lambda *a: a))
    # Compensation is ported (A.6): a compensator is taken as it is.
    assert callable(tst.make_sim_step(lambda *a: a, cfg,
                                      compensator=object()))
    with pytest.raises(ValueError):
        tst.make_sim_step(lambda *a: a, cfg, fused={})


# -- the server_side ablation ---------------------------------------------------

def _srv_quad(seed=9, steps=40):
    """``tests/test_staleness_engine.py::test_server_side_apply``'s setup:
    workers ship raw negative gradients of a quadratic, the server applies
    the learning rate (and here also counts deliveries in its state)."""
    rng = np.random.default_rng(seed)
    w = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    xs = rng.standard_normal((steps, 2, 8, 4)).astype(np.float32)
    return [(x, x @ w) for x in xs]


def _jax_srv(cfg, state, batches, steps):
    from repro import treemath as jtm

    def upd(params, ust, batch, key):
        g = jax.grad(lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2))(
            params, batch)
        return jtm.tree_scale(g, -1.0), ust, {}

    def apply(cache, srv, arrived):
        return jtm.tree_axpy(0.05, arrived, cache), {"n": srv["n"] + 1}

    step = jax.jit(jst.make_sim_step(upd, cfg, server_apply=apply))
    for x, y in batches[:steps]:
        state, _ = step(state, (jnp.asarray(x), jnp.asarray(y)))
    return state, jst.drain(state, server_apply=apply, server_side=True)


def _torch_srv(cfg, state, batches, steps):
    def loss(p, b):
        return ((b[0] @ p["w"].unsqueeze(-1)).squeeze(-1) - b[1]).pow(2).mean(-1)

    def upd(params, ust, batch, gen):
        _, g = topt.value_and_grad(loss, params, batch)
        return tm.tree_scale(g, -1.0), ust, {}

    def apply(cache, srv, arrived):
        return tm.tree_axpy(0.05, arrived, cache), {"n": srv["n"] + 1}

    step = tst.make_sim_step(upd, cfg, server_apply=apply)
    for x, y in batches[:steps]:
        state, _ = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return state, tst.drain(state, server_apply=apply, server_side=True)


def test_server_side_matches_jax_and_drains_through_server_apply():
    """The reference's server_side setup with Schedule delays, so both
    packages see the same delays: caches and the per-worker server state
    agree over 40 steps, and drain delivers the ring through
    server_apply (B = 3 more deliveries in the server's count)."""
    table = np.random.default_rng(2).integers(0, 3, (40, 2))
    table[0, 0] = 2
    batches = _srv_quad()
    jcfg = jst.StalenessConfig(num_workers=2, delay=jdel.Schedule(table),
                               server_side=True)
    tcfg = tst.StalenessConfig(num_workers=2, delay=tdel.Schedule(table),
                               server_side=True)
    js, jd = _jax_srv(jcfg, jst.init_sim_state(
        {"w": jnp.zeros((4,))}, (), jcfg, jax.random.PRNGKey(0),
        server_state={"n": jnp.zeros(())}), batches, 40)
    ts, td = _torch_srv(tcfg, tst.init_sim_state(
        {"w": torch.zeros(4)}, (), tcfg, 0,
        server_state={"n": torch.zeros(())}), batches, 40)
    for a, b in ((ts, js), (td, jd)):
        np.testing.assert_allclose(a.caches["w"].numpy(),
                                   np.asarray(b.caches["w"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(a.server_state["n"].numpy(),
                                      np.asarray(b.server_state["n"]))
    assert ts.server_state["n"].shape == (2,)
    assert td.server_state["n"].tolist() == [43.0, 43.0]
    np.testing.assert_allclose(td.caches["w"][0].numpy(),
                               [1.0, -2.0, 3.0, 0.5], atol=0.05)
    # Without server_side, drain takes the plain add.
    plain = tst.drain(ts)
    assert plain.server_state["n"].tolist() == [40.0, 40.0]
