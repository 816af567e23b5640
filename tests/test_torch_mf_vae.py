"""Port parity: repro_torch.models.mf and models.vae, and their experiment
twins, against the JAX package.

MF: both packages run the same small factorization (40 users x 30 items,
rank 3) from the same factors, on the same batches and ``Schedule``
delays. Losses, the full objective and gradients agree to fp32 roundoff
(rtol 1e-5; gradients atol 1e-7, for rows no rating in the batch touches,
whose gradient is the regulariser's alone); engine curves to rtol 1e-5.

VAE: the loss draws epsilon from the step's generator, which cannot
reproduce ``jax.random``; the parity tests inject JAX's draws. The losses
agree to rtol 1e-5 and each gradient leaf to 1e-5 in relative L2 norm
(elements of O(10) cancel to O(0.1) in some places, so a per-element rtol
would hold roundoff to the cancelled size). An engine run with kernels on
(packed, fused Adam) equals the same run with kernels off (tree) under one
generator seed: both draw epsilon in the same order, so they part only by
the layouts' roundoff (rtol 1e-5 SGD; 1e-4 Adam, whose per-element
normalisation magnifies roundoff in small gradient elements).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import delays as jdel
from repro.engine import EngineConfig as JConfig
from repro.engine import Hook as JHook
from repro.engine import Trainer as JTrainer
from repro.engine import build_engine as jbuild
from repro.models import mf as jmf
from repro.models import vae as jvae
from repro.optim import optimizers as jopt
from repro_torch import delays as tdel
from repro_torch import experiments
from repro_torch import treemath as tm
from repro_torch.convert import params_from_jax
from repro_torch.data import ShardedBatches, synthetic
from repro_torch.engine import EngineConfig, Hook, Trainer, build_engine
from repro_torch.models import mf as tmf
from repro_torch.models import vae as tvae
from repro_torch.optim import optimizers as topt
from repro_torch.optim.optimizers import value_and_grad

P, MF_BATCH = 2, 16


def _tp(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _table():
    """A [T, P] Schedule over UniformDelay(4)'s range r in [0, 3]."""
    return np.random.default_rng(3).integers(0, 4, (60, P))


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_step(self, ctx):
        self.losses.append(float(ctx.metrics["loss"]))


# -- MF -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mf_setup():
    data = synthetic.low_rank_ratings(seed=0, num_users=40, num_items=30,
                                      rank=3, density=0.5)
    cfg = jmf.MFConfig(num_users=40, num_items=30, rank=3, lam=1e-3)
    jp = jmf.init(jax.random.PRNGKey(0), cfg)
    return data, cfg, jp


def _mf_tcfg(cfg):
    return tmf.MFConfig(num_users=cfg.num_users, num_items=cfg.num_items,
                        rank=cfg.rank, lam=cfg.lam)


def test_mf_loss_objective_and_grads_match_jax(mf_setup):
    data, cfg, jp = mf_setup
    tcfg, tp = _mf_tcfg(cfg), _tp(jp)
    batch = next(iter(ShardedBatches([data.rows, data.cols, data.vals], P,
                                     MF_BATCH)))
    jl, jg = jax.value_and_grad(jmf.make_loss_fn(cfg))(
        jp, tuple(jnp.asarray(a[0]) for a in batch))
    tl, tg = value_and_grad(tmf.make_loss_fn(tcfg), tp,
                            tuple(torch.from_numpy(a[0]) for a in batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tm.tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    # The stacked form gives each worker its own loss and gradient.
    stacked = tm.tree_map(lambda a: torch.stack([a, 0.5 * a]), tp)
    ls, gs = value_and_grad(tmf.make_loss_fn(tcfg), stacked,
                            tuple(torch.from_numpy(a) for a in batch))
    for i in range(P):
        li, gi = value_and_grad(tmf.make_loss_fn(tcfg),
                                tm.tree_index(stacked, i),
                                tuple(torch.from_numpy(a[i]) for a in batch))
        torch.testing.assert_close(ls[i], li)
        for a, b in zip(tm.tree_leaves(gs), tm.tree_leaves(gi)):
            torch.testing.assert_close(a[i], b)
    arrays = (data.rows, data.cols, data.vals)
    np.testing.assert_allclose(
        float(tmf.full_objective(tp, *(torch.from_numpy(a) for a in arrays),
                                 tcfg)),
        float(jmf.full_objective(jp, *(jnp.asarray(a) for a in arrays),
                                 cfg)), rtol=1e-5)


def _jax_mf_run(data, cfg, jp, steps, target=None):
    eng = jbuild(jmf.make_loss_fn(cfg), jopt.sgd(1.0),
                 JConfig(mode="simulate", num_workers=P,
                         delay=jdel.Schedule(_table())))
    losses = []

    class Log(JHook):
        def on_step(self, ctx):
            losses.append(float(ctx.metrics["loss"]))

    arrays = [jnp.asarray(a) for a in (data.rows, data.cols, data.vals)]
    res = JTrainer(eng, hooks=[Log()]).run(
        iter(ShardedBatches([data.rows, data.cols, data.vals], P, MF_BATCH)),
        steps, state=eng.init(jax.random.PRNGKey(0), params=jp),
        eval_fn=lambda p: jmf.full_objective(p, *arrays, cfg), eval_every=4,
        target=target, higher_better=False)
    return res, losses


@pytest.fixture(scope="module")
def mf_jax_run(mf_setup):
    data, cfg, jp = mf_setup
    return _jax_mf_run(data, cfg, jp, 40, target=MF_TARGET)


MF_TARGET = 0.5


@pytest.mark.parametrize("kernels", ["off", "on"])
def test_mf_engine_curve_and_batches_to_target_match_jax(mf_setup,
                                                         mf_jax_run,
                                                         kernels):
    """mf_experiment (SGD lr 1.0) follows the JAX engine's losses and
    reaches the target objective after the same number of worker
    batches."""
    data, cfg, jp = mf_setup
    jres, jlosses = mf_jax_run
    assert jres.converged
    eng_losses = _Losses()
    orig = experiments.Trainer

    class Logged(orig):
        def __init__(self, engine, hooks=()):
            super().__init__(engine, hooks=[eng_losses, *hooks])
            assert engine.meta["kernels"]["delivery"] == (
                "tree" if kernels == "off" else "packed")

    experiments.Trainer = Logged
    try:
        res = experiments.mf_experiment(
            s=4, workers=P, target_loss=MF_TARGET, batch=MF_BATCH,
            max_steps=40, eval_every=4, delay=tdel.Schedule(_table()),
            kernels=kernels, params=_tp(jp), cfg=_mf_tcfg(cfg), data=data,
            device="cpu")
    finally:
        experiments.Trainer = orig
    np.testing.assert_allclose(eng_losses.losses, jlosses, rtol=1e-5)
    assert res.converged and res.batches_to_target == jres.batches_to_target
    np.testing.assert_allclose([v for _, v in res.curve],
                               [v for _, v in jres.curve], rtol=1e-5)


# -- VAE ------------------------------------------------------------------------

VCFG = jvae.VAEConfig(in_dim=24, hidden=16, depth=2, latent=4, obs_scale=0.5)


def _vae_tcfg():
    return tvae.VAEConfig(in_dim=24, hidden=16, depth=2, latent=4,
                          obs_scale=0.5)


@pytest.fixture(scope="module")
def vae_setup():
    data = synthetic.vae_data(seed=0, dim=24, n_train=256, n_test=64)
    jp = jvae.init(jax.random.PRNGKey(0), VCFG)
    return data, jp


def test_vae_losses_and_grads_match_jax_with_injected_eps(vae_setup):
    data, jp = vae_setup
    x = data.x_train[:8]
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (8, VCFG.latent)))
    jl, jg = jax.value_and_grad(jvae.elbo_loss)(jp, (jnp.asarray(x),), key,
                                                VCFG)
    tp = _tp(jp)
    tl, tg = value_and_grad(
        lambda p: tvae.elbo_loss(p, (torch.from_numpy(x),), None,
                                 _vae_tcfg(), eps=torch.from_numpy(eps)), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tm.tree_leaves(tg), jax.tree.leaves(jg)):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
    xt = data.x_test[:32]
    keys = jax.random.split(jax.random.PRNGKey(99), 4)
    eps4 = [torch.from_numpy(np.array(jax.random.normal(k, (32, 4))))
            for k in keys]
    np.testing.assert_allclose(
        float(tvae.test_loss(tp, torch.from_numpy(xt), None, _vae_tcfg(),
                             eps=eps4)),
        float(jvae.test_loss(jp, jnp.asarray(xt), jax.random.PRNGKey(99),
                             VCFG)), rtol=1e-5)


def test_vae_draws_eps_from_the_generator_and_clips_logvar(vae_setup):
    data, jp = vae_setup
    tp = _tp(jp)
    x = torch.from_numpy(data.x_train[:8])
    draw = lambda: tvae.elbo_loss(tp, x, torch.Generator().manual_seed(3),
                                  _vae_tcfg())
    assert torch.equal(draw(), draw())
    eps = torch.randn((8, 4), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(
        draw(), tvae.elbo_loss(tp, x, None, _vae_tcfg(), eps=eps))
    # A huge encoder bias drives logvar past 8: the clip keeps it finite.
    big = tm.tree_map(torch.clone, tp)
    big["enc"][-1]["b"] += 1e3
    assert torch.isfinite(tvae.elbo_loss(big, x, None, _vae_tcfg(),
                                         eps=eps))


@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_vae_engine_kernels_on_equals_off(vae_setup, algo):
    """One generator seed: the packed (fused Adam) and tree routes draw the
    same epsilon each step, so their losses and params agree."""
    data, jp = vae_setup
    runs = {}
    for kernels in ("on", "off"):
        # SGD at lr 1e-3: Table 1's 0.01 diverges on this narrow VAE.
        opt = topt.sgd(1e-3) if algo == "sgd" else topt.paper_default(algo)
        eng = build_engine(tvae.make_loss_fn(_vae_tcfg()), opt,
                           EngineConfig(mode="simulate", num_workers=P,
                                        delay=tdel.Schedule(_table()),
                                        loss_takes_key=True, kernels=kernels),
                           device="cpu")
        log = _Losses()
        res = Trainer(eng, hooks=[log]).run(
            ((b[0],) for b in ShardedBatches([data.x_train], P, 8)), 12,
            params=_tp(jp), init_seed=5)
        runs[kernels] = (log.losses, eng.params(res.state), eng.meta)
    rtol = 1e-5 if algo == "sgd" else 1e-4
    np.testing.assert_allclose(runs["on"][0], runs["off"][0], rtol=rtol)
    for a, b in zip(tm.tree_leaves(runs["on"][1]),
                    tm.tree_leaves(runs["off"][1])):
        torch.testing.assert_close(a, b, rtol=rtol, atol=1e-5)
    assert runs["on"][2]["kernels"]["megakernel"] == (
        "fused" if algo == "adam" else "off")


def test_vae_experiment_runs_and_reports_batches(vae_setup):
    data, jp = vae_setup
    res = experiments.vae_experiment(
        depth=2, algo="adam", s=2, workers=P, target_loss=1e9, batch=8,
        max_steps=6, eval_every=3, params=_tp(jp), cfg=_vae_tcfg(),
        data=data, device="cpu")
    assert res.converged and res.batches_to_target == 3 * P
    assert res.row() == res.batches_to_target
    # The evaluation draws from a fresh generator seeded 99 each time.
    again = experiments.vae_experiment(
        depth=2, algo="adam", s=2, workers=P, target_loss=-1e9, batch=8,
        max_steps=6, eval_every=3, params=_tp(jp), cfg=_vae_tcfg(),
        data=data, device="cpu")
    assert not again.converged and again.row() == -1
    assert again.curve[0] == res.curve[0]
