"""Port parity: language-model training through ``build_engine`` in all
four engine modes, ``repro_torch`` against ``repro``, on reduced
``deepseek-7b`` (MHA); ``test_torch_lm_train_gqa.py`` runs the same grid on
reduced ``h2o-danube-1.8b`` (GQA, sliding window) and ``test_torch_moe.py``
on reduced ``qwen2-moe-a2.7b``.

Both packages start from the JAX package's init (carried across with
``convert.params_from_jax``) and take the same ``token_lm_stream`` batches
(numpy); P = 2 workers, s = 2, delays from one ``[T, P]`` Schedule
(stale-psum, simulate) or the SSP clock discipline over shared worker
speeds (ssp). Each mode runs the port with ``kernels`` off and on (Adam
with the fused-Adam opt-in, as the train CLI builds it), both held against
one JAX run of the leg with its kernels off (the JAX package holds its own
routes together in its tests). TF32 is off.

Tolerances. Per-step losses: rtol 1e-5, atol 1e-5 (the packages sum the
same fp32 products in different orders). Params after Adam: Adam
normalises each gradient element, so where a gradient element lies within
fp32 roundoff of zero the two packages' updates can differ by up to 2 * lr
a step; those elements are few. So every element must lie within 2 * lr *
steps of JAX's, and all but ``FLIP_SHARE`` of them within rtol 1e-5, atol
2e-5. SGD and momentum are linear in the gradient, so their legs hold
every element to rtol 1e-5, atol 2e-5. Params held in bf16 (simulate
keeps the params' dtype) may also lie one bf16 ulp from JAX's, in at most
``BF16_FLIP_SHARE`` of their elements; the params' dtypes after a run
must be JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import delays as jdel
from repro.engine import EngineConfig as JConfig
from repro.engine import build_engine as jbuild
from repro.optim import optimizers as jopt
from repro_torch import configs as tcfg
from repro_torch import delays as tdel
from repro_torch import treemath as tm
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import token_lm_stream
from repro_torch.engine import EngineConfig, build_engine
from repro_torch.optim import optimizers as topt

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

P, S, STEPS, BATCH, SEQ = 2, 2, 3, 4, 8
LR = 1e-3
MODES = ["sync", "stale-psum", "ssp", "simulate"]
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=2e-5)
FLIP_SHARE = 1e-4
# Params held in bf16: the share of elements one ulp from JAX's. A bf16
# rounding flips where the fp32 delta lies within its roundoff of a
# rounding boundary; gradients that cancel carry ~1e-5 relative roundoff,
# against an ulp of 2^-8.
BF16_FLIP_SHARE = 1e-2

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _delays():
    rng = np.random.default_rng(0)
    table = rng.integers(0, S, (STEPS, P))
    table[0, 0] = S - 1
    speeds = rng.lognormal(0.0, 0.5, (16, P)).astype(np.float32)
    return table, speeds


TABLE, SPEEDS = _delays()


def mode_kw(mode, delays):
    """Each mode's delay config, as the same kwargs for both packages."""
    return {"sync": {},
            "stale-psum": dict(s=S, delay=delays.Schedule(TABLE)),
            "ssp": dict(s=S, ssp_speeds=SPEEDS),
            "simulate": dict(s=S, delay=delays.Schedule(TABLE))}[mode]


def with_gates(params, value=0.5):
    """A copy of a JAX params tree with every cross layer's gate at
    ``value``. The gates start at 0, where tanh(0) = 0 keeps the features
    (``frames``, ``cross_feats``) out of the loss, so the parity runs open
    them first."""
    if isinstance(params, dict):
        return {k: (jnp.full_like(v, value) if k == "gate"
                    else with_gates(v, value)) for k, v in params.items()}
    return params


@functools.lru_cache(maxsize=None)
def make_models(arch, param_dtype=None):
    """(JAX api, port api, JAX params, the same params as numpy);
    ``param_dtype`` ("bfloat16") overrides the reduced config's fp32
    params in both packages."""
    jover = tover = None
    if param_dtype is not None:
        jover = {"param_dtype": getattr(jnp, param_dtype)}
        tover = {"param_dtype": getattr(torch, param_dtype)}
    japi = jcfg.get(arch).api(reduced=True, overrides=jover)
    tapi = tcfg.get(arch).api(reduced=True, overrides=tover)
    jp = with_gates(jax.jit(lambda k: japi.init(k)[0])(
        jax.random.PRNGKey(0)))
    return japi, tapi, jp, jax.tree.map(np.asarray, jp)


def lm_batches(vocab, steps=STEPS, batch=BATCH, seq=SEQ, seed=0):
    stream = token_lm_stream(seed, vocab, seq, batch)
    return [next(stream) for _ in range(steps)]


def _batches(arch, mode, seq):
    """The leg's batches: ``lm_batches`` tokens plus, for an arch whose
    batch spec has them, standard-normal features (``frames``,
    ``cross_feats``); [P, BATCH/P, ...] leaves in simulate."""
    tapi = make_models(arch)[1]
    spec = tapi.batch_spec(InputShape("parity", seq, BATCH, "train"))
    out = []
    for t, tokens in enumerate(lm_batches(tapi.vocab_real, seq=seq)):
        batch = {"tokens": tokens}
        for i, name in enumerate(sorted(set(spec) - {"tokens"})):
            batch[name] = np.random.default_rng([t, i]).standard_normal(
                spec[name][0]).astype(np.float32)
        if mode == "simulate":
            batch = {k: v.reshape((P, BATCH // P) + v.shape[1:])
                     for k, v in batch.items()}
        out.append(batch)
    return out


def _optimizer(lib, name):
    return {"adam": lambda: lib.adam(LR), "sgd": lambda: lib.sgd(LR),
            "momentum": lambda: lib.momentum(LR)}[name]()


@functools.lru_cache(maxsize=None)
def jax_run(arch, mode, optimizer, seq, param_dtype=None):
    """The JAX package's run of one leg with its kernels off: (losses,
    params leaves with paths). The port's kernels-off and kernels-on runs
    are both held against it (the JAX package holds its own routes
    together), so it is computed once per leg."""
    japi, _, jp, _ = make_models(arch, param_dtype)
    jo = _optimizer(jopt, optimizer)
    je = jbuild(japi, jo, JConfig(mode=mode, num_workers=P, kernels="off",
                                  **mode_kw(mode, jdel)))
    js = je.init(jax.random.PRNGKey(0), params=jp)
    losses = []
    for batch in _batches(arch, mode, seq):
        js, jm = je.step(js, batch)
        losses.append(float(jm["loss"]))
    return np.array(losses), jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, je.params(js)))[0]


def port_run(arch, mode, kernels, optimizer, seq, param_dtype=None):
    """The port's run of one leg: (losses, params leaves as fp32 or wider
    numpy, their dtypes). Adam takes the fused-Adam opt-in with the kernels
    on, as the train CLI builds it."""
    _, tapi, _, npp = make_models(arch, param_dtype)
    to = (topt.adam(LR, kernel=kernels != "off") if optimizer == "adam"
          else _optimizer(topt, optimizer))
    te = build_engine(tapi, to, EngineConfig(
        mode=mode, num_workers=P, kernels=kernels, **mode_kw(mode, tdel)),
        device="cpu")
    ts = te.init(0, params=params_from_jax(npp, device="cpu"))
    losses = []
    for batch in _batches(arch, mode, seq):
        ts, tmet = te.step(ts, batch)
        losses.append(float(tmet["loss"]))
    leaves = tm.tree_leaves(te.params(ts))
    return (np.array(losses),
            [x.detach().to(torch.promote_types(x.dtype, torch.float32))
             .numpy() for x in leaves],
            [str(x.dtype).removeprefix("torch.") for x in leaves])


def check_run(arch, mode, kernels, optimizer="adam", seq=SEQ,
              param_dtype=None):
    jl, jleaves = jax_run(arch, mode, optimizer, seq, param_dtype)
    tl, tleaves, tdtypes = port_run(arch, mode, kernels, optimizer, seq,
                                    param_dtype)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    assert [x.shape for x in tleaves] == [x.shape for _, x in jleaves]
    # The params' dtypes after the run are JAX's (bf16 params turn fp32
    # where JAX promotes them).
    assert tdtypes == [x.dtype.name for _, x in jleaves]
    total = flipped = held = flipped_held = 0
    for (path, want), got in zip(jleaves, tleaves):
        bf16 = want.dtype.name == "bfloat16"
        want = want.astype(np.float64)
        err = np.abs(got.astype(np.float64) - want)
        within = err <= PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want)
        if bf16:
            # Held in bf16 (simulate keeps the params' dtype): a roundoff
            # difference in an fp32 delta can flip a rounding, one ulp.
            held += want.size
            flipped_held += int((~within).sum())
            within |= err <= bf16_ulp(want)
        else:
            total += want.size
            flipped += int((~within).sum())
        if optimizer == "adam":
            assert err.max() <= 2 * LR * STEPS, jax.tree_util.keystr(path)
        else:
            assert within.all(), jax.tree_util.keystr(path)
    assert flipped <= FLIP_SHARE * total, (flipped, total)
    assert flipped_held <= BF16_FLIP_SHARE * held, (flipped_held, held)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each of ``x``'s (bf16) values: bf16 keeps 8 of
    fp32's 24 significand bits."""
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64) * 2.0**16


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("mode", MODES)
def test_lm_train_matches_jax(mode, kernels):
    check_run("deepseek-7b", mode, kernels)


@pytest.mark.parametrize("mode", ["stale-psum", "simulate"])
def test_lm_train_sgd_matches_jax_everywhere(mode):
    check_run("deepseek-7b", mode, "on", optimizer="sgd")


def _loss_and_grads(api, params, tokens):
    leaves, treedef = tm.tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = api.loss(tm.tree_unflatten(treedef, leaves),
                    {"tokens": torch.from_numpy(tokens)})
    return loss, torch.autograd.grad(loss, leaves)


def test_remat_changes_no_number():
    """cfg.remat recomputes each layer in the backward pass: the loss and
    every gradient equal the run without it bit for bit, and match the JAX
    package's remat forward within LOSS_TOL."""
    japi, _, jp, npp = make_models("deepseek-7b")
    tokens = lm_batches(japi.vocab_real, steps=1)[0]
    params = params_from_jax(npp, device="cpu")
    runs = {}
    for remat in (False, True):
        api = tcfg.get("deepseek-7b").api(reduced=True,
                                          overrides={"remat": remat})
        assert api.cfg.remat is remat
        runs[remat] = _loss_and_grads(api, params, tokens)
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
    jremat = jcfg.get("deepseek-7b").api(reduced=True,
                                         overrides={"remat": True})
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jremat.loss(p, {"tokens": tokens})))(jp)
    np.testing.assert_allclose(float(runs[True][0].detach()), float(jloss),
                               **LOSS_TOL)
    for g, jg in zip(runs[True][1], jax.tree_util.tree_leaves(jgrad)):
        scale = max(float(np.abs(np.asarray(jg)).max()), 1e-30)
        assert float(np.abs(g.numpy() - np.asarray(jg)).max()) <= 1e-5 * scale


def test_remat_keeps_only_layer_inputs():
    """With remat, autograd saves each layer's input and not its
    activations: the saved tensors of a forward shrink."""
    cfg = dataclasses.replace(
        tcfg.get("deepseek-7b").make_config(reduced=True), num_layers=4)
    from repro_torch.models import transformer as ttr
    params, _ = ttr.init(0, cfg, device="cpu")
    tokens = torch.from_numpy(lm_batches(500, steps=1)[0])

    def saved_bytes(remat):
        c = dataclasses.replace(cfg, remat=remat)
        total = []

        def pack(t):
            total.append(t.numel() * t.element_size())
            return t

        leaves = [x.requires_grad_(True) for x in tm.tree_leaves(params)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            ttr.loss_fn(tm.tree_unflatten(tm.tree_flatten(params)[1], leaves),
                        {"tokens": tokens}, c)
        return sum(total)

    assert saved_bytes(True) < 0.5 * saved_bytes(False)
