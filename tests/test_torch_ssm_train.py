"""Port parity: the state-space families through the engine, the train CLI
and the serving plane, ``repro_torch`` against ``repro``.

* ``build_engine`` in all four modes on reduced ``mamba2-1.3b`` (kernels
  off and on) and reduced ``zamba2-7b`` (kernels on), with the grid,
  inputs and tolerances of ``test_torch_lm_train.py`` (whose runner this
  file shares): losses rtol 1e-5, atol 1e-5; Adam params within 2 * lr *
  steps everywhere and rtol 1e-5, atol 2e-5 on all but a 1e-4 share.
* The train CLI on both archs against the JAX driver on the same
  arguments: the text the two print (``test_torch_train_cli.py``'s check;
  each package draws its own init, so the numbers differ).
* The resident serve route (the SSM cache has no token axis) against the
  JAX server on shared weights: the same route and the same greedy tokens
  (the twin of ``test_serving.test_ssm_resident_only_serving``).
"""
import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro import serving as js
from repro_torch import serving as ts
from repro_torch.convert import params_from_jax

from test_torch_lm_train import MODES, check_run
from test_torch_train_cli import _check_text, _run_both

MAMBA, ZAMBA, SEQ = "mamba2-1.3b", "zamba2-7b", 20


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("mode", MODES)
def test_mamba_engine_matches_jax(mode, kernels):
    check_run(MAMBA, mode, kernels, seq=SEQ)


@pytest.mark.parametrize("mode", MODES)
def test_zamba_engine_matches_jax(mode):
    check_run(ZAMBA, mode, "on", seq=SEQ)


def test_mamba_sgd_matches_jax_everywhere():
    check_run(MAMBA, "stale-psum", "on", optimizer="sgd", seq=SEQ)


@pytest.mark.parametrize("arch,extra,kernel_line", [
    (MAMBA, ["--stale", "2", "--compress", "topk:0.25", "--coherence"],
     "kernel dispatch: config=on delivery=packed"),
    (ZAMBA, ["--stale", "0"], "kernel dispatch: config=on delivery=none"),
])
def test_train_cli_matches_the_jax_driver(arch, extra, kernel_line, tmp_path,
                                          monkeypatch, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "4", "--seq", "16",
            "--workers", "2", "--log-every", "1", "--steps", "3",
            "--kernels", "on"] + extra
    j, t, ret = _run_both(argv, tmp_path, monkeypatch, capsys)
    _check_text(j, t, kernel_line)
    assert all(np.isfinite(r["loss"]) for r in t[0])


def test_resident_route_serve_equals_jax():
    """Three requests over two slots, prompts of 6, 4 new tokens each."""
    cfg = dict(arch=MAMBA, reduced=True, slots=2, prompt_len=6, max_seq=16,
               temperature=0.0, virtual_dt=0.01)
    japi = jcfg.get(MAMBA).api(reduced=True)
    jp = jax.jit(lambda k: japi.init(k)[0])(jax.random.PRNGKey(0))
    jsrv = js.Server(js.ServingConfig(**cfg), params=jp)
    tsrv = ts.Server(ts.ServingConfig(**cfg), device="cpu",
                     params=params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu"))
    assert tsrv.paged_route == jsrv.paged_route == "resident"
    assert not tsrv.layout.has_tokens and tsrv.layout.res_width > 0
    reqs = lambda mod: mod.synthetic_requests(3, 6, 4, 500, seed=2)
    jrep, trep = jsrv.run(reqs(js)), tsrv.run(reqs(ts))
    tokens = lambda rep: {r.rid: r.tokens for r in rep.completed}
    assert tokens(trep) == tokens(jrep)
    assert all(len(t) == 4 for t in tokens(trep).values())
    assert trep.joins == jrep.joins == 3 > cfg["slots"]
    assert trep.decode_steps == jrep.decode_steps


@pytest.mark.parametrize("arch,route", [(MAMBA, "resident"),
                                        (ZAMBA, "gather")])
def test_serve_cli_takes_the_family_route(arch, route, capsys):
    """``launch/serve.py`` on the reduced config: the family's route (no
    token axis -> resident; no decode_paged -> gather, as in the JAX
    package) and every request's tokens."""
    from repro_torch.launch import serve as tserve
    tserve.main(["--arch", arch, "--reduced", "--cpu", "--greedy",
                 "--batch", "2", "--prompt-len", "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"serve dispatch: paged={route} " in out
    assert "decode: 8 tokens over 3 continuous-batch steps" in out
