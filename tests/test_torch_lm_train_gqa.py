"""Port parity: language-model training through ``build_engine`` in all
four engine modes on reduced ``h2o-danube-1.8b`` (GQA with one kv head, a
sliding window of 16), ``repro_torch`` against ``repro``. The grid, inputs
and tolerances are ``test_torch_lm_train.py``'s (whose runner this file
shares); the sequence (24 tokens) is longer than the window, so the window
mask bites.
"""
import pytest

from test_torch_lm_train import MODES, check_run, make_models

ARCH, SEQ = "h2o-danube-1.8b", 24


def test_the_window_bites():
    assert make_models(ARCH)[1].cfg.swa_window < SEQ


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("mode", MODES)
def test_lm_train_matches_jax(mode, kernels):
    check_run(ARCH, mode, kernels, seq=SEQ)


def test_lm_train_sgd_matches_jax_everywhere():
    check_run(ARCH, "stale-psum", "on", optimizer="sgd", seq=SEQ)
