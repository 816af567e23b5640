"""Port parity: language-model training through ``build_engine`` in all
four engine modes on reduced ``qwen2-moe-a2.7b`` (3 real experts padded to
4, top-2, a shared expert), ``repro_torch`` against ``repro``, with
``test_torch_lm_train.py``'s runner, inputs and tolerances. The MoE load-
balance loss rides in every step's loss.
"""
import pytest

from test_torch_lm_train import MODES, check_run


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("mode", MODES)
def test_moe_lm_train_matches_jax(mode, kernels):
    check_run("qwen2-moe-a2.7b", mode, kernels)
