"""Port parity: the FSDP archs, reduced ``deepseek-67b`` (dense) and
``kimi-k2-1t-a32b`` (MoE, 4 experts top-2 plus a shared expert), trained
through ``build_engine`` in all four engine modes with their ``momentum``
optimizer, ``repro_torch`` against ``repro``, with
``test_torch_lm_train.py``'s runner, inputs and tolerances. Kernels are
``auto``, which the FSDP placement vetoes (tree math), as in JAX. These
one-process runs are what ``test_torch_mesh_engine.py`` holds the sharded
runs to (JAX's own sharded legs fail on the CPU, ROADMAP C.5). The
reduced configs hold fp32 params; the full ones hold bf16, which the
second grid runs: their first update is fp32 in both packages (the
learning rate is an fp32 array in JAX), so the params turn fp32 there and
the runs end in JAX's dtypes.
"""
import pytest
import torch

from test_torch_lm_train import MODES, check_run

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["deepseek-67b", "kimi-k2-1t-a32b"])
def test_fsdp_arch_train_matches_jax(arch, mode):
    check_run(arch, mode, "auto", optimizer="momentum")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["deepseek-67b", "kimi-k2-1t-a32b"])
def test_fsdp_arch_bf16_params_match_jax(arch, mode):
    check_run(arch, mode, "auto", optimizer="momentum",
              param_dtype="bfloat16")
