"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + shared attention block. [arXiv:2411.15242]

The shared attention+MLP block is applied every 6 mamba layers (13
invocations over 81 layers, then 3 tail layers), weights shared,
per-invocation KV caches. long_500k windows the shared attention (8192) —
the mamba state is O(1).
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.hybrid import HybridConfig
from repro_torch.models.ssm import SSMSettings

ARCH_ID = "zamba2-7b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> HybridConfig:
    if reduced:
        return HybridConfig(
            name=ARCH_ID + "-reduced", num_layers=4, d_model=128,
            vocab=512, vocab_real=500, num_heads=4, num_kv_heads=4,
            head_dim=32, d_ff=256, shared_period=2,
            ssm=SSMSettings(d_model=128, d_state=16, head_dim=32, expand=2,
                            chunk=16, conv_width=4),
            tp=1, dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return HybridConfig(
        name=ARCH_ID, num_layers=81, d_model=3584,
        vocab=32_000, vocab_real=32_000, num_heads=32, num_kv_heads=32,
        head_dim=112, d_ff=14_336, shared_period=6,
        ssm=SSMSettings(d_model=3584, d_state=64, head_dim=64, expand=2,
                        chunk=256, conv_width=4),
        swa_window=(8_192 if long_ctx else None))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="hybrid", arch_type="hybrid",
    citation="arXiv:2411.15242 (Zamba2)", make_config=make_config,
    notes="Mamba2 d_inner=7168 -> 112 SSD heads (state 64). One shared "
          "attn+MLP block every 6 layers (simplified from Zamba2's two "
          "alternating LoRA-modulated blocks). long_500k windows the shared "
          "attention at 8192.",
    train_optimizer="adam")
