"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408,
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

Sharding note: 60 routed experts padded to 64 (= 4 dead experts with -inf
router logits) so the expert axis divides the 16-way model axis evenly.
Shared experts are fused into one always-on FFN of width 4*1408 = 5632.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import MoESettings, TransformerConfig

ARCH_ID = "qwen2-moe-a2.7b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128,
            vocab=512, vocab_real=500, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False,
            moe=MoESettings(num_experts=4, num_experts_real=3, top_k=2,
                            d_ff=96, shared_d_ff=96, capacity_factor=2.0))
    return TransformerConfig(
        name=ARCH_ID, num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
        vocab=151_936, vocab_real=151_936,
        swa_window=(8_192 if long_ctx else None),
        moe=MoESettings(num_experts=64, num_experts_real=60, top_k=4,
                        d_ff=1408, shared_d_ff=4 * 1408, capacity_factor=1.25))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="moe",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B", make_config=make_config,
    notes="60 routed experts padded to 64; 4 shared experts fused to one "
          "5632-wide FFN; long_500k uses the swa_window=8192 variant.",
    train_optimizer="adam")
