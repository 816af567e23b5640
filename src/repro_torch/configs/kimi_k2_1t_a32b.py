"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert,
vocab=163840, MoE 384 routed top-8 (+1 shared) — trillion-param paper-table
config. [arXiv:2501.kimi2]

Memory policy: bf16 params, SGD-momentum (no Adam second moments), remat on
— ~1.03T params = 2 TB of weights, which no single 80 GB card holds: on one
GPU the full config serves for shapes and counts (``count_params``, init on
the ``meta`` device); the reduced variant trains.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import MoESettings, TransformerConfig

ARCH_ID = "kimi-k2-1t-a32b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            num_heads=8, num_kv_heads=1, head_dim=16, d_ff=128,
            vocab=512, vocab_real=512, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False,
            moe=MoESettings(num_experts=4, num_experts_real=4, top_k=2,
                            d_ff=64, shared_d_ff=64, capacity_factor=2.0))
    return TransformerConfig(
        name=ARCH_ID, num_layers=61, d_model=7168,
        num_heads=64, num_kv_heads=8, head_dim=112, d_ff=2048,
        vocab=163_840, vocab_real=163_840,
        param_dtype=torch.bfloat16,
        swa_window=(8_192 if long_ctx else None),
        moe=MoESettings(num_experts=384, num_experts_real=384, top_k=8,
                        d_ff=2048, shared_d_ff=2048, capacity_factor=1.25))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="moe",
    citation="arXiv:2501.kimi2 (Kimi K2)", make_config=make_config,
    notes="384 experts / 16 = 24 per model shard (pure expert parallelism). "
          "bf16 params + SGD-momentum for memory; stale-psum staleness only "
          "(faithful per-worker caches inapplicable at 1T).",
    train_optimizer="momentum", stale_s_default=2, fsdp=True)
