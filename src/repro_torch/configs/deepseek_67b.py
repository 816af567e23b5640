"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016,
vocab=102400, llama-arch. [arXiv:2401.02954]

95 layers compile depth-independently via scan-over-layers. SGD-momentum +
bf16 params for the dry-run memory budget (67B Adam fp32 state would be
~1 TB). Mixed-mode attention sharding (64 q-heads / 16; kv=8 replicated
weights, sequence-sharded decode cache).
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "deepseek-67b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256,
            vocab=512, vocab_real=500, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return TransformerConfig(
        name=ARCH_ID, num_layers=95, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22_016,
        vocab=102_400, vocab_real=102_400,
        param_dtype=torch.bfloat16,
        swa_window=(8_192 if long_ctx else None))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="dense",
    citation="arXiv:2401.02954 (DeepSeek LLM)", make_config=make_config,
    notes="bf16 params + SGD-momentum for memory; long_500k uses the "
          "swa_window=8192 variant.",
    train_optimizer="momentum", stale_s_default=2, fsdp=True)
