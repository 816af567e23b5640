"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008,
vocab=102400, llama-arch. [arXiv:2401.02954]
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "deepseek-7b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
            vocab=512, vocab_real=500, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return TransformerConfig(
        name=ARCH_ID, num_layers=30, d_model=4096,
        num_heads=32, num_kv_heads=32, head_dim=128, d_ff=11_008,
        vocab=102_400, vocab_real=102_400,
        swa_window=(8_192 if long_ctx else None))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="dense",
    citation="arXiv:2401.02954 (DeepSeek LLM)", make_config=make_config,
    notes="MHA (kv=32): head-mode attention sharding. long_500k uses the "
          "swa_window=8192 variant.",
    train_optimizer="adam")
