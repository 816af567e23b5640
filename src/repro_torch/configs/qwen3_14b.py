"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408,
vocab=151936, qk-norm. [hf:Qwen/Qwen3-8B family scaling]

Sharding note: 40 heads do not divide the 16-way model axis, so attention
weights use contraction-mode sharding (q/k/v on d_model-in, wo on head_dim);
the FFN stays column/row-parallel. Recorded in the roofline table.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen3-14b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=160,
            num_heads=5, num_kv_heads=1, head_dim=32, d_ff=384,
            vocab=512, vocab_real=500, qk_norm=True, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return TransformerConfig(
        name=ARCH_ID, num_layers=40, d_model=5120,
        num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17_408,
        vocab=151_936, vocab_real=151_936, qk_norm=True,
        swa_window=(8_192 if long_ctx else None))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="dense",
    citation="hf:Qwen/Qwen3-8B (14B-scale config per assignment)",
    make_config=make_config,
    notes="qk_norm + GQA kv=8. 40 q-heads !% 16 -> contraction-mode attention "
          "sharding; long_500k uses the swa_window=8192 variant.",
    train_optimizer="adam")
