"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912,
vocab=32000, llama+mistral mix with native sliding-window attention.
[arXiv:2401.16818]

Native SWA (4096) means long_500k runs this arch as-is — the KV ring buffer
is bounded by the window, not the 524288-token context.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "h2o-danube-1.8b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256,
            vocab=512, vocab_real=500, swa_window=16, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return TransformerConfig(
        name=ARCH_ID, num_layers=24, d_model=2560,
        num_heads=32, num_kv_heads=8, head_dim=80, d_ff=6912,
        vocab=32_000, vocab_real=32_000, swa_window=4096)


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="dense",
    citation="arXiv:2401.16818 (H2O-Danube)", make_config=make_config,
    notes="Native sliding window 4096 (paper's mistral-style SWA); "
          "mixed-mode attention sharding (q head-sharded, kv replicated, "
          "decode cache sequence-sharded).",
    train_optimizer="adam")
