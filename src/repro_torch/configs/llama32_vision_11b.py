"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=128256, cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision encoder is a STUB: the model consumes precomputed patch
embeddings [B, 1601, 1280] (1601 = 40x40 patches + CLS, 1280 = vision hidden
dim); the cross-attention K/V projections act as the bridge/projector.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama-3.2-vision-11b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name=ARCH_ID + "-reduced", num_layers=4, d_model=128,
            num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab=512, vocab_real=500, tp=1,
            cross_attn_period=2, cross_tokens=16, cross_dim=64,
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return TransformerConfig(
        name=ARCH_ID, num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14_336,
        vocab=128_256, vocab_real=128_256,
        cross_attn_period=5, cross_tokens=1601, cross_dim=1280,
        swa_window=(8_192 if long_ctx else None))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="transformer", arch_type="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision", make_config=make_config,
    notes="Vision encoder stubbed to precomputed patch embeddings "
          "[B,1601,1280]; 8 gated cross-attn layers (every 5th). long_500k "
          "uses the swa_window=8192 variant (self-attn only; cross K/V are "
          "fixed 1601 tokens).",
    train_optimizer="adam")
