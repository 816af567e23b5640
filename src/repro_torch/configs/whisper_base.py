"""whisper-base [audio] — 6L (enc+dec each) d_model=512 8H d_ff=2048,
vocab=51865 (padded to 51872 for the 16-way model axis). Enc-dec with a
STUBBED conv/mel frontend: the model consumes precomputed frame embeddings
[B, 1500, 512]. [arXiv:2212.04356]

Note: the assigned decode shapes (32k/500k tokens) far exceed Whisper's real
448-token decoder horizon; they are honoured mechanically.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "whisper-base"


def make_config(reduced: bool = False, long_ctx: bool = False) -> EncDecConfig:
    if reduced:
        return EncDecConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
            vocab=512, vocab_real=500, num_frames=16, tp=1,
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return EncDecConfig(
        name=ARCH_ID, num_layers=6, d_model=512,
        num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048,
        vocab=51_872, vocab_real=51_865, num_frames=1500)


ARCH = ArchDef(
    arch_id=ARCH_ID, family="encdec", arch_type="audio",
    citation="arXiv:2212.04356 (Whisper)", make_config=make_config,
    notes="Conv/mel frontend stubbed to precomputed frame embeddings. 8 heads "
          "!% 16 -> contraction-mode attention sharding. Vocab padded "
          "51865 -> 51872. Decoder-only decode shapes (32k) exceed Whisper's "
          "448-token design; honored mechanically.",
    train_optimizer="adam")
