"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, vocab=50280 (padded
to 50288), ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]

d_inner = 4096 -> 64 SSD heads of dim 64, state 128. long_500k is native:
decode state is O(1) in context length.
"""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.ssm import MambaLMConfig, SSMSettings

ARCH_ID = "mamba2-1.3b"


def make_config(reduced: bool = False, long_ctx: bool = False) -> MambaLMConfig:
    if reduced:
        return MambaLMConfig(
            name=ARCH_ID + "-reduced", num_layers=2, d_model=128,
            vocab=512, vocab_real=500,
            ssm=SSMSettings(d_model=128, d_state=16, head_dim=32, expand=2,
                            chunk=16, conv_width=4),
            dtype=torch.float32, param_dtype=torch.float32, remat=False)
    return MambaLMConfig(
        name=ARCH_ID, num_layers=48, d_model=2048,
        vocab=50_288, vocab_real=50_280,
        ssm=SSMSettings(d_model=2048, d_state=128, head_dim=64, expand=2,
                        chunk=256, conv_width=4))


ARCH = ArchDef(
    arch_id=ARCH_ID, family="ssm", arch_type="ssm",
    citation="arXiv:2405.21060 (Mamba2/SSD)", make_config=make_config,
    notes="Attention-free: the paper's staleness technique applies to the "
          "update rule unchanged; no KV cache, decode is O(1) state. Vocab "
          "padded 50280 -> 50288.",
    train_optimizer="adam")
