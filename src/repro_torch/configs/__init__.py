"""Architecture registry (port of ``repro/configs/__init__.py``):
``get(arch_id)`` / ``list_archs()`` / ``SHAPES``.

The four dense transformers, the two MoE transformers, the pure-SSM
``mamba2-1.3b`` and the hybrid ``zamba2-7b`` are ported with their
``reduced`` variants. The other two arch ids stay registered with their
family and citation; their ``api()`` raises ``NotImplementedError`` until
their families are ported (ROADMAP A.10).
"""
from repro_torch.configs.base import (SHAPES, ArchDef, InputShape, ModelAPI,
                                      count_params)

from repro_torch.configs import (deepseek_67b, deepseek_7b, h2o_danube_1p8b,
                                 kimi_k2_1t_a32b, mamba2_1p3b,
                                 qwen2_moe_a2p7b, qwen3_14b, zamba2_7b)

# arch_id, family, arch_type, citation (the JAX package's entries).
_NOT_PORTED = (
    ("whisper-base", "encdec", "audio", "arXiv:2212.04356 (Whisper)"),
    ("llama-3.2-vision-11b", "transformer", "vlm",
     "hf:meta-llama/Llama-3.2-11B-Vision"),
)

REGISTRY = {m.ARCH.arch_id: m.ARCH
            for m in (qwen2_moe_a2p7b, qwen3_14b, zamba2_7b, h2o_danube_1p8b,
                      kimi_k2_1t_a32b, mamba2_1p3b, deepseek_67b,
                      deepseek_7b)}
REGISTRY.update({arch_id: ArchDef(arch_id=arch_id, family=family,
                                  arch_type=arch_type, citation=citation)
                 for arch_id, family, arch_type, citation in _NOT_PORTED})


def get(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs():
    return list(REGISTRY)


__all__ = ["SHAPES", "ArchDef", "InputShape", "ModelAPI", "count_params",
           "get", "list_archs", "REGISTRY"]
