"""Architecture registry (port of ``repro/configs/__init__.py``):
``get(arch_id)`` / ``list_archs()`` / ``SHAPES``.

Every arch id of the JAX package is ported with its ``reduced`` variant:
the four dense transformers, the two MoE transformers, the pure-SSM
``mamba2-1.3b``, the hybrid ``zamba2-7b``, the encoder-decoder
``whisper-base`` and the cross-attention VLM ``llama-3.2-vision-11b``.
"""
from repro_torch.configs.base import (SHAPES, ArchDef, InputShape, ModelAPI,
                                      count_params)

from repro_torch.configs import (deepseek_67b, deepseek_7b, h2o_danube_1p8b,
                                 kimi_k2_1t_a32b, llama32_vision_11b,
                                 mamba2_1p3b, qwen2_moe_a2p7b, qwen3_14b,
                                 whisper_base, zamba2_7b)

REGISTRY = {m.ARCH.arch_id: m.ARCH
            for m in (qwen2_moe_a2p7b, qwen3_14b, zamba2_7b, h2o_danube_1p8b,
                      kimi_k2_1t_a32b, whisper_base, mamba2_1p3b,
                      deepseek_67b, llama32_vision_11b, deepseek_7b)}


def get(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs():
    return list(REGISTRY)


__all__ = ["SHAPES", "ArchDef", "InputShape", "ModelAPI", "count_params",
           "get", "list_archs", "REGISTRY"]
