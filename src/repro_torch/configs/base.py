"""Architecture registry plumbing (port of ``repro/configs/base.py``): input
shapes, the uniform model API and ``ArchDef``.

All four families are ported (``transformer_api``, ``ssm_api``,
``hybrid_api``, ``encdec_api``). ``init`` and ``init_cache`` take a
``device``: CUDA unless the caller passes ``device="cpu"`` (``"meta"``
makes shapes only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import treemath as tm


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Uniform functional surface over the model families."""
    family: str
    cfg: Any
    init: Callable          # (seed, device=None) -> (params, axes)
    loss: Callable          # (params, batch) -> scalar
    prefill: Callable       # (params, batch) -> (logits, cache)
    decode: Callable        # (params, token, cache, pos) -> (logits, cache)
    init_cache: Callable    # (batch, seq_len, device=None) -> (cache, axes)
    batch_spec: Callable    # (InputShape) -> {name: (shape, dtype)}
    vocab_real: int
    # (params, token [S,1], cache, pos [S], kv) -> (logits, 1-token cache):
    # in-place paged decode against a serving.cache.PagedKV page pool.
    # None = no paged path (the serve planner takes the gather route).
    decode_paged: Optional[Callable] = None
    # (params, tokens [[1,1] a slot], caches [a slot], positions [int a
    # slot]) -> ([logits a slot], [cache a slot]): ``decode`` of every
    # slot, each param read once for all of them. None = one ``decode``
    # call a slot.
    decode_slots: Optional[Callable] = None


def _token_spec(shape: InputShape):
    n = shape.seq_len + 1 if shape.kind == "train" else shape.seq_len
    return {"tokens": ((shape.global_batch, n), torch.int32)}


def transformer_api(cfg) -> ModelAPI:
    """Dense and MoE transformers; a cross-attention model (the VLM) also
    takes ``cross_feats`` ``[B, cross_tokens, cross_dim]`` in its batch."""
    from repro_torch.models import transformer as tr

    def prefill(params, batch):
        logits, _aux, cache = tr.forward(params, batch["tokens"], cfg,
                                         cross_feats=batch.get("cross_feats"),
                                         return_cache=True)
        return logits[:, -1:], cache

    def batch_spec(shape: InputShape):
        spec = _token_spec(shape)
        if cfg.num_cross_layers:
            spec["cross_feats"] = ((shape.global_batch, cfg.cross_tokens,
                                    cfg.cross_dim), cfg.dtype)
        return spec

    return ModelAPI(
        family="transformer", cfg=cfg,
        init=lambda seed, device=None: tr.init(seed, cfg, device=device),
        loss=lambda params, batch: tr.loss_fn(params, batch, cfg),
        prefill=prefill,
        decode=lambda params, token, cache, pos: tr.decode_step(
            params, token, cache, pos, cfg),
        decode_paged=lambda params, token, cache, pos, kv:
            tr.decode_step_paged(params, token, cache, pos, kv, cfg),
        decode_slots=lambda params, tokens, caches, positions:
            tr.decode_slots(params, tokens, caches, positions, cfg),
        init_cache=lambda b, s, device=None: tr.init_cache(cfg, b, s,
                                                           device=device),
        batch_spec=batch_spec,
        vocab_real=cfg.vocab_real,
    )


def ssm_api(cfg) -> ModelAPI:
    """The pure-SSM LM: its decode cache has no token axis (the serving
    plane keeps it resident), and decode is ``lm_forward`` on one token."""
    from repro_torch.models import ssm

    def prefill(params, batch):
        logits, cache = ssm.lm_forward(params, batch["tokens"], cfg,
                                       return_cache=True)
        return logits[:, -1:], cache

    def decode(params, token, cache, pos):
        return ssm.lm_forward(params, token, cfg, cache=cache)

    return ModelAPI(
        family="ssm", cfg=cfg,
        init=lambda seed, device=None: ssm.lm_init(seed, cfg, device=device),
        loss=lambda params, batch: ssm.lm_loss(params, batch, cfg),
        prefill=prefill,
        decode=decode,
        init_cache=lambda b, s, device=None: ssm.lm_cache_init(
            cfg, b, device=device),
        batch_spec=_token_spec,
        vocab_real=cfg.vocab_real,
    )


def hybrid_api(cfg) -> ModelAPI:
    """The mamba + shared-attention hybrid. No ``decode_paged``, as in the
    JAX package: the serving plane takes the gather route."""
    from repro_torch.models import hybrid

    def prefill(params, batch):
        logits, _aux, cache = hybrid.forward(params, batch["tokens"], cfg,
                                             return_cache=True)
        return logits[:, -1:], cache

    return ModelAPI(
        family="hybrid", cfg=cfg,
        init=lambda seed, device=None: hybrid.init(seed, cfg, device=device),
        loss=lambda params, batch: hybrid.loss_fn(params, batch, cfg),
        prefill=prefill,
        decode=lambda params, token, cache, pos: hybrid.decode_step(
            params, token, cache, pos, cfg),
        init_cache=lambda b, s, device=None: hybrid.init_cache(
            cfg, b, s, device=device),
        batch_spec=_token_spec,
        vocab_real=cfg.vocab_real,
    )


def encdec_api(cfg) -> ModelAPI:
    """The Whisper-style encoder-decoder: its batch carries ``frames``
    ``[B, num_frames, d_model]`` beside the tokens; the decoder's cross K/V
    ride in the cache as ``xk``/``xv``, so it serves on the paged route."""
    from repro_torch.models import encdec

    def prefill(params, batch):
        logits, _aux, cache = encdec.forward(
            params, batch["tokens"], batch["frames"], cfg, return_cache=True)
        return logits[:, -1:], cache

    def batch_spec(shape: InputShape):
        spec = _token_spec(shape)
        spec["frames"] = ((shape.global_batch, cfg.num_frames, cfg.d_model),
                          cfg.dtype)
        return spec

    return ModelAPI(
        family="encdec", cfg=cfg,
        init=lambda seed, device=None: encdec.init(seed, cfg, device=device),
        loss=lambda params, batch: encdec.loss_fn(params, batch, cfg),
        prefill=prefill,
        decode=lambda params, token, cache, pos: encdec.decode_step(
            params, token, cache, pos, cfg),
        decode_paged=lambda params, token, cache, pos, kv:
            encdec.decode_step_paged(params, token, cache, pos, kv, cfg),
        init_cache=lambda b, s, device=None: encdec.init_cache(
            cfg, b, s, device=device),
        batch_spec=batch_spec,
        vocab_real=cfg.vocab_real,
    )


_API_BUILDERS = {"transformer": transformer_api, "ssm": ssm_api,
                 "hybrid": hybrid_api, "encdec": encdec_api}


@dataclasses.dataclass(frozen=True)
class ArchDef:
    """One assigned architecture. ``make_config(reduced, long_ctx)`` returns
    the family config."""
    arch_id: str
    family: str                 # transformer | ssm | hybrid | encdec
    arch_type: str              # dense | moe | ssm | hybrid | audio | vlm
    citation: str
    make_config: Callable[..., Any]
    notes: str = ""
    train_optimizer: str = "adam"
    stale_s_default: int = 4
    # Params sharded over the data axis (the JAX package's FSDP placement,
    # ``sharding/rules.py``): the engine keeps their tree layout and gives
    # stale-psum the aggregate ring. Their init draws a stacked leaf a
    # layer at a time, so a rank keeps its blocks as they are drawn.
    fsdp: bool = False

    def api(self, reduced: bool = False, long_ctx: bool = False,
            overrides: Optional[dict] = None) -> ModelAPI:
        cfg = self.make_config(reduced=reduced, long_ctx=long_ctx)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        api = _API_BUILDERS[self.family](cfg)
        if not self.fsdp:
            return api
        from repro_torch.models import layers
        init = api.init

        def init_by_layer(seed, device=None):
            with layers.draw_by_layer():
                return init(seed, device=device)
        return dataclasses.replace(api, init=init_by_layer)


def count_params(api: ModelAPI) -> int:
    params, _ = api.init(0, device="meta")
    return sum(math.prod(x.shape) for x in tm.tree_leaves(params))


def param_axes(api: ModelAPI):
    """The logical-axes tree of an arch's params, made on the meta device
    (nothing is allocated)."""
    return api.init(0, device="meta")[1]
