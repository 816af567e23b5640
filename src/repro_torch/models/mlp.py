"""DNN / MLR models from the paper (Section 3.1), port of
``repro/models/mlp.py``.

DNNs: 0-6 hidden layers of 256 ReLU units + softmax; MLR is the
0-hidden-layer special case. Params keep the JAX layout,
``{"layers": [{"w": [d_in, d_out], "b": [d_out]}, ...]}``.

Every function also takes worker-stacked params (``w: [P, d_in, d_out]``,
``b: [P, d_out]``) with batches ``x: [P, b, d_in]``, ``y: [P, b]``: the
products become batched matmuls and ``loss_fn`` returns the ``[P]``
per-worker losses. That leading axis is the port's written-out ``vmap``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 256
    depth: int = 1          # number of hidden layers; 0 == MLR
    num_classes: int = 10


def init(key, cfg: MLPConfig, device=None) -> Any:
    """He init for ReLU hidden layers, Glorot-ish for the softmax layer.
    ``key`` is an int seed or a ``torch.Generator`` on ``device``; the draws
    differ from ``jax.random``'s (use ``convert.params_from_jax`` for
    identical weights)."""
    dev = device_lib.resolve(device)
    gen = key if isinstance(key, torch.Generator) else device_lib.generator(key, dev)
    dims = [cfg.in_dim] + [cfg.hidden] * cfg.depth + [cfg.num_classes]
    params = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        scale = math.sqrt(2.0 / d_in) if i < len(dims) - 2 else math.sqrt(1.0 / d_in)
        w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
        params.append({
            "w": (w * scale).to(dev),
            "b": torch.zeros((d_out,), device=dev),
        })
    return {"layers": params}


def apply(params: Any, x: torch.Tensor) -> torch.Tensor:
    h = x
    layers = params["layers"]
    for layer in layers[:-1]:
        h = F.relu(h @ layer["w"] + layer["b"].unsqueeze(-2))
    out = layers[-1]
    return h @ out["w"] + out["b"].unsqueeze(-2)


def loss_fn(params: Any, batch) -> torch.Tensor:
    """Mean cross-entropy over the batch axis: a scalar, or ``[P]`` for
    worker-stacked params and batches."""
    x, y = batch
    logp = F.log_softmax(apply(params, x), dim=-1)
    picked = torch.take_along_dim(logp, y.long().unsqueeze(-1), dim=-1)
    return -picked.squeeze(-1).mean(dim=-1)


def accuracy(params: Any, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(apply(params, x), dim=-1) == y.long()).float().mean()
