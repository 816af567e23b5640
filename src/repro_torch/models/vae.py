"""Variational autoencoder trained by blackbox VI (paper Section 3.1), port
of ``repro/models/vae.py``.

Encoder and decoder are DNNs with 1-3 hidden layers of 256 ReLU units; the
prior is an isotropic Gaussian, the observation model a Gaussian of fixed
scale. The training objective is the negative ELBO through the
reparameterization trick, stochastic in both the data batch and epsilon.

Params keep the JAX layout, ``{"enc": [{"w": [d_in, d_out], "b": [d_out]},
...], "dec": [...]}``. Every function also takes worker-stacked params
(``w: [P, d_in, d_out]``, ``b: [P, d_out]``) with ``x: [P, b, in_dim]``,
and the loss then returns the ``[P]`` per-worker losses. Epsilon is drawn
from a ``torch.Generator`` in place of a ``jax.random`` key, one draw of the
whole ``[P, b, latent]`` block a call; ``eps=`` takes a pre-drawn one (the
parity tests inject JAX's draws).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_dim: int = 784
    hidden: int = 256
    depth: int = 1          # layers in encoder and decoder, separately
    latent: int = 32
    obs_scale: float = 1.0  # fixed Gaussian observation noise


def _mlp_init(gen, dims, dev):
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
        params.append({"w": (w * math.sqrt(2.0 / d_in)).to(dev),
                       "b": torch.zeros((d_out,), device=dev)})
    return params


def _mlp(params, x):
    h = x
    for layer in params[:-1]:
        h = F.relu(h @ layer["w"] + layer["b"].unsqueeze(-2))
    return h @ params[-1]["w"] + params[-1]["b"].unsqueeze(-2)


def init(key, cfg: VAEConfig, device=None) -> Any:
    """He-scaled normal weights, zero biases. ``key`` is an int seed or a
    ``torch.Generator`` on ``device``; the draws differ from
    ``jax.random``'s (use ``convert.params_from_jax`` for identical
    weights)."""
    dev = device_lib.resolve(device)
    gen = key if isinstance(key, torch.Generator) else device_lib.generator(key, dev)
    enc_dims = [cfg.in_dim] + [cfg.hidden] * cfg.depth + [2 * cfg.latent]
    dec_dims = [cfg.latent] + [cfg.hidden] * cfg.depth + [cfg.in_dim]
    return {"enc": _mlp_init(gen, enc_dims, dev),
            "dec": _mlp_init(gen, dec_dims, dev)}


def elbo_loss(params: Any, batch, gen, cfg: VAEConfig,
              eps: torch.Tensor = None) -> torch.Tensor:
    """Negative ELBO per datum (lower is better); ``batch`` is ``(x,)`` or
    ``x``. Draws ``eps`` from ``gen`` unless given."""
    x = batch[0] if isinstance(batch, (tuple, list)) else batch
    mean, logvar = torch.chunk(_mlp(params["enc"], x), 2, dim=-1)
    logvar = torch.clamp(logvar, -8.0, 8.0)
    if eps is None:
        eps = torch.randn(mean.shape, generator=gen,
                          device=gen.device).to(mean.device)
    z = mean + torch.exp(0.5 * logvar) * eps
    recon = _mlp(params["dec"], z)

    inv_var = 1.0 / (cfg.obs_scale ** 2)
    log_px = -0.5 * torch.sum(
        inv_var * (x - recon) ** 2
        + math.log(2 * math.pi * cfg.obs_scale ** 2), dim=-1)
    kl = -0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar), dim=-1)
    return torch.mean(-log_px + kl, dim=-1)


def make_loss_fn(cfg: VAEConfig):
    def loss_fn(params, batch, gen):
        return elbo_loss(params, batch, gen, cfg)
    return loss_fn


def test_loss(params: Any, x: torch.Tensor, gen, cfg: VAEConfig,
              num_samples: int = 4, eps=None) -> torch.Tensor:
    """The ELBO loss averaged over ``num_samples`` draws of epsilon (from
    ``gen`` in turn, or the ``eps`` list)."""
    eps = eps if eps is not None else [None] * num_samples
    losses = torch.stack([elbo_loss(params, (x,), gen, cfg, eps=e)
                          for e in eps])
    return losses.mean(dim=0)
