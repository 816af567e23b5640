"""L2-regularized matrix factorization (paper Section 3.1), port of
``repro/models/mf.py``.

min_{L,R} 1/|D| sum_{(i,j) in D} (D_ij - L_i . R_j)^2 + lambda(|L|_F^2+|R|_F^2)

Observations are partitioned across workers; ``{"L": [U, r], "R": [I, r]}``
is the shared model. ``make_loss_fn``'s loss also takes worker-stacked
params (``[P, U, r]``, ``[P, I, r]``) with ``rows, cols, vals: [P, b]`` and
returns the ``[P]`` per-worker losses.

The training loss gathers a batch's rows of L and R as a one-hot product:
the gather of a gather is a scatter-add, and PyTorch's CUDA scatter-adds
accumulate duplicate indices with float atomics in no fixed order, so two
replays of a step would differ. The one-hot product's backward is a
matmul, which sums in a fixed order, and its forward picks each row exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class MFConfig:
    num_users: int
    num_items: int
    rank: int = 5
    lam: float = 1e-4


def init(key, cfg: MFConfig, device=None) -> Any:
    """Normal rows scaled by ``1/sqrt(rank)``. ``key`` is an int seed or a
    ``torch.Generator`` on ``device``; the draws differ from
    ``jax.random``'s (use ``convert.params_from_jax`` for identical
    weights)."""
    dev = device_lib.resolve(device)
    gen = key if isinstance(key, torch.Generator) else device_lib.generator(key, dev)
    scale = 1.0 / math.sqrt(cfg.rank)

    def normal(n):
        return (torch.randn((n, cfg.rank), generator=gen, device=gen.device)
                * scale).to(dev)

    return {"L": normal(cfg.num_users), "R": normal(cfg.num_items)}


def _one_hot_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx, :]`` per worker as ``one_hot(idx) @ table``."""
    hot = torch.zeros(idx.shape + (table.shape[-2],), dtype=table.dtype,
                      device=table.device)
    hot.scatter_(-1, idx.long().unsqueeze(-1), 1.0)
    return hot @ table


def _objective(lr, rc, vals, params, lam):
    pred = torch.sum(lr * rc, dim=-1)
    mse = torch.mean((vals - pred) ** 2, dim=-1)
    reg = lam * (torch.sum(params["L"] ** 2, dim=(-2, -1))
                 + torch.sum(params["R"] ** 2, dim=(-2, -1)))
    return mse + reg


def make_loss_fn(cfg: MFConfig):
    def loss_fn(params, batch):
        rows, cols, vals = batch
        return _objective(_one_hot_rows(params["L"], rows),
                          _one_hot_rows(params["R"], cols), vals, params,
                          cfg.lam)
    return loss_fn


def full_objective(params, rows, cols, vals, cfg: MFConfig) -> torch.Tensor:
    """The paper's reported metric: the objective over ALL observations
    (no gradient, so a plain gather)."""
    return _objective(params["L"][rows.long()], params["R"][cols.long()],
                      vals, params, cfg.lam)
