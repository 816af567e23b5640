"""repro_torch.compensate: staleness compensation between delivery and the
optimizer (port of ``repro.compensate``).

    EngineConfig(lr_scale="none"|"inverse"|"theorem1",   # lr.py
                 compress="none"|"topk:K"|"thresh:V",    # sparsify.py
                 ef_momentum=beta)

* ``lr_scale`` scales each step's effective stepsize: ``inverse`` by the
  realized delay, ``theorem1`` by the paper's stepsize on live mu / L
  signals (``Engine.with_lr_signals``).
* ``compress`` sparsifies each source's transported gradient or update with
  error feedback: the un-sent mass rides in a packed fp32 residual carried
  in ``EngineState.comp``, and the split runs through
  ``kernels.dispatch.sparsify_topk`` (or inside ``fused_update`` on the
  megakernel path). ``ef_momentum`` adds the DGC masked momentum.

With both knobs ``"none"`` the engine builds no compensator and its steps
run the uncompensated code, with ``EngineState.comp == ()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import treemath as tm
from repro_torch.compensate.lr import (LR_POLICIES, init_signals, lr_factor,
                                       scale_tree)
from repro_torch.compensate.sparsify import (COMPRESS_KINDS, EXACT_TOPK_MAX,
                                             TOPK_SAMPLE, parse_compress,
                                             sparsify_with_feedback,
                                             sparsity_of, topk_count,
                                             topk_threshold)
from repro_torch.kernels import dispatch

__all__ = [
    "COMPRESS_KINDS", "CompensateConfig", "Compensator", "EXACT_TOPK_MAX",
    "LR_POLICIES", "TOPK_SAMPLE", "init_signals", "lr_factor",
    "parse_compress", "scale_tree", "sparsify_with_feedback", "topk_count",
    "topk_threshold",
]


@dataclasses.dataclass(frozen=True)
class CompensateConfig:
    """Validated compensation knobs (one per EngineConfig)."""
    lr_scale: str = "none"     # none | inverse | theorem1
    compress: str = "none"     # none | topk:K | thresh:V
    s: int = 0                 # staleness bound (theorem1 denominator)
    ef_momentum: float = 0.0   # DGC masked-momentum beta (0 = plain EF)

    def __post_init__(self):
        if self.lr_scale not in LR_POLICIES:
            raise ValueError(f"lr_scale must be one of {LR_POLICIES}, "
                             f"got {self.lr_scale!r}")
        parse_compress(self.compress)  # raises on bad grammar
        if not 0.0 <= self.ef_momentum < 1.0:
            raise ValueError("ef_momentum must be in [0, 1), got "
                             f"{self.ef_momentum!r}")
        if self.ef_momentum > 0 and self.compress == "none":
            raise ValueError("ef_momentum corrects the EF sparsifier; it "
                             "needs compress != 'none'")

    @property
    def active(self) -> bool:
        return self.lr_scale != "none" or self.compress != "none"


class Compensator:
    """The compensation pipeline the core steps call. Its state lives in
    the comp dict (``EngineState.comp``) built by :meth:`init`; every shape
    is re-derived from the tensors it is handed."""

    def __init__(self, cfg: CompensateConfig, shard=None):
        self.cfg = cfg
        self.kind, self.amount = parse_compress(cfg.compress)
        # On a model axis (``engine.placement.MeshPlacement`` whose packed
        # views are parts of one process's row): the threshold and the
        # sparsity are the whole row's.
        self.shard = shard

    @property
    def sparsifies(self) -> bool:
        return self.kind != "none"

    @property
    def scales(self) -> bool:
        return self.cfg.lr_scale != "none"

    # -- comp state --------------------------------------------------------
    def init(self, params, num_workers: Optional[int] = None) -> dict:
        """The LR policy's signals plus, when sparsifying, the zero packed
        residual (padded like the gradient ring) and, with
        ``ef_momentum > 0``, the DGC momentum rows in the same layout.
        ``num_workers`` selects the per-source ``[P, D]`` layout."""
        dev = tm.tree_leaves(params)[0].device
        comp = dict(init_signals(self.cfg.lr_scale, device=dev))
        if self.sparsifies:
            width = tm.padded_size(tm.pack_spec(params).total,
                                   dispatch.PACK_ALIGN)
            shape = (num_workers, width) if num_workers else (width,)
            comp["resid"] = torch.zeros(shape, device=dev)
            if self.cfg.ef_momentum > 0:
                comp["mom"] = torch.zeros(shape, device=dev)
        return comp

    # -- sparsification ----------------------------------------------------
    def ef_inputs(self, comp: dict, vec: torch.Tensor, true_size: int):
        """Accumulate this step's packed rows into the EF state and derive
        each row's threshold WITHOUT splitting (the ``fused_update`` kernel
        splits). Returns ``(acc, thr, mom_in)``; ``mom_in`` is None without
        momentum, else the pre-mask velocity ``beta * mom + vec``."""
        beta = self.cfg.ef_momentum
        if beta > 0:
            mom_in = beta * comp["mom"] + vec
            acc = mom_in + comp["resid"]
        else:
            mom_in = None
            acc = vec + comp["resid"]
        if self.kind == "topk" and self.shard is not None:
            thr = self.shard.row_threshold(
                acc.abs(), topk_count(self.amount, self.shard.row().total))
        elif self.kind == "topk":
            thr = topk_threshold(acc.abs(), topk_count(self.amount, true_size),
                                 true_size)
        else:  # thresh
            thr = torch.full(acc.shape[:-1], self.amount, device=acc.device)
        return acc, thr, mom_in

    def ef_commit(self, comp: dict, resid, mom=None) -> dict:
        """Thread the post-split EF state back into the comp dict."""
        comp = {**comp, "resid": resid}
        if mom is not None:
            comp["mom"] = mom
        return comp

    def ef_metrics(self, sent, true_size: int) -> dict:
        """Realized sparsity of a sent payload over its real entries (the
        whole row's on a model axis)."""
        if self.shard is not None:
            return {"sparsity": self.shard.row_sparsity(sent)}
        return {"sparsity": sparsity_of(sent, true_size)}

    def sparsify_tree(self, comp: dict, tree, lead_ndim: int = 0):
        """EF-sparsify a gradient/update tree via its packed flat view.
        Returns ``(tree', comp', metrics)``; a no-op for compress='none'."""
        if not self.sparsifies:
            return tree, comp, {}
        spec = tm.pack_spec(tree, lead_ndim=lead_ndim)
        vec = tm.tree_pack(tree, lead_ndim=lead_ndim,
                           pad_to=dispatch.PACK_ALIGN)
        sent, comp, metrics = self.sparsify_packed(comp, vec, spec.total)
        return tm.tree_unpack(sent, spec), comp, metrics

    def sparsify_packed(self, comp: dict, vec, true_size: int):
        """Full EF split of a packed view: accumulate, threshold, split
        through ``dispatch.sparsify_topk``, and (with momentum) zero the
        velocity where the split kept the value."""
        if not self.sparsifies:
            return vec, comp, {}
        acc, thr, mom_in = self.ef_inputs(comp, vec, true_size)
        sent, resid = dispatch.sparsify_topk(acc, thr)
        mom_out = None
        if mom_in is not None:
            keep = acc.abs() >= thr.unsqueeze(-1)
            mom_out = torch.where(keep, torch.zeros_like(mom_in), mom_in)
        return (sent, self.ef_commit(comp, resid, mom_out),
                self.ef_metrics(sent, true_size))

    # -- LR scaling --------------------------------------------------------
    def lr_factor(self, comp: dict, staleness, step: int):
        """Per-step stepsize factor (1.0 for lr_scale='none')."""
        if not self.scales:
            return 1.0
        return lr_factor(self.cfg.lr_scale, comp, staleness, step, self.cfg.s)

    def scale_tree(self, tree, factor):
        return scale_tree(tree, factor)
