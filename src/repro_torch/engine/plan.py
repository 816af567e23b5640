"""Step planning (port of ``repro/engine/plan.py``).

A :class:`Plan` is the step callable plus its ``meta``. There is no jit, no
mesh and no shardings: the port runs eagerly on one GPU, so a plan is the
function the JAX package would lower.

* ``make_train_engine``: one call from (arch x shape) to a train engine on
  one device, with the JAX package's ``stale_s``/``mode`` semantics. The
  JAX package also attaches a sharding plan to the engine
  (``attach_train_plan``: state and batch shardings, donation, a lowered
  step); that waits for multi-GPU placement (ROADMAP A.12), and
  ``mesh=`` raises.
* ``plan_prefill`` / ``plan_decode``: inference steps over an arch.
* ``resolve_serve_paged`` + ``plan_serve_step``: the serving plane's
  continuous-batching decode step, on the gather route (the reference) or
  the paged route (the CUDA page-table attention kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch import configs as cfglib
from repro_torch import treemath as tm
from repro_torch.configs.base import SHAPES, ArchDef, InputShape, ModelAPI

ShapeLike = Union[str, InputShape]


@dataclasses.dataclass
class Plan:
    """One step: ``plan(*args)`` runs ``fn`` (under ``torch.no_grad``)."""
    fn: Callable
    meta: dict

    def __call__(self, *args):
        with torch.no_grad():
            return self.fn(*args)


def make_train_engine(arch: Union[str, ArchDef], shape: ShapeLike,
                      mesh=None, *, ecfg=None, mode: Optional[str] = None,
                      stale_s: Optional[int] = None,
                      num_workers: Optional[int] = None,
                      optimizer_name: Optional[str] = None,
                      remat_override: Optional[bool] = None,
                      overrides: Optional[dict] = None,
                      reduced: bool = False, device=None,
                      **engine_kw):
    """One call from (arch x shape) to a train engine on ``device`` (CUDA
    unless ``device="cpu"``).

    ``stale_s`` keeps the JAX package's semantics: None/0 -> the
    synchronous baseline, >= 1 -> the paper's stale-psum step with that
    bound (unless ``mode`` selects another regime). FSDP archs get the
    aggregate ring (``per_worker_delays=False``) in stale-psum, as in the
    JAX package. Extra ``engine_kw`` land on ``EngineConfig``; a full
    ``ecfg`` controls everything. With no mesh the worker count defaults
    to 1, the JAX package's data extent of a one-device mesh. The fused
    Adam opt-in follows the engine's placement verdict."""
    from repro_torch.engine.api import (EngineConfig, build_engine,
                                        kernel_placement_ok)
    from repro_torch.optim import optimizers as optlib

    arch = cfglib.get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    assert shape.kind == "train", shape.name
    overrides = dict(overrides or {})
    if remat_override is not None:
        overrides["remat"] = remat_override
    api = arch.api(reduced=reduced, overrides=overrides or None)
    opt_name = optimizer_name or arch.train_optimizer

    if ecfg is not None:
        clashing = {k: v for k, v in dict(
            mode=mode, stale_s=stale_s, num_workers=num_workers,
            **engine_kw).items() if v is not None}
        if clashing:
            raise ValueError(
                f"ecfg= fully specifies the engine; also passing "
                f"{sorted(clashing)} would be silently ignored")
    if ecfg is None:
        if mode in (None, "auto"):
            mode = "sync" if not stale_s else "stale-psum"
        s = 0 if mode == "sync" else (
            stale_s if stale_s is not None else arch.stale_s_default)
        kw = dict(engine_kw)
        if mode == "stale-psum":
            kw.setdefault("per_worker_delays", not arch.fsdp)
        ecfg = EngineConfig(
            mode=mode, s=s, num_workers=num_workers or 1,
            buffer_dtype=getattr(api.cfg, "param_dtype", torch.float32), **kw)

    fuse_adam = (opt_name == "adam"
                 and kernel_placement_ok(ecfg.kernels, arch, mesh)[0])
    opt = optlib.get_optimizer(opt_name, **({"kernel": True} if fuse_adam
                                            else {}))
    engine = build_engine(api, opt, ecfg, mesh=mesh, arch=arch, shape=shape,
                          device=device)
    engine.meta.update(arch=arch.arch_id, shape=shape.name,
                       optimizer=opt_name)
    return engine


def _resolve(arch, shape, reduced, overrides):
    arch = cfglib.get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    return arch, shape, arch.api(reduced=reduced, overrides=overrides)


def plan_prefill(arch: Union[str, ArchDef], shape: ShapeLike,
                 overrides: Optional[dict] = None,
                 reduced: bool = False) -> Plan:
    """``plan(params, batch) -> (last-position logits [B,1,V], cache)``."""
    arch, shape, api = _resolve(arch, shape, reduced, overrides)
    assert shape.kind == "prefill", shape.name
    return Plan(fn=api.prefill, meta={
        "arch": arch.arch_id, "shape": shape.name, "kind": "prefill",
        "seq_len": shape.seq_len, "batch": shape.global_batch})


def plan_decode(arch: Union[str, ArchDef], shape: ShapeLike,
                overrides: Optional[dict] = None,
                reduced: bool = False) -> Plan:
    """``plan(params, token [B,1], cache, pos) -> (logits, cache)``."""
    arch, shape, api = _resolve(arch, shape, reduced, overrides)
    assert shape.kind == "decode", shape.name
    return Plan(fn=api.decode, meta={
        "arch": arch.arch_id, "shape": shape.name, "kind": "decode",
        "seq_len": shape.seq_len, "batch": shape.global_batch})


def resolve_serve_paged(api: ModelAPI, layout, paged: str = "auto"):
    """Resolve the serve decode route -> ``(route, why)``: ``"paged"`` (the
    in-place page-table attention kernel), ``"gather"`` (the gather ->
    decode -> scatter reference) or ``"resident"`` (no token-major cache
    leaves at all).

    ``"off"`` forces the gather reference; ``"auto"`` and ``"on"`` take the
    paged route wherever the model family has ``decode_paged`` (``"on"``
    raises where it has not). The JAX package also vetoes FSDP archs and
    model-sharded meshes under ``"auto"``; the port runs on one GPU, where
    the packed page view keeps its placement, so nothing vetoes it."""
    if paged not in ("off", "auto", "on"):
        raise ValueError(f"paged={paged!r}: expected off/auto/on")
    if not layout.has_tokens:
        return "resident", "no token-major cache leaves"
    if paged == "off":
        return "gather", "config off"
    if api.decode_paged is None:
        if paged == "on":
            raise ValueError(
                f"paged='on' but family {api.family!r} has no decode_paged")
        return "gather", f"family {api.family!r} has no decode_paged"
    return "paged", ""


def _pick(logits: torch.Tensor, tokens, mask, gen, temp: float):
    """Next token per slot from fp32 logits [S, V]: greedy argmax at
    ``temp <= 0``, else a categorical draw (Gumbel-max over one [S, V]
    block of uniforms from ``gen``, so both routes burn the same draws).
    Masked slots keep their token."""
    if temp > 0:
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        logits = logits / temp - torch.log(-torch.log(u))
    nxt = torch.argmax(logits, dim=-1).to(tokens.dtype)
    return torch.where(mask, nxt, tokens)


def plan_serve_step(arch: Union[str, ArchDef], shape: ShapeLike, *,
                    layout, num_pages: int,
                    overrides: Optional[dict] = None,
                    reduced: bool = False, paged: str = "off") -> Plan:
    """Continuous-batching decode step for the serving plane:
    ``plan(params, pages, resident, tables, tokens, pos, mask, gen, temp)
    -> (next tokens [S], pages, resident)``, advancing every occupied slot
    by one token against the paged cache (``serving.cache.PageLayout``).
    ``pages`` and ``resident`` are updated in place.

    * **gather** (the reference): page-table gather -> each slot's batch-1
      ``api.decode`` at its own position (a loop over slots: the JAX
      package's ``vmap``) -> cursor-addressed whole-page scatter.
    * **paged**: the K/V ring stays put; ``api.decode_paged`` reads it in
      place through the page-table attention kernel and the step writes ONE
      [W] row per slot. Null-page table entries are masked in the kernel,
      so slots may hold only the pages their request touches.

    Masked slots still occupy lanes but are inert: their token is kept and
    their cache write goes to the null page. ``temp <= 0`` is greedy."""
    from repro_torch.kernels import dispatch
    arch, shape, api = _resolve(arch, shape, reduced, overrides)
    assert shape.kind == "decode", shape.name
    slots = shape.global_batch
    route, route_why = resolve_serve_paged(api, layout, paged)
    dispatch.note("serve_decode", route, route_why)

    def serve_step(params, pages, resident, tables, tokens, pos, mask, gen,
                   temp):
        cache = layout.gather(pages, resident, tables)   # [S, ...] leaves
        logits, new_caches = [], []
        for i, p in enumerate(pos.tolist()):
            lg, nc = api.decode(params, tokens[i].reshape(1, 1),
                                tm.tree_map(lambda x: x[i], cache), p)
            logits.append(lg[0, -1].float())
            new_caches.append(nc)
        nxt = _pick(torch.stack(logits), tokens, mask, gen, temp)
        pages, resident = layout.scatter_token(
            pages, resident, tm.tree_stack(new_caches), tables, pos, mask)
        return nxt, pages, resident

    def serve_step_paged(params, pages, resident, tables, tokens, pos, mask,
                         gen, temp):
        cache = layout.unpack_resident(resident)          # token leaves None
        kv = layout.paged_kv(pages, tables, pos)
        logits, new_cache = api.decode_paged(params, tokens[:, None], cache,
                                             pos, kv)
        nxt = _pick(logits[:, -1].float(), tokens, mask, gen, temp)
        pages, resident = layout.scatter_rows(
            pages, resident, new_cache, tables, pos, mask)
        return nxt, pages, resident

    return Plan(
        fn=serve_step_paged if route == "paged" else serve_step,
        meta={"arch": arch.arch_id, "shape": shape.name, "kind": "serve",
              "slots": slots, "seq_len": shape.seq_len,
              "cache_tokens": layout.tokens,
              "page_tokens": layout.page_tokens,
              "pages": num_pages, "resident_width": layout.res_width,
              "paged": route, "paged_why": route_why})

