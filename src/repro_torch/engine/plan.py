"""Step planning over a mesh (port of ``repro/engine/plan.py``).

A :class:`Plan` is a step callable plus its abstract arguments (meta-device
tensors: nothing here allocates device memory), the placement of each
argument as a tree of spec tuples (``sharding/rules.py``: what
``tuple(jax.sharding.PartitionSpec)`` gives) and its ``meta``. Steps run
eagerly, so a plan is the function the JAX package would lower, and its
specs say where each leaf lives on a mesh.

* ``make_train_engine(arch, shape, mesh, ...)``: one call from (arch x
  shape x mesh) to a train engine; with a mesh the engine carries its plan
  (``attach_train_plan``: state and batch specs for the four modes, the
  FSDP ``embed -> data`` rule, the aggregate ring). A ``DeviceMesh`` runs
  it across ranks (``engine/placement.py``); an ``AbstractMesh`` (e.g.
  ``launch.mesh.make_production_mesh()``) plans on the meta device.
* ``plan_prefill`` / ``plan_decode``: inference steps over an arch (mesh
  third, None for one device); ``long_500k`` builds the long-context
  config (the sliding window of ``qwen3-14b`` and ``zamba2-7b``).
* ``resolve_serve_paged`` + ``plan_serve_step``: the serving plane's
  continuous-batching decode step, on the gather route (the reference) or
  the paged route (the CUDA page-table attention kernel), with the JAX
  planner's placement veto and, on a mesh, its specs.
* ``build``: the dispatcher by kind.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from repro_torch import configs as cfglib
from repro_torch import treemath as tm
from repro_torch.configs.base import SHAPES, ArchDef, InputShape, ModelAPI
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.rules import FSDP_ARCHS  # noqa: F401  (re-exported)

ShapeLike = Union[str, InputShape]


@dataclasses.dataclass
class Plan:
    """One step: ``plan(*args)`` runs ``fn`` (under ``torch.no_grad``).
    ``args`` are abstract (meta-device) arguments, ``in_shardings`` /
    ``out_shardings`` trees of spec tuples (None without a mesh)."""
    fn: Callable
    meta: dict
    args: tuple = ()
    in_shardings: Any = None
    out_shardings: Any = None
    donate_argnums: tuple = ()

    def __call__(self, *args):
        with torch.no_grad():
            return self.fn(*args)


# -- abstract state / axes helpers --------------------------------------------

def captured_axes(init: Callable):
    """Run a ``device -> (tree, axes)`` initializer on the meta device:
    returns the tree of meta tensors (shapes and dtypes only) and the
    logical-axes tree."""
    return init("meta")


def _replicated():
    return ()


def _opt_state_shardings(opt_state, params_specs):
    """Moment trees mirror params; scalars replicate."""
    flat = rules_lib.axes_leaves(params_specs)

    def assign(subtree):
        leaves, td = tm.tree_flatten(subtree)
        if len(leaves) == len(flat):
            return tm.tree_unflatten(td, flat)
        return tm.tree_map(lambda _: _replicated(), subtree)

    if not isinstance(opt_state, dict):
        return tm.tree_map(lambda _: _replicated(), opt_state)
    return {k: assign(v) if isinstance(v, dict) or len(tm.tree_leaves(v)) > 1
            else _replicated() for k, v in opt_state.items()}


def batch_axes(api: ModelAPI, shape: InputShape) -> dict:
    """Logical axes of a batch: every field leads with ``batch``."""
    return {k: ("batch",) + (None,) * (len(shp) - 1)
            for k, (shp, _dt) in api.batch_spec(shape).items()}


def _batch_struct_and_shardings(api: ModelAPI, shape: InputShape, mesh,
                                rules):
    spec = api.batch_spec(shape)
    axes = batch_axes(api, shape)
    struct = {k: torch.empty(shp, dtype=dt, device="meta")
              for k, (shp, dt) in spec.items()}
    shardings = {k: rules_lib.spec_for(axes[k], mesh, rules) for k in spec}
    return struct, shardings


def _lead(wax, *rest) -> tuple:
    """A spec with an optional leading worker axis followed by ``rest``."""
    return (wax,) + tuple(rest)


def place_delay_table(table, mesh, device=None):
    """A deterministic delay table for a mesh-aware engine, as
    ``(table, spec)``: a ``[T, P]`` table shards its worker axis over
    ("pod","data"), so a rank of a ``DeviceMesh`` keeps its own delay
    columns; a ``[T]`` table, and a P the data extent does not divide,
    replicate (the planner's even-division fallback)."""
    arr = torch.as_tensor(table, dtype=torch.int32, device=device)
    if arr.dim() < 2:
        return arr, _replicated()
    wax = rules_lib.worker_split(mesh, arr.shape[1])
    n = rules_lib.data_extent(mesh)
    if wax is None:
        return arr, _replicated()
    spec = _lead(None, wax)
    if hasattr(mesh, "mesh_dim_names") and n > 1:
        per = arr.shape[1] // n
        r = mesh.get_local_rank("data")
        arr = arr[:, r * per:(r + 1) * per]
    return arr, spec


# -- the train plan -----------------------------------------------------------

def _model_specs(params_axes, mesh, rules: dict):
    """The params' model-axis specs (pod/data stripped): the param dims of a
    worker-stacked ``[P, ...]`` state, whose leading dim spends the data
    axis."""
    return rules_lib.tree_specs(params_axes, mesh, rules_lib.strip_data(rules))


def params_specs(api: ModelAPI, mesh, arch=None,
                 shape: Optional[InputShape] = None):
    """The train plan's ``params`` spec tree of an arch (a registry entry
    or its id) under ``rules_for_arch``, FSDP's ``embed -> data``
    included. ``engine/placement.py`` holds each rank's shards by it."""
    _, params_axes = captured_axes(lambda dev: api.init(0, device=dev))
    return rules_lib.tree_specs(params_axes, mesh,
                                rules_lib.rules_for_arch(arch, shape, mesh))


def attach_train_plan(engine, api: ModelAPI, shape: ShapeLike, *,
                      arch_id: Optional[str] = None) -> Plan:
    """Compute the placement plan of a train engine built with a mesh and
    attach it (``engine.plan()``). State and batch structures are made on
    the meta device at their global shapes; the specs follow the JAX
    planner leaf for leaf."""
    from repro_torch.core import stale_sync, staleness
    from repro_torch.engine.api import EngineState

    mesh = engine.mesh
    if mesh is None:
        raise ValueError("attach_train_plan needs an engine built with mesh=")
    if not (hasattr(api, "init") and hasattr(api, "batch_spec")):
        raise ValueError(
            "sharding plans need a ModelAPI (init/batch_spec) to derive "
            "state and batch structures; got a bare loss function")
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = engine.cfg
    p = cfg.num_workers
    fsdp = rules_lib.is_fsdp(arch_id)
    rules = rules_lib.rules_for_arch(arch_id, shape=shape, mesh=mesh)
    wax = rules_lib.worker_split(mesh, p)

    params_shapes, params_axes = captured_axes(
        lambda dev: api.init(0, device=dev))
    params_sh = rules_lib.tree_specs(params_axes, mesh, rules)
    inner = engine._init_inner(params_shapes, None, torch.Generator(),
                               rows=None)
    per_source = cfg.mode == "simulate" or (
        cfg.mode in ("stale-psum", "ssp") and cfg.per_worker_delays)
    comp = (engine._init_comp(params_shapes,
                              rows=p if per_source else None)
            if engine._init_comp is not None else ())
    opt_sh = (_opt_state_shardings(inner.opt_state, params_sh)
              if hasattr(inner, "opt_state") else None)
    packed = engine.meta.get("kernels", {}).get("delivery") == "packed"

    if cfg.mode == "sync":
        inner_sh = stale_sync.SyncTrainState(
            params=params_sh, opt_state=opt_sh, step=_replicated())
    elif cfg.mode in ("stale-psum", "ssp"):
        per_worker = cfg.mode == "ssp" or cfg.per_worker_delays
        if packed:
            # ONE [slots(, P), D] ring: the packed D axis mixes leaves, so
            # only the worker axis can shard.
            gbuf_sh = (_lead(None, wax, None) if per_worker
                       else _lead(None, None))
        else:
            # A per-worker buffer spends the data axis on its worker dim,
            # so its param dims must not reuse it (FSDP rules would).
            buf_rules = (rules_lib.strip_data(rules)
                         if (per_worker and fsdp) else rules)

            def buf_shard(a):
                base = rules_lib.spec_for(a, mesh, buf_rules)
                return (_lead(None, wax, *base) if per_worker
                        else _lead(None, *base))

            gbuf_sh = rules_lib.map_axes(buf_shard, params_axes)
        inner_sh = stale_sync.StaleTrainState(
            params=params_sh, opt_state=opt_sh, gbuf=gbuf_sh,
            step=_replicated(), key=_replicated())
    else:  # simulate
        # [P, ...] worker caches: leading axis over data, model-only rules
        # on the param dims (the data axis is spent on the worker dim).
        model_sh = _model_specs(params_axes, mesh, rules)
        cache_sh = rules_lib.map_axes(lambda spec: _lead(wax, *spec),
                                      model_sh)
        if packed:
            pend_sh = {"arrived": _lead(wax, None),
                       "ring": _lead(wax, None, None)}
        else:
            pend_sh = rules_lib.map_axes(
                lambda spec: _lead(wax, None, *spec), model_sh)

        def lead_only(x):
            nd = x.dim() if torch.is_tensor(x) else 0
            return _lead(wax, *([None] * (nd - 1))) if nd else _replicated()

        inner_sh = staleness.SimState(
            caches=cache_sh, pending=pend_sh,
            update_state=tm.tree_map(lead_only, inner.update_state),
            server_state=tm.tree_map(lead_only, inner.server_state),
            step=_replicated(), key=_replicated())

    if cfg.mode == "simulate":
        if shape.global_batch % p:
            raise ValueError(
                f"simulate mode needs global_batch divisible by num_workers "
                f"({shape.global_batch} % {p})")
        per = dataclasses.replace(shape, global_batch=shape.global_batch // p)
        flat = api.batch_spec(per)
        batch_struct = {k: torch.empty((p,) + tuple(shp), dtype=dt,
                                       device="meta")
                        for k, (shp, dt) in flat.items()}
        batch_sh = {k: _lead(wax, *([None] * len(shp)))
                    for k, (shp, _dt) in flat.items()}
    else:
        batch_struct, batch_sh = _batch_struct_and_shardings(
            api, shape, mesh, rules)

    # Compensation rows ([P, D] per source) shard their worker axis; the
    # aggregate [D] residual and the scalar mu/L signals replicate.
    def comp_shard(leaf):
        if torch.is_tensor(leaf) and leaf.dim() == 2:
            return _lead(wax, None)
        return _replicated()

    # (No compensation: no leaves, so None, not the scalar spec ().)
    comp_sh = tm.tree_map(comp_shard, comp) if comp != () else None
    state_sh = EngineState(inner=inner_sh, bound=_replicated(), comp=comp_sh)
    state_struct = EngineState(inner=inner, bound=engine._max_bound,
                               comp=comp)
    # The port updates rings in place (the JAX package donates them).
    donate = cfg.donate and (cfg.mode in ("stale-psum", "ssp")
                             or (cfg.mode == "simulate" and packed))
    plan = Plan(
        fn=engine.step, args=(state_struct, batch_struct),
        in_shardings=(state_sh, batch_sh), out_shardings=(state_sh, None),
        donate_argnums=(0,) if donate else (),
        meta={"arch": arch_id, "shape": shape.name, "kind": "train",
              "mode": mode_label("train", cfg.mode, cfg.s),
              "engine_mode": cfg.mode, "s": cfg.s, "workers": p,
              "mesh": rules_lib.mesh_sizes(mesh),
              "kernels": engine.meta.get("kernels"),
              "compensate": engine.meta.get("compensate"),
              "donate": donate})
    engine._attach_plan(plan)
    return plan


def mode_label(kind: str, mode: Optional[str] = None,
               stale_s: Optional[int] = None) -> str:
    """A plan's mode name, as the JAX package's dry-run records key it."""
    if kind != "train":
        return kind
    if mode in (None, "auto"):
        return f"stale_psum(s={stale_s})" if stale_s else "sync"
    if mode == "sync":
        return "sync"
    name = "stale_psum" if mode == "stale-psum" else mode
    return f"{name}(s={stale_s})"


def make_train_engine(arch: Union[str, ArchDef], shape: ShapeLike,
                      mesh=None, *, ecfg=None, mode: Optional[str] = None,
                      stale_s: Optional[int] = None,
                      num_workers: Optional[int] = None,
                      optimizer_name: Optional[str] = None,
                      remat_override: Optional[bool] = None,
                      overrides: Optional[dict] = None,
                      reduced: bool = False, device=None, **engine_kw):
    """One call from (arch x shape x mesh) to a train engine on ``device``
    (CUDA unless ``device="cpu"``; an abstract mesh plans on ``"meta"``).

    ``stale_s`` keeps the JAX package's semantics: None/0 -> the
    synchronous baseline, >= 1 -> the paper's stale-psum step with that
    bound (unless ``mode`` selects another regime). FSDP archs get the
    aggregate ring (``per_worker_delays=False``) in stale-psum, as in the
    JAX package. Extra ``engine_kw`` land on ``EngineConfig``; a full
    ``ecfg`` controls everything. ``num_workers`` defaults to the mesh's
    data extent (1 without a mesh). The fused Adam opt-in follows the
    placement verdict. With a mesh the engine carries its plan."""
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
            # FSDP archs shard params over 'data' already, so the
            # per-worker buffer axis cannot also use it.
            kw.setdefault("per_worker_delays", not rules_lib.is_fsdp(arch))
        ecfg = EngineConfig(
            mode=mode, s=s,
            num_workers=num_workers or rules_lib.data_extent(mesh),
            buffer_dtype=getattr(api.cfg, "param_dtype", torch.float32), **kw)

    fuse_adam = (opt_name == "adam"
                 and kernel_placement_ok(ecfg.kernels, arch, mesh)[0])
    opt = optlib.get_optimizer(opt_name, **({"kernel": True} if fuse_adam
                                            else {}))
    engine = build_engine(api, opt, ecfg, mesh=mesh, arch=arch, shape=shape,
                          device=device)
    engine.meta.update(arch=arch.arch_id, shape=shape.name,
                       optimizer=opt_name)
    if engine._plan is not None:
        engine.plan().meta["optimizer"] = opt_name
    return engine


# -- inference plans (no staleness, hence no engine) --------------------------

def _resolve(arch, shape, reduced, overrides, long_ctx=False):
    arch = cfglib.get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    api = arch.api(reduced=reduced, long_ctx=long_ctx, overrides=overrides)
    return arch, shape, api


def _serve_specs(api, shape, mesh, arch, cache_fn):
    """(params specs, params struct, cache specs, cache struct, rules)."""
    rules = rules_lib.rules_for_arch(arch.arch_id, shape=shape, mesh=mesh)
    params_shapes, params_axes = captured_axes(
        lambda dev: api.init(0, device=dev))
    cache_shapes, cache_axes = captured_axes(cache_fn)
    return (rules_lib.tree_specs(params_axes, mesh, rules), params_shapes,
            rules_lib.tree_specs(cache_axes, mesh, rules), cache_shapes, rules)


def plan_prefill(arch: Union[str, ArchDef], shape: ShapeLike, mesh=None,
                 overrides: Optional[dict] = None,
                 reduced: bool = False) -> Plan:
    """``plan(params, batch) -> (last-position logits [B,1,V], cache)``.
    Under an ambient model-parallel context (the server's tensor-parallel
    route) the logits are gathered whole (:func:`whole_logits`)."""
    arch, shape, api = _resolve(arch, shape, reduced, overrides)
    assert shape.kind == "prefill", shape.name
    meta = {"arch": arch.arch_id, "shape": shape.name, "kind": "prefill",
            "seq_len": shape.seq_len, "batch": shape.global_batch}

    def prefill(params, batch):
        logits, cache = api.prefill(params, batch)
        return whole_logits(logits, api), cache
    if mesh is None:
        return Plan(fn=prefill, meta=meta)
    params_sh, params_struct, cache_sh, _, rules = _serve_specs(
        api, shape, mesh, arch,
        lambda dev: api.init_cache(shape.global_batch, shape.seq_len,
                                   device=dev))
    batch_struct, batch_sh = _batch_struct_and_shardings(api, shape, mesh,
                                                         rules)
    return Plan(fn=prefill, meta=meta,
                args=(params_struct, batch_struct),
                in_shardings=(params_sh, batch_sh),
                out_shardings=(rules_lib.spec_for(("batch", None, None), mesh,
                                                  rules), cache_sh))


def plan_decode(arch: Union[str, ArchDef], shape: ShapeLike, mesh=None,
                overrides: Optional[dict] = None,
                reduced: bool = False) -> Plan:
    """``plan(params, token [B,1], cache, pos) -> (logits, cache)``.
    ``long_500k`` builds the arch's long-context config."""
    long_ctx = (shape if isinstance(shape, str)
                else shape.name) == "long_500k"
    arch, shape, api = _resolve(arch, shape, reduced, overrides,
                                long_ctx=long_ctx)
    assert shape.kind == "decode", shape.name
    meta = {"arch": arch.arch_id, "shape": shape.name, "kind": "decode",
            "seq_len": shape.seq_len, "batch": shape.global_batch,
            "long_ctx": long_ctx}
    if mesh is None:
        return Plan(fn=api.decode, meta=meta)
    params_sh, params_struct, cache_sh, cache_struct, rules = _serve_specs(
        api, shape, mesh, arch,
        lambda dev: api.init_cache(shape.global_batch, shape.seq_len,
                                   device=dev))
    token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device="meta")
    return Plan(fn=api.decode, meta=meta,
                args=(params_struct, token, cache_struct, 0),
                in_shardings=(params_sh,
                              rules_lib.spec_for(("batch", None), mesh, rules),
                              cache_sh, _replicated()),
                out_shardings=(None, cache_sh))


def resolve_serve_paged(api: ModelAPI, layout, arch=None, mesh=None,
                        paged: str = "auto"):
    """Resolve the serve decode route -> ``(route, why)``: ``"paged"`` (the
    in-place page-table attention kernel), ``"gather"`` (the gather ->
    decode -> scatter reference) or ``"resident"`` (no token-major cache
    leaves at all).

    ``"off"`` forces the gather reference; ``"auto"`` takes the paged route
    only where ``engine.api.kernel_placement_ok`` would fuse a training
    kernel (FSDP archs and a model axis > 1 veto it) and the model family
    has ``decode_paged``; ``"on"`` overrides the model-axis veto and raises
    where the paged route cannot run (no ``decode_paged``, an FSDP
    placement). ``arch`` is an ``ArchDef`` or an arch id, ``mesh`` any mesh
    ``sharding.rules`` reads."""
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
    from repro_torch.engine.api import kernel_placement_ok
    ok, why = kernel_placement_ok(paged, arch, mesh)
    if not ok:
        if paged == "on":
            raise ValueError(f"paged='on' vetoed by placement: {why}")
        return "gather", why
    return "paged", ""


def whole_logits(logits: torch.Tensor, api: ModelAPI) -> torch.Tensor:
    """Logits over the whole vocab: under an ambient model-parallel
    context a model step gives this rank's vocab columns, gathered here
    over the model group (every rank then holds the same ``[..., V]``, so
    it picks the same tokens); as they are without one."""
    mp = rules_lib.ambient_model_parallel()
    if mp is None:
        return logits
    return mp.gather(logits.contiguous(), logits.dim() - 1, api.cfg.vocab,
                     "logits")


def pick_scores(logits: torch.Tensor, gen, temp: float) -> torch.Tensor:
    """What a pick takes its argmax over: the fp32 logits themselves at
    ``temp <= 0`` (greedy), else the Gumbel-max scores of a categorical
    draw (one block of uniforms from ``gen`` the logits' shape, so both
    routes burn the same draws)."""
    if temp <= 0:
        return logits
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return logits / temp - torch.log(-torch.log(u))


def _pick(logits: torch.Tensor, tokens, mask, gen, temp: float):
    """Next token per slot from fp32 logits [S, V] (``pick_scores``'
    argmax). Masked slots keep their token."""
    nxt = torch.argmax(pick_scores(logits, gen, temp), dim=-1)
    return torch.where(mask, nxt.to(tokens.dtype), tokens)


def plan_serve_step(arch: Union[str, ArchDef], shape: ShapeLike, mesh=None,
                    *, layout, num_pages: int,
                    overrides: Optional[dict] = None,
                    reduced: bool = False, paged: str = "off") -> Plan:
    """Continuous-batching decode step for the serving plane:
    ``plan(params, pages, resident, tables, tokens, pos, mask, gen, temp)
    -> (next tokens [S], pages, resident)``, advancing every occupied slot
    by one token against the paged cache (``serving.cache.PageLayout``).
    ``pages`` and ``resident`` are updated in place.

    * **gather** (the reference): page-table gather -> each slot's batch-1
      ``api.decode`` at its own position (the JAX package's ``vmap``; a
      family's ``decode_slots`` steps every slot through a layer before it
      reads the next, each slot bit for bit its own call, else a loop over
      slots) -> cursor-addressed whole-page scatter.
    * **paged**: the K/V ring stays put; ``api.decode_paged`` reads it in
      place through the page-table attention kernel and the step writes ONE
      [W] row per slot. Null-page table entries are masked in the kernel,
      so slots may hold only the pages their request touches.

    Masked slots still occupy lanes but are inert: their token is kept and
    their cache write goes to the null page. ``temp <= 0`` is greedy.

    With a mesh the plan carries the JAX planner's specs: params by
    ``rules_for_arch`` (the model axis on the param dims, FSDP archs'
    ``embed`` on data), every other argument and output replicated, so
    every rank holds every slot. ``meta["model_compute"]`` (on a model
    axis above 1; ``engine/placement.py::model_compute``) says how the
    step reads the params: ``"tensor-parallel"``, run under the server's
    model-parallel context on this rank's shards, whose ``layout`` is then
    the rank's (its pool holds the kv heads the rank attends with:
    ``meta["pool_width"]`` floats a row), or ``"gathered"`` (whole params,
    ``meta["model_compute_fallback"]`` the reason;
    ``engine/placement.py::ServePlacement``)."""
    from repro_torch.kernels import dispatch
    arch, shape, api = _resolve(arch, shape, reduced, overrides)
    assert shape.kind == "decode", shape.name
    slots = shape.global_batch
    route, route_why = resolve_serve_paged(api, layout, arch, mesh, paged)
    dispatch.note("serve_decode", route, route_why)

    def each_slot(params, toks, caches, positions):
        out = [api.decode(params, t, c, p)
               for t, c, p in zip(toks, caches, positions)]
        return [lg for lg, _ in out], [nc for _, nc in out]
    decode_slots = api.decode_slots or each_slot

    def serve_step(params, pages, resident, tables, tokens, pos, mask, gen,
                   temp):
        cache = layout.gather(pages, resident, tables)   # [S, ...] leaves
        at = range(pos.shape[0])
        logits, new_caches = decode_slots(
            params, [tokens[i].reshape(1, 1) for i in at],
            [tm.tree_map(lambda x, i=i: x[i], cache) for i in at],
            pos.tolist())
        logits = [lg[0, -1].float() for lg in logits]
        nxt = _pick(whole_logits(torch.stack(logits), api), tokens, mask,
                    gen, temp)
        pages, resident = layout.scatter_token(
            pages, resident, tm.tree_stack(new_caches), tables, pos, mask)
        return nxt, pages, resident

    def serve_step_paged(params, pages, resident, tables, tokens, pos, mask,
                         gen, temp):
        cache = layout.unpack_resident(resident)          # token leaves None
        kv = layout.paged_kv(pages, tables, pos)
        logits, new_cache = api.decode_paged(params, tokens[:, None], cache,
                                             pos, kv)
        nxt = _pick(whole_logits(logits[:, -1].float(), api), tokens, mask,
                    gen, temp)
        pages, resident = layout.scatter_rows(
            pages, resident, new_cache, tables, pos, mask)
        return nxt, pages, resident

    plan = Plan(
        fn=serve_step_paged if route == "paged" else serve_step,
        donate_argnums=(1, 2),
        meta={"arch": arch.arch_id, "shape": shape.name, "kind": "serve",
              "slots": slots, "seq_len": shape.seq_len,
              "cache_tokens": layout.tokens,
              "page_tokens": layout.page_tokens,
              "pages": num_pages, "resident_width": layout.res_width,
              "pool_width": layout.width,
              "paged": route, "paged_why": route_why})
    if mesh is None:
        return plan
    rules = rules_lib.rules_for_arch(arch.arch_id, shape=shape, mesh=mesh)
    params_shapes, params_axes = captured_axes(
        lambda dev: api.init(0, device=dev))
    params_sh = rules_lib.tree_specs(params_axes, mesh, rules)
    if rules_lib.model_extent(mesh) > 1:
        from repro_torch.engine.placement import model_compute
        compute, why = model_compute(api, params_sh,
                                     rules_lib.model_extent(mesh))
        plan.meta["model_compute"] = compute
        if why:
            plan.meta["model_compute_fallback"] = why

    def meta(shp, dtype=torch.float32):
        return torch.empty(shp, dtype=dtype, device="meta")

    vec = lambda dtype: meta((slots,), dtype)
    rep = _replicated()
    # The generator (a torch.Generator, not a tensor) and the temperature
    # (a float) take no abstract value.
    plan.args = (params_shapes,
                 meta((num_pages + 1, layout.page_tokens, layout.width)),
                 meta((slots, layout.res_width)),
                 meta((slots, max(layout.pages_per_slot, 1)), torch.int32),
                 vec(torch.int32), vec(torch.int32), vec(torch.bool), None,
                 0.0)
    plan.in_shardings = (params_sh, rep, rep, rep, rep, rep, rep, rep, rep)
    plan.out_shardings = (rep, rep, rep)
    return plan


def build(arch_id: str, shape_name: str, mesh=None, *,
          stale_s: Optional[int] = None, mode: Optional[str] = None,
          optimizer_name: Optional[str] = None,
          remat_override: Optional[bool] = None,
          overrides: Optional[dict] = None,
          num_workers: Optional[int] = None, device=None,
          **engine_kw) -> Plan:
    """The plan of one (arch, shape), dispatched on the shape's kind: a
    train engine's plan, or a prefill / decode plan."""
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return make_train_engine(
            arch_id, shape_name, mesh, mode=mode, stale_s=stale_s,
            num_workers=num_workers, optimizer_name=optimizer_name,
            remat_override=remat_override, overrides=overrides,
            device=device, **engine_kw).plan()
    if kind == "prefill":
        return plan_prefill(arch_id, shape_name, mesh, overrides=overrides)
    return plan_decode(arch_id, shape_name, mesh, overrides=overrides)
