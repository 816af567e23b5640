"""Execution surface of the port (port of ``repro/engine/api.py``).

``build_engine(loss, optimizer, EngineConfig(mode=..., ...))`` returns an
:class:`Engine` with the JAX package's object surface:
``engine.init(seed, params=...) -> state``,
``engine.step(state, batch) -> (state, metrics)``, ``engine.params(state)``,
``engine.with_staleness(state, s)`` and ``engine.with_lr_signals(state, mu,
lip)``. Steps run eagerly (there is no ``jit``) on the engine's device, CUDA
unless ``device="cpu"``.

Modes
-----
* ``simulate``   -- the paper's Section-3 per-worker-cache simulator
                    (``core/staleness.py``); batches carry a leading worker
                    axis ``[P, b, ...]``.
* ``stale-psum`` -- Theorem-1 delayed-gradient data parallelism
                    (``core/stale_sync.py``); batches are flat global
                    batches reshaped to per-worker shards inside the step.
* ``ssp``        -- Stale Synchronous Parallel: the ``core/ssp.py`` clock
                    discipline becomes a per-step delay table fed to the
                    delayed-gradient step.
* ``sync``       -- the buffer-free synchronous baseline (s = 0).

Every mode honours the compensation layer (``lr_scale``, ``compress``,
``ef_momentum``; ``repro_torch.compensate``), whose state rides in
``EngineState.comp`` (``()`` when both knobs are ``"none"``).

Routing: ``kernels="off"`` keeps the tree layouts in plain torch; ``"auto"``
and ``"on"`` run the packed ring through the CUDA kernels, under the JAX
package's placement verdict (``kernel_placement_ok``): an FSDP arch keeps
the tree layout under ``"auto"`` (so it runs no kernel, and
``meta["kernels"]["fallback"]`` says why) and refuses ``"on"``, on one
device too; a mesh with a model axis > 1 vetoes the packed views under
``"auto"``. An Adam-spec optimizer on the packed path
runs the megakernel tail (``fused_update`` in the ring modes and in sync
with a compensation knob, ``fused_adam`` in simulate and in plain dense
sync) unless ``megakernel="off"``.

Delays: any ``DelaySpec`` in the sampled modes (samplers, ``Schedule``,
``MultiPod``; a ``Trace`` with an explicit ``bound``); ``ssp`` takes a
``Trace`` (measured wall-times), a ``Schedule`` or ``delay=None`` (the
lognormal speed model).

Placement: ``mesh=`` (a ``DeviceMesh`` from ``launch.mesh.make_host_mesh``)
spreads the P workers over the mesh's data axis, one process a rank, and
holds params on the model axis by the sharding rules, and an FSDP arch's
params on the data axis too (``engine/placement.py`` says which collective
runs where). On a model axis > 1 a decoder-only transformer whose every
model-sharded dim the extent divides computes tensor-parallel on its
shards; anything else gathers them whole for the loss.
``meta["model_compute"]`` says which (``"tensor-parallel"`` or
``"gathered"``, with ``meta["model_compute_fallback"]`` saying why). The
packed kernels and compression run on each rank's shards there, the top-k
threshold and the sparsity taken over the whole packed row. With ``shape``
and a ``ModelAPI`` the engine also carries
the placement plan (``engine.plan()``,
``engine/plan.py::attach_train_plan``); an
``AbstractMesh`` builds that plan and runs nothing. ``arch`` feeds the
placement verdict and the FSDP rule.

``server_side`` (the ablation that delivers arrivals through a
``server_apply`` transform) runs on the simulate tree route: under
``kernels="auto"`` it falls back to tree delivery (``meta["kernels"]
["fallback"]`` says why), ``"on"`` refuses it, and the other modes accept
the flag and ignore it, as in the JAX package.

Not run yet, and raising ``NotImplementedError`` that names the ROADMAP
item: compression over an FSDP arch's data shards (A.20), a ``pod`` axis
(A.19).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import compensate as compensate_lib
from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.core import ssp as ssp_lib
from repro_torch.core import stale_sync, staleness
from repro_torch.delays.models import DelaySpec, UniformDelay, as_spec
from repro_torch.delays.multipod import MultiPod
from repro_torch.delays.schedule import Schedule
from repro_torch.delays.trace import Trace
from repro_torch.engine import placement as placement_lib
from repro_torch.kernels import dispatch
from repro_torch.optim import optimizers as optlib
from repro_torch.sharding import rules as rules_lib

Pytree = Any

MODES = ("simulate", "stale-psum", "ssp", "sync")

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """One config for every staleness regime (same fields and defaults as
    ``repro.engine.EngineConfig``).

    ``s`` is the staleness bound: for ``simulate`` it parameterises
    ``UniformDelay(s)`` (delays r in [0, s-1]) unless ``delay`` overrides
    it; for ``stale-psum`` it sizes the gradient ring; for ``ssp`` it is the
    clock-drift bound; ``sync`` ignores it.
    """
    mode: str = "sync"
    num_workers: int = 1
    s: int = 0
    delay: Optional[DelaySpec] = None
    kernels: str = "off"
    donate: bool = True
    lr_scale: str = "none"
    compress: str = "none"
    ef_momentum: float = 0.0
    megakernel: str = "auto"
    per_worker_delays: bool = True
    buffer_dtype: Any = torch.float32
    server_side: bool = False
    loss_takes_key: bool = False         # loss_fn(params, batch, gen) losses
    ssp_speeds: Optional[Any] = None     # [T, P] durations; sampled if None
    ssp_steps: int = 512
    ssp_mean_dur: float = 1.0
    ssp_cv: float = 0.5
    ssp_seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; have {MODES}")
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.s < 0:
            raise ValueError(f"staleness bound s must be >= 0, got {self.s}")
        if self.kernels not in ("off", "auto", "on"):
            raise ValueError(f"kernels must be 'off'|'auto'|'on', "
                             f"got {self.kernels!r}")
        if self.megakernel not in ("off", "auto", "on"):
            raise ValueError(f"megakernel must be 'off'|'auto'|'on', "
                             f"got {self.megakernel!r}")
        # Validates the lr_scale/compress/ef_momentum grammar.
        compensate_lib.CompensateConfig(lr_scale=self.lr_scale,
                                        compress=self.compress, s=self.s,
                                        ef_momentum=self.ef_momentum)
        object.__setattr__(self, "delay", as_spec(self.delay))
        if self.delay is not None:
            if self.mode == "sync" and getattr(self.delay, "bound", None) != 0:
                raise ValueError(
                    "sync mode is delay-free: only a bound-0 spec "
                    "(delays.Zero()) is accepted")
            if self.mode == "ssp" and not isinstance(self.delay,
                                                     (Schedule, Trace)):
                raise ValueError(
                    "ssp derives its delays from a clock schedule: pass "
                    "delays.Trace(...) (measured wall-times), "
                    "delays.Schedule(...) (an explicit table) or delay=None "
                    "for the lognormal speed model")
            if (isinstance(self.delay, Trace) and self.delay.bound is None
                    and self.mode != "ssp"):
                raise ValueError(
                    "Trace needs an explicit bound= outside mode='ssp' "
                    "(it sizes the delivery ring)")


@dataclasses.dataclass
class EngineState:
    """Mode-specific state plus the dynamic staleness bound (an int: the
    inclusive max delay currently allowed) and the compensation state
    ``comp`` (a dict of device tensors, ``()`` when uncompensated)."""
    inner: Pytree
    bound: int
    comp: Pytree = ()


def _to_device(batch: Pytree, device: torch.device) -> Pytree:
    def conv(x):
        if isinstance(x, np.ndarray) or torch.is_tensor(x):
            return torch.as_tensor(x).to(device, non_blocking=True)
        return x
    return tm.tree_map(conv, batch)


def _mean_over_workers(metrics: dict) -> dict:
    """simulate-mode metrics are per-worker rows [P, ...]; reduce them to
    scalars (kept as device tensors: no sync)."""
    return {k: v.float().mean(dim=0) if torch.is_tensor(v) and v.dim() >= 1
            else v for k, v in metrics.items()}


@dataclasses.dataclass
class Engine:
    """Uniform handle returned by ``build_engine``."""
    cfg: EngineConfig
    device: torch.device
    meta: dict = dataclasses.field(default_factory=dict)
    _init_inner: Callable = None   # (params, update_state, gen) -> inner
    _step_inner: Callable = None   # (inner, batch, bound, comp)
    #                                -> (inner, comp, metrics)
    _params_of: Callable = None    # inner -> params eval view
    _max_bound: int = 0
    _init_comp: Callable = None    # params -> comp state (None = no comp)
    _init_params: Callable = None  # (seed, device) -> params (ModelAPI)
    mesh: Any = None
    placement: Any = None          # MeshPlacement on a DeviceMesh
    _plan: Any = None

    def plan(self):
        """The placement plan ``build_engine(mesh=, shape=)`` attached
        (``engine/plan.py::Plan``)."""
        if self._plan is None:
            raise ValueError("no plan attached: build the engine with mesh= "
                             "and shape= from a ModelAPI")
        return self._plan

    def _attach_plan(self, plan) -> None:
        self._plan = plan

    def _need_run(self) -> None:
        if self.mesh is not None and self.placement is None:
            raise ValueError(
                "an abstract mesh plans placements only; run on a "
                "DeviceMesh (launch.mesh.make_host_mesh)")

    def init(self, seed=0, params: Pytree = None,
             update_state: Pytree = None) -> EngineState:
        """Initialise engine state. ``params`` overrides the model's own
        initialiser (required when the engine was built from a bare loss
        function). ``seed`` (an int, or a ``torch.Generator`` on the
        engine's device) seeds that initialiser and the engine's delay
        stream; ``update_state`` overrides the per-worker optimizer state in
        ``simulate`` mode (defaults to ``optimizer.init(params)``)."""
        self._need_run()
        if params is None:
            if self._init_params is None:
                raise ValueError(
                    "engine built from a bare loss function: pass params= "
                    "(or build from a ModelAPI, which knows how to init)")
            params = self._fresh_params(seed)
        else:
            params = tm.tree_map(
                lambda x: torch.as_tensor(placement_lib.whole_dtensor(x)).to(
                    self.device), params)
            if self.placement is not None:
                self.placement.set_full_shapes(params)
        ring = {}
        if self.placement is not None:
            # Every rank was given (or drew) the same whole params; each
            # keeps its shards.
            params = self.placement.shard_params(params)
            if self.placement.fsdp:
                # A per-worker ring keeps whole rows on the data axis.
                ring["whole"] = self.placement.whole_like(params)
        gen = (seed if isinstance(seed, torch.Generator)
               else device_lib.generator(seed, self.device))
        inner = self._init_inner(params, update_state, gen, **ring)
        comp = self._init_comp(params) if self._init_comp is not None else ()
        return EngineState(inner=inner, bound=self._max_bound, comp=comp)

    def _fresh_params(self, seed) -> Pytree:
        """The model's own init. On a sharded placement each rank keeps its
        blocks as the initialiser draws them (``placement.keep``): an FSDP
        arch draws a stacked leaf a layer at a time, so its ranks never
        hold one whole. The values are the one-process init's."""
        place = self.placement
        if place is None or not place.sharded:
            params = self._init_params(seed, self.device)
            if place is not None:
                place.set_full_shapes(params)
            return params
        from repro_torch.models import layers
        place.set_full_shapes(self._init_params(seed, torch.device("meta")))
        with layers.use_keep(place.keep):
            return self._init_params(seed, self.device)

    def step(self, state: EngineState, batch) -> Tuple[EngineState, dict]:
        """One engine step: ``(state, batch) -> (state, metrics)``. Numpy
        batches are moved to the engine's device. The step updates the
        input state's ring, moments and residuals in place (see
        ``core/staleness.py`` and ``core/stale_sync.py``). On a mesh every
        rank passes the same global batch and keeps its own rows."""
        self._need_run()
        inner, comp, metrics = self._step_inner(
            state.inner, _to_device(batch, self.device), state.bound,
            state.comp)
        return EngineState(inner=inner, bound=state.bound, comp=comp), metrics

    def params(self, state: EngineState) -> Pytree:
        """The evaluation view: worker 0's cache in ``simulate`` mode, the
        global params otherwise. On a mesh it is a collective (simulate
        broadcasts worker 0's cache from its rank), and the params come
        back as DTensors on the model sub-mesh when the model axis > 1."""
        params = self._params_of(state.inner)
        if self.placement is not None:
            params = self.placement.public(params)
        return params

    def step_count(self, state: EngineState) -> int:
        return state.inner.step

    @property
    def batches_per_step(self) -> int:
        """Worker batches consumed per engine step (the paper's accounting)."""
        return self.cfg.num_workers

    def dispatch_report(self) -> dict:
        """The engine's routing verdict plus the per-op backend decisions
        the dispatch layer recorded (process-wide, last call wins)."""
        info = dict(self.meta.get("kernels", {"config": self.cfg.kernels}))
        info["decisions"] = dispatch.report()
        return info

    def with_staleness(self, state: EngineState, s: int) -> EngineState:
        """Clamp the engine to an effective staleness bound ``s`` (0 =
        synchronous) without rebuilding buffers. In ``simulate`` mode a
        bound of s means delays r <= s-1 (UniformDelay semantics); in the
        gradient modes it means gradient age d <= s."""
        if self.cfg.mode == "simulate":
            b = max(int(s) - 1, 0)
        else:
            b = int(s)
        return dataclasses.replace(state, bound=min(b, self._max_bound))

    def with_lr_signals(self, state: EngineState, mu, lip=None) -> EngineState:
        """Refresh the theorem1 LR policy's live signals without rebuilding
        the engine: ``mu`` (the coherence estimate) and, optionally, ``lip``
        (a Lipschitz estimate) ride in ``EngineState.comp`` as fp32
        tensors on the engine's device."""
        if not (isinstance(state.comp, dict) and "mu" in state.comp):
            raise ValueError(
                "engine carries no live LR signals: build it with "
                "EngineConfig(lr_scale='theorem1')")
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(self.device)
        comp = {**state.comp, "mu": f32(mu)}
        if lip is not None:
            comp["lip"] = f32(lip)
        return dataclasses.replace(state, comp=comp)


def _not_run(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} does not run yet (ROADMAP {item})")


def kernel_placement_ok(kernels: str, arch=None,
                        mesh=None) -> Tuple[bool, str]:
    """Can packed flat [D] views keep this (arch, mesh) placement? Returns
    ``(ok, why_not)``, the JAX package's verdict: FSDP archs shard param
    dims over 'data' and a mesh with a model axis > 1 shards them over
    'model'; a packed view mixes leaves, so either placement would be lost.
    ``kernels="on"`` overrides the model-axis veto but never the FSDP one.
    ``mesh`` is a DeviceMesh, an AbstractMesh or a duck-typed mesh."""
    if kernels == "off":
        return False, "config off"
    if rules_lib.is_fsdp(arch):
        return False, "FSDP placement"
    if kernels == "auto" and mesh is not None:
        extent = rules_lib.model_extent(mesh)
        if extent > 1:
            return False, f"model axis extent {extent}"
    return True, ""


def _stacked_loss(api_loss):
    """Adapt a ``ModelAPI.loss(params, batch) -> scalar`` to the engine's
    worker-stacked contract: ``[P, ...]`` params and batches in, the ``[P]``
    per-worker losses out (a loop over P, the JAX package's ``vmap``)."""
    def loss(params, batch):
        p = tm.tree_leaves(batch)[0].shape[0]
        return torch.stack([api_loss(tm.tree_index(params, i),
                                     tm.tree_index(batch, i))
                            for i in range(p)])
    return loss


def _mesh_loss(loss_fn, placement, mesh, per_worker: bool):
    """The loss on one rank of a mesh, under the ambient mesh the MoE layer
    groups its tokens by. On the tensor-parallel route the model computes
    on this rank's model-axis shards (``placement.model_parallel``
    installed); elsewhere they are made whole (``placement.full``).
    Per-worker modes see the mesh, as each JAX worker does; a rank of a
    batch-split mode holds one data shard, which is its one group. A
    batch-split mode of an FSDP arch reads its data-sharded params a layer
    at a time (``placement.fetch``); the per-worker modes hand the loss
    params gathered whole on the data axis."""
    ambient = mesh if per_worker or placement.n == 1 else None
    fetch = placement.fetch if placement.fsdp and not per_worker else None
    mp = placement.model_parallel

    def loss(params, batch, *rest):
        with rules_lib.use_mesh(ambient), rules_lib.use_fetch(fetch), \
                rules_lib.use_model_parallel(mp):
            if mp is None:
                params = placement.full(params, lead=1)
            return loss_fn(params, batch, *rest)
    return loss


def build_engine(loss_fn, optimizer: Optional[optlib.Optimizer],
                 cfg: EngineConfig, mesh=None, *, update_fn=None,
                 server_apply=None, arch=None, shape=None,
                 device=None) -> Engine:
    """Build an :class:`Engine` for any mode on ``device`` (CUDA unless
    ``device="cpu"``; raises without CUDA otherwise).

    ``loss_fn`` is a ``ModelAPI`` (anything with ``.loss`` and ``.init``:
    its scalar loss is looped over the worker axis, and ``Engine.init`` can
    then make the params) or a bare ``loss_fn(params, batch)`` (or
    ``(params, batch, gen)`` with ``cfg.loss_takes_key``) that accepts
    worker-stacked ``[P, ...]`` params and batches and returns the ``[P]``
    per-worker losses, as ``models.mlp.loss_fn`` does. ``update_fn``
    bypasses the loss/optimizer adaptation in ``simulate`` mode (see
    ``core.staleness.UpdateFn``); ``server_apply`` delivers its arrivals
    under ``cfg.server_side`` (see ``core.staleness.ServerApply``).
    ``arch`` (an ``ArchDef`` or arch id) feeds the placement verdict.

    ``mesh`` (a ``DeviceMesh`` over the initialised process group, whose
    device type is ``device``'s) runs the engine on this rank's share of
    the mesh (``engine/placement.py``); every rank builds the same engine
    and steps it with the same batches. With ``shape`` and a ``ModelAPI``
    the engine carries the placement plan (``engine.plan()``) under
    ``sharding.rules.rules_for_arch``; an ``AbstractMesh`` builds that plan
    and runs nothing.
    """
    if device is None and mesh is not None and \
            not placement_lib.is_device_mesh(mesh):
        device = "meta"             # an abstract mesh plans, runs nothing
    dev = device_lib.resolve(device)
    init_params, api = None, None
    if loss_fn is not None and hasattr(loss_fn, "loss"):
        api = loss_fn
        init_params = lambda seed, d: api.init(seed, device=d)[0]
        loss_fn = _stacked_loss(api.loss)
    if loss_fn is not None and not callable(loss_fn):
        raise TypeError(f"loss_fn must be callable, got {type(loss_fn)!r}")

    mode = cfg.mode
    arch_id = getattr(arch, "arch_id", arch)
    if shape is not None and isinstance(shape, str):
        from repro_torch.configs.base import SHAPES
        shape = SHAPES[shape]
    placement, model_compute = None, None
    if placement_lib.is_device_mesh(mesh):
        if mesh.device_type != dev.type:
            raise ValueError(f"mesh on {mesh.device_type!r} devices, engine "
                             f"on {dev.type!r}: pass device= to match")
        n = rules_lib.data_extent(mesh)
        # An FSDP arch shards params over data (outside simulate, whose
        # caches spend the data axis on the worker dim).
        fsdp = (n > 1 and mode != "simulate"
                and kernel_placement_ok("on", arch)[1] == "FSDP placement")
        specs = None
        rules = rules_lib.rules_for_arch(arch, shape, mesh)
        if api is not None and (fsdp or rules_lib.model_extent(mesh) > 1):
            from repro_torch.engine import plan as plan_lib
            specs = plan_lib.params_specs(api, mesh, arch, shape)
        placement = placement_lib.MeshPlacement(
            mesh, cfg.num_workers, specs, fsdp=fsdp, rules=rules)
        if placement.m > 1:
            model_compute = placement_lib.model_compute(api, specs,
                                                        placement.m)
            if model_compute[0] == "tensor-parallel":
                placement.model_parallel = placement_lib.ModelParallel(
                    placement.model_axis)
        per_worker = mode in ("simulate", "ssp") or (
            mode == "stale-psum" and cfg.per_worker_delays)
        if loss_fn is not None:
            loss_fn = _mesh_loss(loss_fn, placement, mesh, per_worker)
        if placement.fsdp and cfg.compress != "none":
            # A top-k over a rank's shard is not the top-k over the row.
            raise _not_run(f"compression over the FSDP shards of {arch_id!r} "
                           f"(data axis {n})", placement_lib.FSDP_COMPRESS_ITEM)
    # The ring (stale-psum, ssp) and the simulate pending ring go packed
    # unless kernels="off" or the arch's placement vetoes it. simulate's
    # server_side transform consumes per-leaf arrivals, so it stays on tree
    # math too.
    kernel_delivery, why = False, ""
    if cfg.kernels != "off":
        if mode == "simulate" and cfg.server_side:
            why = "server_side transform"
            if cfg.kernels == "on":
                raise ValueError(
                    "kernels='on' is unsupported with server_side=True: the "
                    "server transform consumes per-leaf arrivals; use "
                    "kernels='auto' (falls back to tree math)")
        else:
            kernel_delivery, why = kernel_placement_ok(cfg.kernels, arch,
                                                       mesh)
    if mode == "sync":
        delivery = "none"   # sync is buffer-free
    else:
        if not kernel_delivery and cfg.kernels == "on":
            raise ValueError(
                f"kernels='on' is unsupported for FSDP arch "
                f"{getattr(arch, 'arch_id', arch)!r}: the packed ring "
                "buffer cannot keep the 'embed'->data placement; use "
                "kernels='auto' (falls back to tree math)")
        delivery = "packed" if kernel_delivery else "tree"
    meta = {"mode": mode, "workers": cfg.num_workers, "s": cfg.s,
            "device": str(dev),
            "kernels": {"config": cfg.kernels, "delivery": delivery}}
    if mesh is not None:
        meta["mesh"] = rules_lib.mesh_sizes(mesh)
    if model_compute is not None:
        meta["model_compute"] = model_compute[0]
        if model_compute[1]:
            meta["model_compute_fallback"] = model_compute[1]
    if why and mode != "sync":
        meta["kernels"]["fallback"] = why
    if cfg.delay is not None:
        meta["delay_spec"] = repr(cfg.delay)

    # Compensation: built only when a knob is set, so the default path hands
    # compensator=None to the core steps (the uncompensated code).
    ccfg = compensate_lib.CompensateConfig(
        lr_scale=cfg.lr_scale, compress=cfg.compress, s=cfg.s,
        ef_momentum=cfg.ef_momentum)
    # On a model axis each rank packs its shards: the compensator takes the
    # top-k threshold and the sparsity of the whole row over the ranks.
    compensator = (compensate_lib.Compensator(
        ccfg, shard=placement if placement is not None
        and placement.splits_rows else None) if ccfg.active else None)
    init_comp = None
    if compensator is not None:
        meta["compensate"] = {"lr_scale": cfg.lr_scale,
                              "compress": cfg.compress}
        if cfg.ef_momentum:
            meta["compensate"]["ef_momentum"] = cfg.ef_momentum
        # Sparsification runs per SOURCE before transport: [P, D] rows where
        # each worker emits its own payload, one [D] row for the
        # aggregate and sync forms.
        per_source = (mode == "simulate"
                      or (mode in ("stale-psum", "ssp")
                          and cfg.per_worker_delays))
        comp_workers = ((placement.rows if placement is not None
                         else cfg.num_workers) if per_source else None)
        init_comp = lambda params, rows=comp_workers: compensator.init(
            params, num_workers=rows)

    def resolve_mega(supported: bool, why_not: str) -> bool:
        """Resolve the megakernel knob; records the verdict in meta."""
        if cfg.megakernel == "off":
            meta["kernels"]["megakernel"] = "off"
            return False
        sp = getattr(optimizer, "spec", None) if optimizer is not None else None
        if not (sp and sp.get("name") == "adam"):
            supported, why_not = False, "optimizer has no Adam spec"
        if not supported:
            if cfg.megakernel == "on":
                raise ValueError(
                    f"megakernel='on' is unsupported here: {why_not}; use "
                    "megakernel='auto'")
            meta["kernels"]["megakernel"] = "off"
            meta["kernels"]["megakernel_fallback"] = why_not
            return False
        meta["kernels"]["megakernel"] = "fused"
        return True

    rows = placement.rows if placement is not None else None

    def engine(init_inner, step_inner, params_of, max_bound) -> Engine:
        eng = Engine(cfg=cfg, device=dev, meta=meta, _init_inner=init_inner,
                     _step_inner=step_inner, _params_of=params_of,
                     _max_bound=max_bound, _init_comp=init_comp,
                     _init_params=init_params, mesh=mesh,
                     placement=placement)
        if mesh is not None and shape is not None and api is not None:
            from repro_torch.engine import plan as plan_lib
            plan_lib.attach_train_plan(eng, api, shape, arch_id=arch_id)
        return eng

    if mode == "simulate":
        custom_update = update_fn is not None
        if update_fn is None:
            if loss_fn is None or optimizer is None:
                raise ValueError("simulate mode needs (loss, optimizer) or "
                                 "an explicit update_fn")
            make = (optlib.make_stochastic_update_fn if cfg.loss_takes_key
                    else optlib.make_sgd_update_fn)
            update_fn = make(loss_fn, optimizer)
        if custom_update:
            mega = resolve_mega(False, "custom update_fn (opaque update math)")
        elif cfg.server_side:
            mega = resolve_mega(False, "server_side transform")
        else:
            mega = resolve_mega(kernel_delivery, why or "tree delivery")
        sim_cfg = staleness.StalenessConfig(
            num_workers=cfg.num_workers, delay=cfg.delay or UniformDelay(cfg.s),
            server_side=cfg.server_side, kernels=kernel_delivery)
        fused_kw = None
        if mega:
            sp = optimizer.spec
            fused_kw = dict(loss=loss_fn, takes_key=cfg.loss_takes_key,
                            lr=sp["lr"], b1=sp["b1"], b2=sp["b2"],
                            eps=sp["eps"], weight_decay=sp["weight_decay"])
        raw = staleness.make_sim_step(update_fn, sim_cfg,
                                      server_apply=server_apply,
                                      compensator=compensator, fused=fused_kw,
                                      shard=placement)

        def sim_init(params, update_state, gen, rows=rows):
            if update_state is None:
                if mega:
                    # Fused layout: per-worker Adam moments live packed
                    # ([P, D] after the worker broadcast).
                    width = staleness._packed_width(params)
                    update_state = {"m": torch.zeros((width,), device=dev),
                                    "v": torch.zeros((width,), device=dev)}
                else:
                    update_state = optimizer.init(params)
            return staleness.init_sim_state(params, update_state, sim_cfg,
                                            gen, rows=rows)

        def sim_step_inner(inner, batch, bound, comp):
            if placement is not None:
                batch = tm.tree_map(placement.local_rows, batch)
            if compensator is None:
                inner, m = raw(inner, batch, bound=bound)
            else:
                inner, comp, m = raw(inner, batch, bound=bound, comp=comp)
            if placement is not None:
                # Per-worker rows from every rank, then the one-process
                # mean; scalars of this rank's rows average over ranks.
                m = {k: (placement.gather(v) if v.dim() >= 1
                         else placement.mean(v))
                     if torch.is_tensor(v) else v for k, v in m.items()}
            return inner, comp, _mean_over_workers(m)

        def sim_params(inner):
            if placement is not None:
                return placement.broadcast_rows0(inner.caches)
            return tm.tree_map(lambda x: x[0], inner.caches)

        return engine(sim_init, sim_step_inner, sim_params,
                      sim_cfg.delay.bound)

    if loss_fn is None or optimizer is None:
        raise ValueError(f"{mode} mode needs (loss, optimizer)")

    if mode == "sync":
        # No ring, but the megakernel still fuses the packed Adam tail,
        # under the same placement verdict.
        sync_ok, sync_why = kernel_placement_ok(cfg.kernels, arch, mesh)
        mega = resolve_mega(sync_ok, sync_why or "kernels='off'")
        sync_raw = stale_sync.make_sync_train_step_lean(
            loss_fn, optimizer, compensator=compensator, fused=mega,
            shard=placement)

        def sync_step_inner(inner, batch, _bound, comp):
            if compensator is None:
                inner, m = sync_raw(inner, batch)
                return inner, comp, m
            return sync_raw(inner, batch, comp=comp)

        return engine(
            lambda params, _ust, _gen, rows=None, whole=None:
                stale_sync.init_sync_state(params, optimizer, fused=mega),
            sync_step_inner, lambda inner: inner.params, 0)

    # Gradient ring modes: stale-psum and ssp.
    mega = resolve_mega(kernel_delivery, why or "tree delivery")
    if mode == "ssp":
        if cfg.delay is not None:
            # A Trace or Schedule replaces the sampled speed model
            # (type-checked in EngineConfig): measured wall-times run
            # through the same clock discipline.
            spec = cfg.delay
            if isinstance(spec, Trace):
                spec = spec.schedule(
                    num_workers=cfg.num_workers,
                    bound=spec.bound if spec.bound is not None else cfg.s)
            else:
                spec.realize(num_workers=cfg.num_workers)  # width check
            if spec.bound > cfg.s:
                raise ValueError(
                    f"delay schedule bound {spec.bound} exceeds the ssp "
                    f"clock bound s={cfg.s}; raise s to at least {spec.bound}")
            table = torch.as_tensor(np.asarray(spec.table, np.int32))
        else:
            speeds = cfg.ssp_speeds
            if speeds is None:
                speeds = ssp_lib.sample_worker_durations(
                    device_lib.generator(cfg.ssp_seed, torch.device("cpu")),
                    cfg.ssp_steps, cfg.num_workers, cfg.ssp_mean_dur,
                    cfg.ssp_cv)
            table = ssp_lib.ssp_delay_schedule(
                ssp_lib.SSPConfig(num_workers=cfg.num_workers, bound=cfg.s),
                speeds)
        # Schedule delays reach cfg.s, so the ring needs s + 1 slots.
        scfg = stale_sync.StaleSyncConfig(
            num_workers=cfg.num_workers, s=cfg.s + 1,
            buffer_dtype=cfg.buffer_dtype, delay_table=table,
            kernels=kernel_delivery, fused_update=mega)
        meta["ssp_schedule"] = table
        max_bound = cfg.s
    else:
        spec = cfg.delay
        if isinstance(spec, Trace):
            # bound is set here (EngineConfig checks it).
            spec = spec.schedule(num_workers=cfg.num_workers)
        if isinstance(spec, MultiPod) and not cfg.per_worker_delays:
            raise ValueError(
                "MultiPod delays are per-worker; the Theorem-1 aggregate "
                "form (per_worker_delays=False) cannot express topology")
        table = None
        if isinstance(spec, Schedule) and cfg.per_worker_delays:
            spec.realize(num_workers=cfg.num_workers)  # width check
            table = spec.table
        scfg = stale_sync.StaleSyncConfig(
            num_workers=cfg.num_workers, s=cfg.s,
            delay=None if table is not None else spec, delay_table=table,
            buffer_dtype=cfg.buffer_dtype,
            per_worker_delays=cfg.per_worker_delays,
            kernels=kernel_delivery, fused_update=mega)
        eff_bound = spec.bound if spec is not None else scfg.delay.bound
        if eff_bound > scfg.slots - 1:
            # A delay the ring can't hold would wrap onto a fresher slot
            # while the metrics report the large staleness.
            raise ValueError(
                f"delay bound {eff_bound} exceeds the gradient ring "
                f"({scfg.slots} slots from s={cfg.s}); raise s to at least "
                f"{eff_bound + 1}")
        max_bound = eff_bound
    raw = stale_sync.make_stale_train_step(loss_fn, optimizer, scfg,
                                           compensator=compensator,
                                           shard=placement)

    def ring_step_inner(inner, batch, bound, comp):
        if compensator is None:
            inner, m = raw(inner, batch, bound=bound)
            return inner, comp, m
        return raw(inner, batch, bound=bound, comp=comp)

    per_worker_ring = mode == "ssp" or cfg.per_worker_delays
    return engine(
        lambda params, _ust, gen, rows=rows, whole=None: stale_sync.init_state(
            params, optimizer, scfg, gen, rows=rows,
            buf_like=whole if per_worker_ring else None),
        ring_step_inner, lambda inner: inner.params, max_bound)
