"""The serving runtime loop: admission -> prefill/join -> continuous decode
(port of ``repro/serving/server.py``).

One :class:`Server` owns the planned steps (``plan_prefill`` for
admissions, ``plan_serve_step`` for the continuous batch) plus the paged
cache and the batcher. The loop per iteration:

1. **refresh** — swap in newer trainer-published params (snapshot.py),
2. **expire** — reject queued requests whose deadline already passed,
3. **admit**  — drain every arrived request that fits (a free slot AND page
   budget), then prefill them together: grouped by padded prompt length,
   in batches of up to ``prefill_batch`` chunked to powers of two, each
   slot's cache packed token-major, grafted onto the empty ring template,
   pages written, batch joined,
4. **decode** — one step over all slots (masked lanes inert),
5. **harvest** — append each active slot's token, stamp it with the
   realized parameter staleness, evict finished / past-deadline requests
   (their pages return to the free list for the next admission).

Under the paged decode route (``ServingConfig.paged``) page allocation is
lazy: a request claims only the pages its prompt + budget will touch, so
``max_seq`` may exceed what ``num_pages`` could hold per slot eagerly.

The server runs on CUDA unless constructed with ``device="cpu"``; sampling
at ``temperature > 0`` draws from ``torch.Generator``s seeded from
``cfg.seed``.

On a ``DeviceMesh`` (``cfg.mesh`` under ``torchrun``, or ``mesh=``) every
rank runs the same loop over every slot, as the JAX plan replicates the
pages' tables, positions and tokens. Params are restored as this rank's
shards of the serve plan's placement (``engine/placement.py::
ServePlacement``). On a model axis where ``tensor_parallel_verdict`` holds
(``model_compute`` ``"tensor-parallel"``: the decoder-only transformers,
dense and MoE) the server serves those shards as they are: prefill and
both decode routes run under the placement's model-parallel context
(``models/transformer.py``), each rank's page pool holds the kv heads it
attends with (``serving/cache.py``) and the logits are gathered whole
before a token is picked. Elsewhere (``"gathered"``) the model-axis
shards are made whole once a load or refresh. An FSDP arch's data-axis
blocks (``embed`` on data) stay blocks, at boot, load and refresh alike:
prefill and decode read the params through the placement's ``fetch``
(``rules.use_fetch``), which gathers one layer at a time over the data
group as the model reads it, and the model drops it after use, so no rank
holds the served copy whole. The ranks stay in lockstep because rank 0 takes
every host decision (the clock's ``now``, the snapshot step to load, the
staleness stamps, the measured times) and every rank applies rank 0's:
one host broadcast between decode steps, one a prefill call, an
``all_reduce`` a refresh (did every rank load?) and one broadcast at the
end of a run. The sampling generators are seeded alike. Every rank
returns the same ``ServeReport``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch import device as device_lib
from repro_torch import treemath as tm
from repro_torch.configs.base import InputShape
from repro_torch.engine import plan as planlib
from repro_torch.engine import placement as placement_lib
from repro_torch.launch import mesh as meshlib
from repro_torch.serving.batcher import ContinuousBatcher, SlotState
from repro_torch.serving.cache import PagedDecodeCache, build_layout
from repro_torch.serving.queue import AdmissionQueue, Clock, Request
from repro_torch.models import layers
from repro_torch.serving.snapshot import SnapshotRefresher
from repro_torch.sharding import rules as rules_lib

Pytree = Any


@dataclasses.dataclass
class ServingConfig:
    arch: str = "deepseek-7b"
    reduced: bool = True
    overrides: Optional[dict] = None
    slots: int = 4                    # continuous-batch width
    prompt_len: int = 16              # admission prefill length (pad/trunc)
    max_seq: int = 64                 # decode-cache capacity per slot
    page_tokens: int = 8              # ring rows per page
    num_pages: Optional[int] = None   # default: slots * pages_per_slot
    temperature: float = 0.0          # <= 0 -> greedy argmax
    seed: int = 0
    mesh: str = "1x1"                 # host mesh "DATAxMODEL" (torchrun)
    virtual_dt: Optional[float] = None  # fixed seconds/step clock for tests
    paged: str = "auto"               # serve decode route: off | auto | on
    prefill_batch: int = 1            # max requests prefilled per call
    # Pad prompts up to a multiple of this instead of always prompt_len.
    prefill_bucket: Optional[int] = None


@dataclasses.dataclass
class ServedRequest:
    rid: int
    tokens: List[int]
    reason: str                       # "done" | "deadline"
    arrival_s: float
    join_s: float
    finish_s: float
    ttft_s: float
    # per-token realized parameter staleness: (publisher steps behind,
    # seconds since the served params were published); (0, None) without a
    # refresher / before the first publish.
    staleness: List[Tuple[int, Optional[float]]]

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass
class ServeReport:
    completed: List[ServedRequest]
    expired_rids: List[int]
    wall_s: float
    decode_steps: int
    joins: int
    evicts: int
    refreshes: int
    prefill_calls: int = 0
    # How a model axis above 1 read the params: "tensor-parallel" or
    # "gathered" (None without one).
    model_compute: Optional[str] = None
    # wall seconds by loop phase: admit (queue/pack/alloc, prefill excluded),
    # prefill (prefill calls, synchronised), decode (serve steps + sync).
    phase_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def tokens_total(self) -> int:
        return sum(len(r.tokens) for r in self.completed)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_total / self.wall_s if self.wall_s > 0 else 0.0

    def _latency(self, q: float) -> Optional[float]:
        lats = [r.latency_s for r in self.completed]
        return float(np.percentile(lats, q)) if lats else None

    def staleness_summary(self) -> Dict[str, Optional[float]]:
        steps = [s for r in self.completed for s, _ in r.staleness]
        ages = [a for r in self.completed for _, a in r.staleness
                if a is not None]
        return {
            "mean_steps_behind": float(np.mean(steps)) if steps else None,
            "max_steps_behind": int(np.max(steps)) if steps else None,
            "mean_param_age_s": float(np.mean(ages)) if ages else None,
        }

    def summary(self) -> dict:
        ttfts = [r.ttft_s for r in self.completed]
        return {
            "requests_completed": len(self.completed),
            "requests_expired": len(self.expired_rids),
            "tokens_total": self.tokens_total,
            "tokens_per_s": round(self.tokens_per_s, 1),
            "wall_s": round(self.wall_s, 3),
            "decode_steps": self.decode_steps,
            "joins": self.joins,
            "evicts": self.evicts,
            "refreshes": self.refreshes,
            "prefill_calls": self.prefill_calls,
            "phase_s": {k: round(v, 4) for k, v in self.phase_s.items()},
            "ttft_p50_s": (round(float(np.percentile(ttfts, 50)), 4)
                           if ttfts else None),
            "ttft_p99_s": (round(float(np.percentile(ttfts, 99)), 4)
                           if ttfts else None),
            "latency_p50_s": (round(self._latency(50), 4)
                              if self.completed else None),
            "latency_p99_s": (round(self._latency(99), 4)
                              if self.completed else None),
            "staleness": self.staleness_summary(),
        } | ({} if self.model_compute is None
             else {"model_compute": self.model_compute})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Server:
    """Continuous-batching request server over one architecture, on
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: ServingConfig, params: Optional[Pytree] = None,
                 refresher: Optional[SnapshotRefresher] = None, device=None,
                 mesh=None):
        self.cfg = cfg
        self.device = device_lib.resolve(device)
        self.arch = cfglib.get(cfg.arch)
        self.api = self.arch.api(reduced=cfg.reduced, overrides=cfg.overrides)
        # ``mesh`` (a DeviceMesh over the process group) takes the place of
        # cfg.mesh, as build_engine(mesh=) takes one.
        self.mesh = (meshlib.parse_host_mesh(cfg.mesh, device=self.device)
                     if mesh is None else mesh)
        if self.mesh is not None:
            if not placement_lib.is_device_mesh(self.mesh):
                raise ValueError("an abstract mesh plans placements only; "
                                 "serve on a DeviceMesh")
            if self.mesh.device_type != self.device.type:
                raise ValueError(
                    f"mesh on {self.mesh.device_type!r} devices, server on "
                    f"{self.device.type!r}: pass device= to match")
        self._pshape = InputShape("serve_prefill", cfg.prompt_len, 1, "prefill")
        dshape = InputShape("serve_decode", cfg.max_seq, cfg.slots, "decode")
        self.placement = None
        if self.mesh is not None:
            self.placement = placement_lib.ServePlacement(
                self.mesh, planlib.params_specs(self.api, self.mesh,
                                                self.arch, dshape),
                self.api.init(0, device="meta")[0], api=self.api,
                rules=rules_lib.rules_for_arch(self.arch, dshape, self.mesh))
        # The tensor-parallel route's context (None: whole params); the
        # cache layout is this rank's under it. The read of the params'
        # data blocks (None: they are whole).
        self.model_parallel = (None if self.placement is None
                               else self.placement.model_parallel)
        self._fetch = (None if self.placement is None
                       or self.placement.data_axis is None
                       else self.placement.fetch)
        with self._on_shards():
            self.layout = build_layout(self.api, cfg.max_seq,
                                       cfg.page_tokens, device=self.device)
        self.paged_route, self._paged_why = planlib.resolve_serve_paged(
            self.api, self.layout, self.arch, self.mesh, cfg.paged)
        # The paged route masks null-page rows in the kernel, so requests
        # claim only the pages they will touch; the gather route reads whole
        # rings and needs every slot fully paged.
        self._lazy_pages = self.paged_route == "paged"
        self.cache = PagedDecodeCache(self.layout, cfg.slots, cfg.num_pages,
                                      lazy=self._lazy_pages,
                                      device=self.device)
        self.splan = planlib.plan_serve_step(
            self.arch, dshape, self.mesh, layout=self.layout,
            num_pages=self.cache.num_pages, overrides=cfg.overrides,
            reduced=cfg.reduced, paged=cfg.paged)
        self._prefill_plans = {}

        if params is None:
            # Each value is cut to what this rank serves as it is drawn:
            # the rank never holds the whole params.
            with layers.use_keep(self.placement.keep if self.placement
                                 is not None and self.placement.sharded
                                 else None):
                self.params, _ = self.api.init(cfg.seed, device=self.device)
        else:
            self.params = (params if self.placement is None
                           else self.placement.from_whole(params))
        del params
        # What a restore reads the names and devices from: empty leaves, so
        # a refresher does not keep the boot params alive.
        self._like = tm.tree_map(lambda x: x.new_empty(0), self.params)
        self.refresher = refresher
        self.batcher = ContinuousBatcher(cfg.slots)
        self._gen = device_lib.generator(cfg.seed, self.device)
        self.decode_steps = 0
        self.prefill_calls = 0
        self.phase_s = {"admit": 0.0, "prefill": 0.0, "decode": 0.0}

    def dispatch_report(self) -> dict:
        """Route + kernel dispatch decisions (``launch/serve.py``)."""
        from repro_torch.kernels import dispatch
        return {"paged": self.paged_route, "why": self._paged_why,
                "decisions": dispatch.report()}

    @property
    def model_compute(self) -> tuple:
        """``(route, why)`` of a model axis above 1: ``"tensor-parallel"``
        or ``"gathered"`` with the reason; ``(None, "")`` without one."""
        if self.placement is None:
            return None, ""
        return (self.placement.model_compute,
                self.placement.model_compute_fallback)

    @contextlib.contextmanager
    def _on_shards(self):
        """The context the steps run under: the placement's model-parallel
        one on the tensor-parallel route, and its ``fetch`` where it keeps
        data blocks (no-ops elsewhere)."""
        with rules_lib.use_model_parallel(self.model_parallel), \
                rules_lib.use_fetch(self._fetch):
            yield

    # -- params plumbing -----------------------------------------------------

    @property
    def _blocks(self) -> Optional[Pytree]:
        """What the server's own restores place each leaf by: this rank's
        block of the serve plan's placement, as a plain tensor
        (``ServePlacement.blocks``)."""
        return None if self.placement is None else self.placement.blocks()

    @property
    def _lead(self) -> bool:
        return self.placement is None or self.placement.is_lead

    def _decide(self, values: list) -> list:
        """Rank 0's host decisions on a mesh; the values as they are
        without one."""
        return values if self.placement is None else \
            self.placement.decide(values)

    def _served(self, shards: Pytree) -> Pytree:
        """What the steps read of restored ``shards``: the data blocks, and
        the model shards on the tensor-parallel route, else the model dims
        whole (``ServePlacement.serve``)."""
        return shards if self.placement is None else \
            self.placement.serve(shards)

    def restore_params(self, ckpt_dir: str) -> int:
        """Serve from the latest committed snapshot in ``ckpt_dir`` (either
        package's format; leaves land on the served params' device, on a
        mesh as this rank's shards, served as ``_served`` says). Returns
        the snapshot step."""
        from repro_torch.checkpoint import checkpoint as ckpt
        step, = self._decide([ckpt.latest_step(ckpt_dir) if self._lead
                              else None])
        if step is None:
            raise FileNotFoundError(f"no committed snapshot in {ckpt_dir}")
        shards, step, _ = ckpt.restore(ckpt.step_path(ckpt_dir, int(step)),
                                       like=self._like,
                                       shardings=self._blocks)
        self.params = self._served(shards)
        if self.refresher is not None:
            self.refresher.current_step = step
        return step

    def make_refresher(self, ckpt_dir: str, every_steps: int = 1,
                       base_step: int = 0) -> SnapshotRefresher:
        self.refresher = SnapshotRefresher(
            ckpt_dir, like=self._like, shardings=self._blocks,
            every_steps=every_steps, base_step=base_step)
        return self.refresher

    def _refresh(self, step: int) -> None:
        """Swap in snapshot ``step`` (rank 0's poll found it): every rank
        loads it, and swaps only if every rank could."""
        got = self.refresher.load(step)
        ok = got is not None
        if self.placement is not None:
            ok = self.placement.all_ok(ok)
        if not ok:
            return                      # pruned under a rank; retry later
        shards, extra = got
        self.refresher.swap(step, extra)
        self.params = self._served(shards)

    def _between_steps(self, clock: Clock):
        """Rank 0's host decisions between decode steps, in one broadcast
        on a mesh: the clock's ``now``, the staleness stamp of the tokens
        just decoded ((steps behind, seconds since publish), (0, None)
        without a refresher) and the snapshot step to swap in before the
        next one (None off the refresh period or with nothing newer)."""
        r, values = self.refresher, [clock.now(), 0, None, None]
        if r is not None and self._lead:
            values[1:3] = r.staleness()
            values[3] = r.poll(self.decode_steps)
        now, behind, age, step = self._decide(values)
        return (now, (int(behind), age),
                None if step is None else int(step))

    # -- admission -----------------------------------------------------------

    def _bucket_len(self, r: Request) -> int:
        """Padded prefill length for ``r``: prompt_len unless prefill_bucket
        quantisation is on (then the next multiple of the bucket)."""
        cap, q = self.cfg.prompt_len, self.cfg.prefill_bucket
        if not q:
            return cap
        n = max(1, min(len(r.prompt), cap))
        return min(cap, -(-n // q) * q)

    def _get_prefill(self, length: int, batch: int) -> planlib.Plan:
        """The prefill plan at (length, batch), cached per shape as the JAX
        package caches its jitted plans."""
        fn = self._prefill_plans.get((length, batch))
        if fn is None:
            fn = planlib.plan_prefill(
                self.arch, InputShape(f"serve_prefill_{length}x{batch}",
                                      length, batch, "prefill"), self.mesh,
                overrides=self.cfg.overrides,
                reduced=self.cfg.reduced)
            self._prefill_plans[(length, batch)] = fn
        return fn

    def _prefill_inputs(self, reqs: Sequence[Request],
                        length: int) -> Dict[str, torch.Tensor]:
        """The prefill batch: padded prompts, plus every extra feature of
        the family's batch spec (enc-dec ``frames``, VLM ``cross_feats``):
        a request's ``features[name]`` where it has one, else zeros of the
        spec's batch-1 shape, concatenated over the requests."""
        prompts = np.zeros((len(reqs), length), np.int32)
        for b, r in enumerate(reqs):
            n = min(len(r.prompt), length)
            prompts[b, :n] = np.asarray(r.prompt[:n], np.int32)
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        spec = self.api.batch_spec(self._pshape)
        for name, (shape, dtype) in spec.items():
            if name == "tokens":
                continue
            rows = []
            for r in reqs:
                feat = (r.features or {}).get(name)
                rows.append(torch.zeros(shape, dtype=dtype, device=self.device)
                            if feat is None else
                            torch.as_tensor(np.asarray(feat)).to(self.device,
                                                                 dtype))
            batch[name] = torch.cat(rows, dim=0)
        return batch

    def first_scores(self, logits: torch.Tensor, rid: int) -> torch.Tensor:
        """What request ``rid``'s first token is the argmax of, from its
        prefill logits: ``plan.pick_scores`` with a generator of its own."""
        gen = (device_lib.generator((self.cfg.seed << 20) + rid + 1,
                                    self.device)
               if self.cfg.temperature > 0 else None)
        return planlib.pick_scores(logits[0, -1].float(), gen,
                                   self.cfg.temperature)

    def _sample_first(self, logits: torch.Tensor, rid: int) -> int:
        return int(torch.argmax(self.first_scores(logits, rid)))

    def _pages_for(self, r: Request, length: int) -> Optional[List[int]]:
        """Page slots ``r`` will touch (lazy/paged route); None = eager full
        complement."""
        if not self._lazy_pages:
            return None
        return self.cache.pages_needed(length, r.max_new_tokens)

    def _admit(self, q: AdmissionQueue, now: float) -> None:
        """Drain every arrived request that fits, then prefill them together,
        grouped by padded length and chunked to power-of-two batches."""
        free = [i for i, s in enumerate(self.batcher.slots) if s is None]
        budget = self.cache.free_pages
        picked: List[Tuple[int, Request, int]] = []
        while free:
            r = q.pop_ready(now)
            if r is None:
                break
            length = self._bucket_len(r)
            pages = self._pages_for(r, length)
            need = (self.layout.pages_per_slot if pages is None
                    else len(pages))
            if need > budget:
                q.push_front(r)
                break
            budget -= need
            picked.append((free.pop(0), r, length))
        groups: Dict[int, List[Tuple[int, Request]]] = {}
        for slot, r, length in picked:
            groups.setdefault(length, []).append((slot, r))
        for length, group in groups.items():
            i = 0
            while i < len(group):
                b = min(self.cfg.prefill_batch, len(group) - i)
                b = 1 << (max(b, 1).bit_length() - 1)  # power-of-two chunks
                self._join_group(group[i:i + b], length, now)
                i += b

    def _join_group(self, group: Sequence[Tuple[int, Request]], length: int,
                    now: float) -> None:
        t0 = time.monotonic()
        reqs = [r for _, r in group]
        with self._on_shards():
            logits, pcache = self._get_prefill(length, len(reqs))(
                self.params, self._prefill_inputs(reqs, length))
        _sync(self.device)
        elapsed, stale = self._with_staleness(time.monotonic() - t0)
        self.prefill_calls += 1
        self.phase_s["prefill"] += elapsed
        lay = self.layout
        for b, (slot, r) in enumerate(group):
            first = self._sample_first(logits[b:b + 1], r.rid)
            rows, res = lay.pack_rows(lay.slice_batch(pcache, b))
            if lay.has_tokens and rows.shape[0] < lay.tokens:
                # Prompt shorter than the ring: graft onto the empty template
                # (both rings index rows by pos % C, and prefill rows
                # [0, C_p) hold positions [0, C_p)).
                grafted = lay.empty_rows.clone()
                grafted[: rows.shape[0]] = rows
                rows = grafted
            self.cache.alloc(slot, self._pages_for(r, length))
            self.cache.write_rows(slot, rows, res)
            self.batcher.join(slot, SlotState(
                request=r, next_token=first, pos=length,
                remaining=r.max_new_tokens - 1, join_s=now,
                ttft_s=elapsed, tokens=[first], staleness=[stale]))

    def _with_staleness(self, value: float):
        """``(value, staleness stamp)``: rank 0's on a mesh, in one
        broadcast a prefill call. The stamp is (steps behind, seconds since
        publish), (0, None) without a refresher."""
        behind, age = (self.refresher.staleness()
                       if self.refresher is not None and self._lead
                       else (0, None))
        value, behind, age = self._decide([value, behind, age])
        return value, (int(behind), age)

    def step_inputs(self) -> tuple:
        """The serve step's arguments for the current batch:
        ``(params, pages, resident, tables, tokens, pos, mask, gen, temp)``."""
        tokens, pos, mask = self.batcher.arrays()
        dev = self.device
        return (self.params, self.cache.pages, self.cache.resident,
                self.cache.table_device(), torch.as_tensor(tokens, device=dev),
                torch.as_tensor(pos, device=dev),
                torch.as_tensor(mask, device=dev), self._gen,
                float(self.cfg.temperature))

    # -- the loop ------------------------------------------------------------

    def run(self, requests: Sequence[Request],
            max_steps: int = 1_000_000) -> ServeReport:
        q = AdmissionQueue(requests)
        clock = Clock(self.cfg.virtual_dt)
        completed: List[ServedRequest] = []
        expired: List[int] = []
        self.prefill_calls = 0
        self.phase_s = {"admit": 0.0, "prefill": 0.0, "decode": 0.0}
        t0 = time.monotonic()
        now, _, fresh = self._between_steps(clock)

        while q.pending or self.batcher.any_active:
            if fresh is not None:
                self._refresh(fresh)

            expired.extend(r.rid for r in q.expire(now))

            t_admit = time.monotonic()
            p_before = self.phase_s["prefill"]
            self._admit(q, now)
            self.phase_s["admit"] += ((time.monotonic() - t_admit)
                                      - (self.phase_s["prefill"] - p_before))

            # max_new_tokens == 1 is satisfied by the prefill token alone
            for i in self.batcher.active():
                if self.batcher.slots[i].remaining <= 0:
                    self._finish(i, completed, now, "done")

            if not self.batcher.any_active:
                clock.idle()
                now, _, fresh = self._between_steps(clock)
                continue

            t_dec = time.monotonic()
            with self._on_shards():
                next_tok, self.cache.pages, self.cache.resident = self.splan(
                    *self.step_inputs())
            next_np = next_tok.cpu().numpy()          # sync for honest timing
            self.phase_s["decode"] += time.monotonic() - t_dec
            self.decode_steps += 1
            clock.tick()
            now, stale, fresh = self._between_steps(clock)
            for i in self.batcher.active():
                s = self.batcher.slots[i]
                s.next_token = int(next_np[i])
                s.pos += 1
                s.remaining -= 1
                s.tokens.append(s.next_token)
                s.staleness.append(stale)
                past_deadline = (s.request.deadline_s is not None
                                 and now >= s.request.deadline_s)
                if s.remaining <= 0 or past_deadline:
                    self._finish(i, completed, now,
                                 "done" if s.remaining <= 0 else "deadline")

            if self.decode_steps >= max_steps:
                break

        wall_s, *times = self._decide([time.monotonic() - t0,
                                       *self.phase_s.values()])
        self.phase_s = dict(zip(self.phase_s, times))
        return ServeReport(
            completed=completed, expired_rids=expired,
            wall_s=wall_s, decode_steps=self.decode_steps,
            joins=self.batcher.joins, evicts=self.batcher.evicts,
            refreshes=(self.refresher.refreshes if self.refresher else 0),
            prefill_calls=self.prefill_calls, phase_s=dict(self.phase_s),
            model_compute=self.model_compute[0])

    def _finish(self, slot: int, completed: List[ServedRequest], now: float,
                reason: str) -> None:
        s = self.batcher.evict(slot)
        self.cache.free(slot)
        completed.append(ServedRequest(
            rid=s.request.rid, tokens=list(s.tokens), reason=reason,
            arrival_s=s.request.arrival_s, join_s=s.join_s, finish_s=now,
            ttft_s=s.ttft_s, staleness=list(s.staleness)))
