"""Serving smoke (twin of ``python -m repro.serving``): a live ``sync``
Trainer publishes parameter snapshots while the server drains a staggered
request stream — admission -> batched prefill -> continuous decode
(requests join AND evict mid-stream) -> eviction — hot-swapping params
between decode steps and stamping every served token with its realized
parameter staleness (publisher steps behind + wall-clock age).

  PYTHONPATH=src python -m repro_torch.serving          # on CUDA
  PYTHONPATH=src python -m repro_torch.serving --cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.engine import EngineConfig, Trainer, build_engine
from repro_torch.optim import optimizers as optlib
from repro_torch.serving import (Server, ServingConfig, SnapshotPublisherHook,
                                 synthetic_requests)

ARCH = "deepseek-7b"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    api = cfglib.get(ARCH).api(reduced=True)
    snap_dir = tempfile.mkdtemp(prefix="serving_smoke_")

    # The trainer half: a real (tiny) engine on the SAME architecture, so
    # published snapshots match the server's parameter structure.
    eng = build_engine(api, optlib.get_optimizer("adam"),
                       EngineConfig(mode="sync", num_workers=1),
                       device=device)
    publisher = SnapshotPublisherHook(snap_dir, every=2, keep_last=3)
    rng = np.random.default_rng(0)

    def batch_fn():
        time.sleep(0.05)  # pace publishes across the serve window
        toks = rng.integers(0, api.vocab_real, (2, 17), dtype=np.int32)
        return {"tokens": toks}

    trainer = threading.Thread(
        target=lambda: Trainer(eng, hooks=[publisher]).run(batch_fn, 16),
        daemon=True)

    # The serving half: 5 requests over 2 slots — continuous batching MUST
    # cycle slots (joins > slots), exercising evict-then-join page reuse.
    # paged="auto" resolves to the in-place page-table attention route;
    # prefill_batch=2 exercises batched admission.
    cfg = ServingConfig(arch=ARCH, reduced=True, slots=2, prompt_len=8,
                        max_seq=24, page_tokens=4, temperature=0.0, seed=0,
                        paged="auto", prefill_batch=2)
    server = Server(cfg, device=device)
    assert server.paged_route == "paged", server.dispatch_report()
    server.make_refresher(snap_dir, every_steps=2)
    gens = [10, 13, 9, 12, 11]
    # The first two arrive together, so the opening admission coalesces
    # them into ONE batched prefill (prefill_calls < joins below).
    reqs = synthetic_requests(5, cfg.prompt_len, 1, api.vocab_real,
                              arrivals=[0.0, 0.0, 0.1, 0.15, 0.2], seed=1)
    for r, g in zip(reqs, gens):
        r.max_new_tokens = g

    trainer.start()
    # Serve once a snapshot exists, so at least one refresh is guaranteed.
    deadline = time.monotonic() + 600
    while ckpt.latest_step(snap_dir) is None:
        if time.monotonic() > deadline:
            raise TimeoutError("trainer never published a snapshot")
        time.sleep(0.05)

    report = server.run(reqs)
    trainer.join(timeout=300)
    summary = report.summary()
    print(json.dumps(summary, indent=1))

    drep = server.dispatch_report()
    print(f"serve dispatch: paged={drep['paged']} on {server.device}")
    for op, backend in drep["decisions"].items():
        print(f"  {op:<16} -> {backend}")
    # The paged decode steps went through the dispatcher: the CUDA kernel
    # on the card, the plain version on the CPU.
    want = "ref" if server.device.type == "cpu" else "cuda"
    assert drep["decisions"].get("paged_attention", "").startswith(want), \
        drep
    assert report.prefill_calls < report.joins, \
        "batched admission never coalesced a prefill"
    assert len(report.completed) == 5, summary
    assert report.joins == 5 and report.evicts == 5, summary
    assert report.joins > cfg.slots, "continuous batching never cycled a slot"
    assert [len(r.tokens) for r in
            sorted(report.completed, key=lambda r: r.rid)] == gens, summary
    assert publisher.published, "trainer published no snapshots"
    assert report.refreshes >= 1, "server never hot-swapped params"
    assert all(len(r.staleness) == len(r.tokens) for r in report.completed), \
        "served tokens missing staleness stamps"
    stale = summary["staleness"]
    assert stale["mean_steps_behind"] is not None
    assert stale["mean_param_age_s"] is not None, \
        "no served token carried a published-params age"
    print(f"served {summary['tokens_total']} tokens at "
          f"{summary['tokens_per_s']} tok/s; params refreshed "
          f"{report.refreshes}x up to publisher step "
          f"{server.refresher.current_step} of {max(publisher.published)}")
    print("SERVING_SMOKE_OK")
    return 0


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.exit(main())
