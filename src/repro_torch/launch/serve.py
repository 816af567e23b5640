"""Serving CLI (twin of ``python -m repro.launch.serve``): a thin client
over the ``repro_torch.serving`` request plane — admission queue, continuous
batching at ``--batch`` slots, the packed paged decode-cache, and optionally
live parameter refresh from a training run's snapshot directory.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --reduced --batch 8 --prompt-len 64 --gen 32 [--greedy] \\
      [--params CKPT_DIR [--refresh-every N]] [--cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --mesh 1x2 --arch deepseek-7b --reduced --greedy [--cpu]

Runs on CUDA unless ``--cpu`` is given. ``--params CKPT_DIR`` serves from
the latest committed snapshot (either package's format); ``--refresh-every
N`` keeps polling that directory every N decode steps and hot-swaps newer
snapshots mid-stream, reporting the realized parameter staleness of the
served tokens. ``--mesh DATAxMODEL`` other than ``1x1`` serves over the
ranks of a ``torchrun`` launch (``serving/server.py``): every rank serves
every request, and rank 0 alone prints. On a model axis above 1 it prints
``model axis: tensor-parallel`` (the ranks serve their shards) or
``model axis: gathered (why)`` (whole params on every rank).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.base import InputShape
from repro_torch.serving import Request, Server, ServingConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="continuous-batch width (serving slots)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--greedy", action="store_true",
                    help="argmax decoding (same as --temperature 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1",
                    help="host mesh 'DATAxMODEL'; other than 1x1, run under "
                         "torchrun with DATA x MODEL ranks")
    ap.add_argument("--params", default=None, metavar="CKPT_DIR",
                    help="serve from the latest committed snapshot instead "
                         "of fresh-init params")
    ap.add_argument("--refresh-every", type=int, default=0, metavar="N",
                    help="with --params: hot-swap newer snapshots every N "
                         "decode steps (0 = serve one snapshot)")
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--paged", choices=("off", "auto", "on"), default="auto",
                    help="serve decode route: 'off' forces the gather "
                         "reference, 'auto'/'on' read the page pool in place "
                         "through the paged attention kernel")
    ap.add_argument("--prefill-batch", type=int, default=None, metavar="B",
                    help="max requests prefilled per admission call "
                         "(default: the slot count)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = ServingConfig(
        arch=args.arch, reduced=args.reduced, slots=args.batch,
        prompt_len=args.prompt_len, max_seq=args.prompt_len + args.gen,
        page_tokens=args.page_tokens,
        temperature=0.0 if args.greedy else args.temperature,
        seed=args.seed, mesh=args.mesh, paged=args.paged,
        prefill_batch=(args.batch if args.prefill_batch is None
                       else args.prefill_batch))
    server = Server(cfg, device="cpu" if args.cpu else None)
    api = server.api
    lead = server.mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    compute, why = server.model_compute
    if compute is not None:
        say(f"model axis: {compute}" + (f" ({why})" if why else ""))

    base_step = 0
    if args.params:
        base_step = server.restore_params(args.params)
        say(f"serving snapshot step {base_step} from {args.params}")
        if args.refresh_every:
            server.make_refresher(args.params,
                                  every_steps=args.refresh_every,
                                  base_step=base_step)

    # Each request's features (enc-dec frames, VLM patch features) are
    # drawn before its prompt, as the JAX CLI draws them.
    spec = api.batch_spec(InputShape("serve_request", args.prompt_len, 1,
                                     "prefill"))
    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(args.batch):
        features = {name: rng.standard_normal(shape).astype(np.float32)
                    for name, (shape, _) in sorted(spec.items())
                    if name != "tokens"}
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, api.vocab_real,
                                (args.prompt_len,)).astype(np.int32),
            max_new_tokens=args.gen, features=features or None))

    report = server.run(reqs)
    rep = server.dispatch_report()
    why = f" ({rep['why']})" if rep["why"] else ""
    mesh = "" if server.mesh is None else f" over mesh {args.mesh}"
    say(f"serve dispatch: paged={rep['paged']}{why} on {server.device}"
        f"{mesh}")
    for op, backend in rep["decisions"].items():
        say(f"  {op:<16} -> {backend}")
    summary = report.summary()
    say(json.dumps(summary, indent=1))
    say(f"decode: {summary['tokens_total']} tokens over "
        f"{report.decode_steps} continuous-batch steps "
        f"({summary['tokens_per_s']} tok/s)")
    first = min(report.completed, key=lambda r: r.rid)
    say("sample row 0:", first.tokens[:24])
    return {"server": server, "report": report}


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
