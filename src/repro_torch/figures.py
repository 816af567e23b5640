"""The paper's Figs. 1-3 on the port: twins of
``benchmarks/fig1_depth_staleness.py``, ``fig2_algorithms.py`` and
``fig3_mf_lda_vae.py``, with the same rows, CSV names, headers and
``quick`` grids, over ``repro_torch.experiments``.

    python -m repro_torch.figures [--only fig1|fig2|fig3] [--quick] [--cpu]
        [--out rows.json]

Runs on CUDA unless ``--cpu`` (``device="cpu"``). Nothing is written unless
``--out`` names a file; the JAX package's records under ``experiments/``
are never touched.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import experiments

ALGOS = ["sgd", "momentum", "adam", "adagrad", "rmsprop"]


def _norm_rows(tag, key, per_s, stalenesses):
    base = per_s.get(0)
    return [(tag, *key, s, round((per_s[s] / base) if (base and per_s[s])
                                 else float("nan"), 3))
            for s in stalenesses]


def fig1_run(quick: bool = False, workers: int = 8, seeds=(0,), device=None):
    """Fig. 1(e)(f): DNN/MLR batches-to-target vs staleness by depth."""
    depths = [0, 1, 3] if quick else [0, 1, 2, 3]
    stalenesses = [0, 8, 16] if quick else [0, 4, 8, 16]
    algos = ["sgd"] if quick else ["sgd", "adam"]
    max_steps = 1500 if quick else 4000

    rows = []
    for algo in algos:
        for depth in depths:
            per_s = {}
            for s in stalenesses:
                btts = []
                for seed in seeds:
                    r = experiments.dnn_experiment(
                        depth=depth, algo=algo, s=s, workers=workers,
                        seed=seed, max_steps=max_steps, device=device)
                    btts.append(r.batches_to_target if r.converged else None)
                ok = [b for b in btts if b is not None]
                per_s[s] = (sum(ok) / len(ok)) if ok else None
                rows.append(("dnn", algo, depth, s,
                             per_s[s] if per_s[s] else -1))
            rows += _norm_rows("dnn_norm", (algo, depth), per_s, stalenesses)

    experiments.print_csv("fig1_dnn", rows,
                          "model,algo,depth,staleness,batches_or_norm")
    return rows


def fig1_run_cnn(quick: bool = False, workers: int = 8, device=None):
    """Fig. 1(a)-(d): ResNet depth scaling, at the reduced widths."""
    blocks = [1, 2] if quick else [1, 2, 3]   # ResNet8 / 14 / 20
    stalenesses = [0, 8] if quick else [0, 4, 8, 16]
    rows = []
    for algo in (["sgd"] if quick else ["sgd", "adam"]):
        for n in blocks:
            per_s = {}
            for s in stalenesses:
                r = experiments.cnn_experiment(
                    n_blocks=n, algo=algo, s=s, workers=workers,
                    max_steps=400 if quick else 1200, device=device)
                per_s[s] = r.batches_to_target if r.converged else None
                rows.append(("cnn", algo, 6 * n + 2, s, per_s[s] or -1))
            rows += _norm_rows("cnn_norm", (algo, 6 * n + 2), per_s,
                               stalenesses)
    experiments.print_csv("fig1_cnn", rows,
                          "model,algo,depth,staleness,batches_or_norm")
    return rows


def fig2_run(quick: bool = False, workers: int = 8, device=None):
    """Fig. 2: five algorithms on ResNet8, normalized by s = 0."""
    stalenesses = [0, 8] if quick else [0, 4, 8, 16]
    algos = ["sgd", "adam", "rmsprop"] if quick else ALGOS
    rows = []
    for algo in algos:
        per_s = {}
        for s in stalenesses:
            r = experiments.cnn_experiment(
                n_blocks=1, algo=algo, s=s, workers=workers,
                max_steps=400 if quick else 1200, device=device)
            per_s[s] = r.batches_to_target if r.converged else None
            rows.append(("cnn_resnet8", algo, s, per_s[s] or -1))
        rows += _norm_rows("cnn_resnet8_norm", (algo,), per_s, stalenesses)
    experiments.print_csv("fig2_algorithms", rows,
                          "model,algo,staleness,batches_or_norm")
    return rows


def fig2_run_dnn_algos(quick: bool = False, workers: int = 1, device=None):
    """Appendix Fig. 7 companion: DNN depth x algorithm on 1 worker."""
    stalenesses = [0, 16] if quick else [0, 8, 16, 32]
    algos = ["sgd", "adam"] if quick else ALGOS
    depths = [1] if quick else [0, 1, 3]
    rows = []
    for algo in algos:
        for depth in depths:
            for s in stalenesses:
                r = experiments.dnn_experiment(
                    depth=depth, algo=algo, s=s, workers=workers,
                    max_steps=2000 if quick else 8000, device=device)
                btt = r.batches_to_target if r.converged else None
                rows.append(("dnn", algo, depth, s, btt or -1))
    experiments.print_csv("fig7_dnn_algos", rows,
                          "model,algo,depth,staleness,batches")
    return rows


def fig3_run_mf(quick: bool = False, device=None):
    """Fig. 3(a)(b): MF under 4 and 8 workers."""
    stalenesses = [0, 10, 20] if quick else [0, 5, 10, 15, 20, 30, 50]
    rows = []
    for workers in [4, 8]:
        per_s = {}
        for s in stalenesses:
            r = experiments.mf_experiment(
                s=s, workers=workers, max_steps=3000 if quick else 6000,
                device=device)
            per_s[s] = r.batches_to_target if r.converged else None
            rows.append(("mf", workers, s, per_s[s] or -1))
        rows += _norm_rows("mf_norm", (workers,), per_s, stalenesses)
    experiments.print_csv("fig3_mf", rows,
                          "model,workers,staleness,batches_or_norm")
    return rows


def fig3_run_lda(quick: bool = False, device=None):
    """Fig. 3(c)(d): LDA's final log-likelihood by staleness."""
    stalenesses = [0, 10, 20] if quick else [0, 5, 10, 15, 20]
    rows = []
    for workers, k in ([(2, 10)] if quick else [(2, 10), (8, 10), (2, 50)]):
        for s in stalenesses:
            curve = experiments.lda_experiment(
                s=s, workers=workers, k_topics=k, sweeps=6 if quick else 30,
                device=device)
            final_ll = curve[-1][1] if curve else float("nan")
            rows.append(("lda", workers, k, s, round(final_ll, 1)))
    experiments.print_csv("fig3_lda", rows,
                          "model,workers,topics,staleness,final_ll")
    return rows


def fig3_run_vae(quick: bool = False, device=None):
    """Fig. 3(e)(f): VAE batches-to-target by depth and algorithm."""
    stalenesses = [0, 8] if quick else [0, 4, 8, 16]
    depths = [1] if quick else [1, 2, 3]
    rows = []
    for algo in (["adam"] if quick else ["adam", "sgd"]):
        for depth in depths:
            per_s = {}
            for s in stalenesses:
                r = experiments.vae_experiment(
                    depth=depth, algo=algo, s=s, workers=8,
                    max_steps=1500 if quick else 4000, device=device)
                per_s[s] = r.batches_to_target if r.converged else None
                rows.append(("vae", algo, depth, s, per_s[s] or -1))
            rows += _norm_rows("vae_norm", (algo, depth), per_s, stalenesses)
    experiments.print_csv("fig3_vae", rows,
                          "model,algo,depth,staleness,batches_or_norm")
    return rows


def main(only=None, quick: bool = False, out=None, device=None) -> dict:
    """Each figure's rows, as the JAX mains collect them (``fig2`` adds the
    DNN algorithm rows only outside ``quick``): ``{"fig1": rows, ...}`` for
    ``only`` (a figure name) or all three. Writes JSON to ``out`` if
    given."""
    figs = {
        "fig1": lambda: (fig1_run(quick=quick, device=device)
                         + fig1_run_cnn(quick=quick, device=device)),
        "fig2": lambda: (fig2_run(quick=quick, device=device)
                         + ([] if quick else
                            fig2_run_dnn_algos(quick=quick, device=device))),
        "fig3": lambda: (fig3_run_mf(quick, device=device)
                         + fig3_run_lda(quick, device=device)
                         + fig3_run_vae(quick, device=device)),
    }
    if only is not None and only not in figs:
        raise ValueError(f"unknown figure {only!r}; have {sorted(figs)}")
    rows = {name: run() for name, run in figs.items()
            if only is None or name == only}
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["fig1", "fig2", "fig3"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    main(only=args.only, quick=args.quick, out=args.out,
         device="cpu" if args.cpu else None)
