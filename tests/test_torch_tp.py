"""Tensor-parallel compute on the model axis, held against one process and
against the JAX package on the CPU (``gloo``).

The file starts its own worlds (``_mesh_workers.tp_rank_main`` in 2 and 4
processes: a 1x2 and a 2x2 mesh) and runs the same cases in the parent
with no mesh. The reduced archs run with ``tp = 2`` (``dataclasses.replace``
through the registry's ``overrides``, in both packages), so their attention
modes are the full configs' at tp = 16: ``deepseek-7b`` head,
``h2o-danube-1.8b`` mixed, ``qwen3-14b`` contraction, and
``qwen2-moe-a2.7b``'s experts over the model axis.

Tolerances, and why:

* **Gradients** (one batch, fp32): the loss within 1e-6 relative and each
  leaf's gradient within 1e-5 of its largest element, against the port's
  one process and against ``jax.value_and_grad``. The row-parallel sums
  and the vocab-parallel cross-entropy add in another order than one
  einsum, so agreement is fp32 roundoff, not bitwise.
* **Engine runs** (3 steps, Adam, SGD or momentum, kernels on): losses
  and grad_norms within 1e-5 relative, params by ``PLAIN_TOL`` or, with
  Adam, ``_mesh_workers.adam_close`` leaf by leaf: Adam normalises
  near-zero gradient elements, so roundoff can flip such an element's step
  of ``lr`` (1e-3), in a few elements of a leaf. Every rank ends with the
  same params bit for bit.
* **The top-k threshold** on a shared accumulator: bitwise the one-process
  threshold, below and above ``EXACT_TOPK_MAX``, and the sparsity bitwise.
* **Serving on the shards** (``SERVE_RTOL``, ``NEAR_TIE``): each decode
  step fed the one process's token (``chip_smoke.Forcing``), the logits
  within 1e-5 of the largest |logit| of one process's and of JAX's
  ``decode`` (fp32 roundoff of the row-parallel sums and the vocab
  gather), the picks the one process's wherever its top-2 margin is not
  below 1e-4.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mesh_workers as W
from repro import configs as jcfg
from repro_torch import configs as cfglib
from repro_torch import treemath as tm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-5
TRAJ_RTOL = 1e-5
# ``params_gap`` limits (largest element, whole tree relative to the
# params' movement) after TP_STEPS steps of SGD or momentum, which carry
# the gradients' roundoff (3e-8 and 1.6e-6 measured on the CPU); Adam runs
# are held leaf by leaf by ``adam_close``.
PLAIN_TOL = (1e-6, 1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _run_world(world: int, out_dir: str) -> list:
    port = _free_port()
    code = ("import sys, _mesh_workers as W; "
            "W.tp_rank_main(int(sys.argv[1]), int(sys.argv[2]), "
            "int(sys.argv[3]), sys.argv[4])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(port), out_dir],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {"1x2": _run_world(2, str(tmp_path_factory.mktemp("tp2"))),
            "2x2": _run_world(4, str(tmp_path_factory.mktemp("tp4")))}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("mode", list(W.TP_ARCHS))
def test_tp_gradients_match_one_process_and_jax(worlds, mode):
    """Loss and every leaf's gradient (gathered whole) on each 1x2 rank
    against the port's one process and ``jax.value_and_grad`` on the same
    params and tokens. The loss never gathers a model-sharded leaf: no
    ``placement.full`` call, and the model axis's only gather is the MoE
    router's logits."""
    ref = W.tp_grad_case(mode)
    api = W.tp_api(W.TP_ARCHS[mode])
    assert api.cfg.attn_mode == ("head" if mode == "moe" else mode)
    japi = jcfg.get(W.TP_ARCHS[mode]).api(reduced=True,
                                          overrides=W.TP_OVERRIDES)
    params = api.init(0, device="cpu")[0]
    jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params)
    tokens = W.tp_tokens(api.vocab_real).numpy()
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, {"tokens": tokens})))(jp)
    _close(ref["loss"], jloss, LOSS_RTOL)
    for g, jg in zip(ref["grads"], jax.tree_util.tree_leaves(jgrad)):
        _close(g, jg, GRAD_RTOL)
    for out in worlds["1x2"]:
        got = out["grads"][mode]
        assert got["model_compute"] == "tensor-parallel"
        assert got["full_calls"] == 0
        assert {label for kind, label, *_ in got["traffic"]
                if kind == "model.gather"} <= {"router"}
        assert (mode == "moe") == any(
            kind == "model.gather" for kind, *_ in got["traffic"])
        _close(got["loss"], ref["loss"], LOSS_RTOL)
        _close(got["loss"], jloss, LOSS_RTOL)
        assert len(got["grads"]) == len(ref["grads"])
        for g, r, jg in zip(got["grads"], ref["grads"],
                            jax.tree_util.tree_leaves(jgrad)):
            assert g.shape == r.shape
            _close(g, r, GRAD_RTOL)
            _close(g, jg, GRAD_RTOL)


def test_tp_moe_gradients_with_drops_and_a_dominant_aux_loss(worlds):
    """The reduced qwen2-moe with capacity drops (capacity factor 0.5) and
    its aux loss weighted 10, so that the router's gradient comes mostly
    from the aux loss, which every rank computes whole on the gathered
    logits: the loss and every leaf's gradient at 1x2 against one
    process, as the modes above are held."""
    extra = W.moe_drops_overrides()
    ref = W.tp_grad_case("moe", **extra)
    for out in worlds["1x2"]:
        got = out["moe_drops"]
        assert got["model_compute"] == "tensor-parallel"
        _close(got["loss"], ref["loss"], LOSS_RTOL)
        assert len(got["grads"]) == len(ref["grads"])
        for g, r in zip(got["grads"], ref["grads"]):
            _close(g, r, GRAD_RTOL)


def test_tp_dropped_reduce_is_a_planted_fault(worlds):
    """With "reduce" made the identity (a rank keeps its partial sums of
    each row-parallel product) the loss and gradients part from one
    process far past the limits above."""
    ref = W.tp_grad_case("head")
    for out in worlds["1x2"]:
        got = out["planted"]
        assert abs(float(got["loss"]) - float(ref["loss"])) > 1e-3
        assert max(float((g - r).abs().max() / r.abs().max())
                   for g, r in zip(got["grads"], ref["grads"])) > 1e-2


ENGINE_GRID = [(label, name) for label in W.TP_MESHES
               for name in W.TP_ENGINE_CASES] + [("2x2", "moe-stale-psum")]


def _engine_ref(label, name):
    if name == "moe-stale-psum":
        return W.tp_engine_case("stale-psum", None, label,
                                arch="qwen2-moe-a2.7b")
    return W.tp_engine_case(mesh=None, label=label,
                            **W.TP_ENGINE_CASES[name])


def _same_run(got, ref, compressed: bool, adam: bool):
    for g, r in zip(got["losses"], ref["losses"]):
        assert abs(g - r) <= TRAJ_RTOL * abs(r)
    assert len(got["grad_norms"]) == len(ref["grad_norms"])
    for g, r in zip(got["grad_norms"], ref["grad_norms"]):
        assert abs(g - r) <= TRAJ_RTOL * abs(r)
    assert len(got["sparsity"]) == len(ref["sparsity"]) == (
        W.TP_STEPS if compressed else 0)
    for g, r in zip(got["sparsity"], ref["sparsity"]):
        assert abs(g - r) <= 1e-4
    if adam:
        gaps = W.leaf_gaps(got["params"], ref["params"], ref["init"],
                           far=1e-4)
        assert W.adam_close(gaps), gaps
    else:
        gap = W.params_gap(got["params"], ref["params"], ref["init"])
        assert gap[0] <= PLAIN_TOL[0] and gap[1] <= PLAIN_TOL[1], gap


@pytest.mark.parametrize("label,name", ENGINE_GRID)
def test_tp_engine_matches_one_process(worlds, label, name):
    """The four modes with kernels on (the packed ring through
    ``stale_accum`` / ``fused_update``, sync's fused tail, simulate's
    ``fused_adam``) and the compressed legs (SGD top-k split by
    ``sparsify_topk``, Adam top-k by ``fused_update``'s EF split) on each
    rank's packed shards, at 1x2 and 2x2, against one process: every rank
    ends with the same params, the loss, grad_norm and sparsity of the
    whole row. A step never calls ``placement.full`` and gathers no
    model-sharded leaf."""
    ref = _engine_ref(label, name)
    compressed = "topk" in name
    for out in worlds[label]:
        got = out["engine"][name]
        assert got["model_compute"] == "tensor-parallel"
        delivery = got["kernels"]["delivery"]
        assert delivery == ("none" if "sync" in name else "packed")
        if "sgd" not in name:
            assert got["kernels"]["megakernel"] == "fused"
        assert got["full_calls"] == 0
        assert {label for kind, label, *_ in got["traffic"]
                if kind == "model.gather"} <= {"router"}
        _same_run(got, ref, compressed, adam="sgd" not in name)
    for out in worlds[label][1:]:
        assert all(torch.equal(a, b) for a, b in zip(
            tm.tree_leaves(out["engine"][name]["params"]),
            tm.tree_leaves(worlds[label][0]["engine"][name]["params"])))


def test_tp_threshold_is_the_whole_rows(worlds):
    """The compression threshold of each rank's packed shards is bitwise
    the one-process threshold of the whole row on the same accumulator:
    the union of the ranks' top-k up to ``EXACT_TOPK_MAX``, the strided
    sample of the whole row above it. The sparsity counts the whole row's
    nnz over its unpadded width, bitwise."""
    from repro_torch.compensate import EXACT_TOPK_MAX
    for label in W.TP_MESHES:
        for out in worlds[label]:
            got = out["threshold"]
            assert got["exact"]["total"] <= EXACT_TOPK_MAX
            assert got["sampled"]["total"] > EXACT_TOPK_MAX
            for case in got.values():
                for thr, want, sparsity, want_sparsity in case["got"].values():
                    assert torch.equal(thr, want)
                    assert torch.equal(sparsity, want_sparsity)


def test_tp_fsdp_arch_at_2x2(worlds):
    """Reduced deepseek-67b at tp = 2 (mixed attention) in sync on the 2x2
    mesh: the data axis gathers a layer at a time (FSDP) while the model
    axis computes on its shards, against one process."""
    ref = W.tp_engine_case(mesh=None, label="2x2", **W.TP_FSDP)
    for out in worlds["2x2"]:
        got = out["fsdp"]
        assert got["model_compute"] == "tensor-parallel"
        assert got["full_calls"] == 0
        assert not any(kind == "model.gather"
                       for kind, *_ in got["traffic"])
        _same_run(got, ref, compressed=False, adam=False)


def test_tp_leaves_fsdp_compression_and_pods_raising(worlds):
    """What a mesh still does not run raises with its ROADMAP item on the
    2x2 mesh: compression over an FSDP arch's data shards (A.20, the
    model axis tensor-parallel beside it) and a ``pod`` axis (A.19)."""
    for out in worlds["2x2"]:
        assert "ROADMAP A.20" in out["raises"]["fsdp-compress"]
        assert "ROADMAP A.19" in out["raises"]["pod"]


def test_tp_route_follows_arch_and_mesh(worlds):
    """``meta["model_compute"]``: tensor-parallel where the arch is a
    decoder-only transformer whose model-sharded dims divide by the extent;
    gathered, with the reason, for the reduced danube at tp = 1 (one kv
    head over two ranks), whisper, the vision model's cross layers and the
    state-space families."""
    for out in worlds["1x2"]:
        routes = out["routes"]
        assert routes["deepseek-7b", False] == ("tensor-parallel", None)
        assert routes["h2o-danube-1.8b", True] == ("tensor-parallel", None)
        route, why = routes["h2o-danube-1.8b", False]
        assert route == "gathered" and "does not divide by 2" in why
        assert routes["whisper-base", False] == ("gathered", "encdec family")
        assert routes["llama-3.2-vision-11b", False] == (
            "gathered", "cross-attention layers")
        assert routes["mamba2-1.3b", False] == ("gathered", "ssm family")
        assert routes["zamba2-7b", False] == ("gathered", "hybrid family")


def test_tp_train_cli_under_torchrun():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh
    1x2 --cpu``: reduced deepseek-7b (every model dim divides by 2) trains
    tensor-parallel, and rank 0 prints the one-process rows within fp32
    roundoff."""
    import json
    from repro_torch.launch import train
    args = ["--arch", "deepseek-7b", "--reduced", "--cpu", "--steps", "4",
            "--stale", "2", "--batch", "8", "--seq", "16", "--workers", "2",
            "--log-every", "2", "--kernels", "on"]
    env = _env()
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--mesh", "1x2"] + args,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("model axis: tensor-parallel") == 1
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    ref = train.main(args)["result"].history
    assert len(rows) == len(ref) == 2
    for got, want in zip(rows, ref):
        got.pop("wall_s"), want.pop("wall_s")
        assert set(got) == set(want)
        for key, value in want.items():
            if isinstance(value, float):
                assert abs(got[key] - value) <= TRAJ_RTOL * abs(value), key
            else:
                assert got[key] == value, key


# -- serving on the model axis's shards ------------------------------------------

# Teacher-forced logits (each step's input the one process's token) within
# SERVE_RTOL of the largest |logit| of the one process's and of JAX's
# ``decode``; tokens equal up to the first step whose one-process top-2
# margin is below NEAR_TIE and, each step's input being the one process's,
# at every later step whose margin is not below it. A dropped ``reduce``
# must part past PLANTED_FACTOR times the limit.
SERVE_RTOL, NEAR_TIE, PLANTED_FACTOR = 1e-5, 1e-4, 100
SERVE_GRID = [(label, case) for label in W.TP_MESHES
              for case in W.tp_serve_cases(label)]
_JAX_LOGITS = {}


def _jax_logits(arch: str, prompt, tokens) -> np.ndarray:
    """JAX's ``decode`` of the reduced ``arch`` (tp = 2) on the served
    params (seed 0), fed the prompt and then ``tokens``: the logits of
    each token, ``[len(tokens), vocab_real]``."""
    key = (arch, tuple(int(t) for t in prompt), tuple(tokens))
    if arch not in _JAX_LOGITS:
        japi = jcfg.get(arch).api(reduced=True, overrides=W.TP_OVERRIDES)
        params = W.tp_api(arch).init(0, device="cpu")[0]
        _JAX_LOGITS[arch] = (japi, jax.tree.map(
            lambda x: jnp.asarray(x.numpy()), params), jax.jit(japi.decode))
    if key not in _JAX_LOGITS:
        japi, jp, step = _JAX_LOGITS[arch]
        cache = japi.init_cache(1, W.SERVE["max_seq"])[0]
        inputs = list(prompt) + list(tokens[:-1])
        rows = []
        for pos, tok in enumerate(inputs):
            lg, cache = step(jp, jnp.asarray([[tok]], jnp.int32), cache,
                             jnp.int32(pos))
            if pos >= len(prompt) - 1:
                rows.append(np.asarray(lg[0, -1, :japi.vocab_real]))
        _JAX_LOGITS[key] = np.stack(rows)
    return _JAX_LOGITS[key]


def _pool_width(arch: str, m: int) -> int:
    """A rank's page-pool row: k and v of every layer at the kv heads it
    attends with (its own in head mode, else all: the reduced danube and
    qwen3 have one), plus ``slot_pos``."""
    cfg = W.tp_api(arch).cfg
    hkv = cfg.num_kv_heads // (m if cfg.attn_mode == "head" else 1)
    return cfg.num_layers * (2 * hkv * cfg.head_dim + 1)


def _forced_held(got: dict, ref: dict, prompts=None, arch=None) -> dict:
    """Hold a teacher-forced record against its one-process reference:
    the logits gap within SERVE_RTOL (and against JAX's ``decode`` with
    ``prompts``), the own picks equal up to each request's first near-tie.
    Returns the gaps and the near-ties."""
    from chip_smoke import logit_gap, parting
    gap = logit_gap(got, ref)
    assert gap["rel"] <= SERVE_RTOL, gap
    jgap = 0.0
    if prompts is not None:
        for rid, rows in got["logits"].items():
            want = _jax_logits(arch, prompts[rid], ref["tokens"][rid])
            scale = float(np.abs(want).max())
            jgap = max(jgap, float(np.abs(rows.numpy() - want).max()) / scale)
        assert jgap <= SERVE_RTOL, jgap
    part = parting(got["picks"], ref, NEAR_TIE)
    assert not part["parted"] and not part["flips"], part
    return {"rel": gap["rel"], "jax_rel": jgap, "ties": part["ties"]}


@pytest.mark.parametrize("label,case", SERVE_GRID)
def test_tp_serve_matches_one_process_and_jax(worlds, label, case):
    """Reduced deepseek-7b (head), qwen2-moe (head, MoE), danube (mixed,
    sliding window) and qwen3-14b (contraction) at tp = 2, served at 1x2
    (deepseek-7b also at 2x2) on the paged and gather routes, greedy and
    at temperature 0.7, on each rank's shards and teacher-forced with the
    one process's tokens: each rank's whole logits within SERVE_RTOL of the
    one process's and of JAX's ``decode`` on the same params, the same on
    every rank, its own picks the one process's up to a near-tie. A rank
    serves exactly its shards (no model-axis gather), from a pool of the
    kv heads it attends with; the server and its plan say so."""
    arch, route, temp = case
    m = W.TP_MESHES[label][1]
    ranks = [out["serve"][case] for out in worlds[label]]
    server = W.tp_server(arch, route, temp, None)
    prompts = {r.rid: r.prompt for r in W._serve_requests(
        server, W.TP_SERVE_GENS)}
    for got in ranks:
        assert got["model_compute"] == ("tensor-parallel", "")
        assert got["plan"] == {"model_compute": "tensor-parallel",
                               "model_compute_fallback": None,
                               "pool_width": got["pool_width"][0]}
        assert got["route"] == ("paged" if route == "paged" else "gather")
        assert got["pool_width"] == (_pool_width(arch, m),
                                     _pool_width(arch, 1))
        have, want, shapes_ok = got["bytes"]
        assert shapes_ok and have == want
        assert got["whole_gathers"] == 0
        held = _forced_held(got["got"], got["ref"], prompts, arch)
        for a, b in zip(got["got"]["logits"].values(),
                        ranks[0]["got"]["logits"].values()):
            assert torch.equal(a, b)
    print(f"{label} {case}: {held}")


def test_tp_serve_dropped_reduce_is_a_planted_fault(worlds):
    """With "reduce" made the identity the served logits part from one
    process's by more than PLANTED_FACTOR times the limit."""
    from chip_smoke import logit_gap
    for out in worlds["1x2"]:
        got = out["serve_planted"]
        assert logit_gap(got["got"], got["ref"])["rel"] > \
            PLANTED_FACTOR * SERVE_RTOL


def test_tp_serve_refresh_swaps_shards_on_the_same_step(worlds):
    """Booted from snapshot 1 and refreshed to snapshot 2 mid-serve on the
    tensor-parallel route: the swap lands on the one process's decode step
    on every rank, the served params are then bitwise the rank's shards of
    snapshot 2, no model-axis gather ran, and the forced logits hold."""
    for out in worlds["1x2"]:
        got = out["serve_refresh"]
        assert got["ref"]["swaps"] == got["got"]["swaps"]
        assert len(got["got"]["swaps"]) == 1
        assert (got["got"]["boot"], got["got"]["step"]) == (1, 2)
        assert got["shards_of_2"] and got["whole_gathers"] == 0
        _forced_held(got["got"], got["ref"])


def test_tp_serve_init_holds_only_shards(worlds):
    """A rank that inits its own params on the tensor-parallel route (no
    params handed to the server) cuts each value to its shard as it is
    drawn: its params are bitwise its shards of the one-process init,
    every leaf went through the placement's ``keep``, and the init's live
    param bytes never reach the whole params'."""
    for out in worlds["1x2"]:
        got = out["serve_init"]
        assert got["shards"]
        assert got["kept"] == got["served"] < got["whole"]
        assert got["peak"] < got["whole"], got


@pytest.mark.parametrize("arch", W.TP_SERVE_GATHERED)
def test_tp_serve_gathered_families_unchanged(worlds, arch):
    """The state-space LM and the encoder-decoder on a 1x2 mesh take the
    gathered serve (the reason given): whole params on every rank, tokens
    and stamps bit for bit the one process's."""
    for out in worlds["1x2"]:
        got = out["serve_gathered"][arch]
        route, why = got["got"]["model_compute"]
        assert route == "gathered" and why == (
            cfglib.get(arch).api(reduced=True).family + " family")
        assert got["whole"]
        for key in ("route", "tokens", "stamps", "counts"):
            assert got["got"][key] == got["ref"][key], key
