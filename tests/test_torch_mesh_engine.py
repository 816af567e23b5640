"""The port's engine across the ranks of a ``DeviceMesh``, held against the
one-process engine on the CPU (``gloo``).

Each world size starts its process group once (``_mesh_workers.rank_main``
in 2 and 4 processes, about 7 and 12 s) and runs every case there; the
parent runs the same cases with no mesh. What the tolerance is, and why:

* **Bitwise** wherever the mesh gathers a crossing's rows and reduces them
  in the one-process order: simulate's dispatch (every source into every
  destination) and the per-worker rings of stale-psum and ssp (the delayed
  aggregate). The 2x2 LM runs compute tensor-parallel on the model axis
  (``test_torch_tp.py``), so they are held to the sync limits below.
* **fp32 roundoff** where an all-reduce averages the gradients of a split
  batch (sync, the aggregate ring): each rank's backward sums its half of
  the batch, and the mean of two halves is not one backward's sum over
  the whole batch. MLP params within 1e-6, losses within 1e-6 relative.
  The 2x2 LM runs, whose Adam steps turn roundoff in near-zero gradient
  elements into steps of up to ``lr``, within ``adam_close`` leaf by leaf;
  their losses within 1e-6 relative at step 1 and 1e-4 after.

The FSDP archs (reduced deepseek-67b and kimi-k2, momentum) run in the
same worlds at 2x1, 4x1 and 2x2: params, momentum and the aggregate ring
as data-axis shards. Their per-worker modes gather the params whole and
are bitwise; sync and the aggregate ring reduce-scatter the gradients of
the ranks' batch shards and are held to the MLP sync limits.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _mesh_workers as W
from repro_torch import treemath as tm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


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
    """Start ``world`` rank processes once; returns each rank's results."""
    port = _free_port()
    code = ("import sys, _mesh_workers as W; "
            "W.rank_main(int(sys.argv[1]), int(sys.argv[2]), "
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
    return {w: _run_world(w, str(tmp_path_factory.mktemp(f"world{w}")))
            for w in (2, 4)}


@pytest.fixture(scope="module")
def one_process():
    return {name: W.mlp_case(name) for name in W.MLP_CASES}


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tm.tree_leaves(a), tm.tree_leaves(b)))


def _same(got: dict, ref: dict, exact: bool, atol: float = 1e-6,
          rtol: float = 1e-6) -> None:
    keys = [k for k in ("params", "workers") if k in ref]
    for k in keys:
        assert tm.tree_structure(got[k]) == tm.tree_structure(ref[k])
        if exact:
            assert all(torch.equal(x, y) for x, y in
                       zip(tm.tree_leaves(got[k]), tm.tree_leaves(ref[k]))), k
        else:
            assert _max_diff(got[k], ref[k]) <= atol, k
    if exact:
        assert got["losses"] == ref["losses"]
    else:
        for g, r in zip(got["losses"], ref["losses"]):
            assert abs(g - r) <= rtol * abs(r)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(W.MLP_CASES))
def test_sharded_mlp_equals_one_process(worlds, one_process, world, case):
    """All four modes at data = 2 and 4 (P = 4; the 3-worker case
    replicates the worker axis, which neither extent divides). Every rank
    ends with the same params, and simulate's gathered caches equal every
    worker's cache of the one-process run."""
    exact = W.MLP_CASES[case][2]
    for rank_out in worlds[world]:
        _same(rank_out[case], one_process[case], exact)


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_2x2_lm_equals_one_process(worlds, case):
    """Reduced deepseek-7b and qwen2-moe-a2.7b on a 2x2 mesh: params on the
    model axis by the rules, the worker axis over data, against one process
    under ``use_mesh`` of the same shape (so the MoE groups its tokens the
    same way). Kernels are ``auto``, which the model axis vetoes. Every
    model dim of both divides by 2, so they compute tensor-parallel, and
    the row-parallel sums add in another order than one process's einsums:
    params within Adam's roundoff limits leaf by leaf
    (``_mesh_workers.adam_close``: in each leaf a few elements whose
    gradient sign roundoff decides part by up to two Adam steps a step),
    the first loss within 1e-6 relative and the later ones,
    which read those params, within 1e-4 (1.6e-5 measured)."""
    ref = W.lm_case(case)
    sync = "sync" in case
    for rank_out in worlds[4]:
        got = rank_out[case]
        assert got["kernels"]["delivery"] == ("none" if sync else "tree")
        assert got["model_compute"] == "tensor-parallel"
        # Step 1 reads the same params; later steps read params that
        # Adam's flipped elements moved.
        assert abs(got["losses"][0] - ref["losses"][0]) <= 1e-6 * abs(
            ref["losses"][0])
        for g, r in zip(got["losses"][1:], ref["losses"][1:]):
            assert abs(g - r) <= 1e-4 * abs(r)
        gaps = W.leaf_gaps(got["params"], ref["params"], ref["init"],
                           far=1e-4)
        assert W.adam_close(gaps), gaps


def test_restore_places_each_leaf(worlds):
    """``restore(shardings=)`` gives each rank its worker rows of a
    ``("data", None)`` leaf and the replicated leaves whole, bit for bit;
    on a 2x2 mesh a ``("model",)`` leaf comes back as a DTensor holding
    this rank's model shard (rank r sits at data r // 2, model r % 2)."""
    for rank, out in enumerate(worlds[2]):
        got, whole, step = out["restore"]
        assert step == 3
        assert torch.equal(got["caches"], whole["caches"][2 * rank:2 * rank + 2])
        assert torch.equal(got["params"], whole["params"])
        assert torch.equal(got["step"], whole["step"])
    for rank, out in enumerate(worlds[4]):
        got, whole, _ = out["restore"]
        d, m = divmod(rank, 2)
        assert torch.equal(got["caches"], whole["caches"][2 * d:2 * d + 2])
        local, kind = got["params"]
        assert kind == "DTensor"
        assert torch.equal(local, whole["params"][5 * m:5 * m + 5])


def test_constraints_redistribute_dtensors(worlds):
    """On a 2x2 mesh, ``constraint`` and ``ambient_constraint`` move a
    DTensor to its spec's placements (``"UNC"`` keeps a dim's sharding, an
    axis the mesh lacks is dropped) and keep its whole tensor."""
    for out in worlds[4]:
        assert out["constraint"] == {
            "batch-mlp": (["S(0)", "S(1)"], True),
            "data-unc": (["S(0)", "S(1)"], True),
            "data-none": (["S(0)", "R"], True),
            "pod-only": (["R", "S(1)"], True)}


def test_plan_on_a_device_mesh(worlds):
    """A real 2x1 mesh plans as JAX does: the per-worker ring's worker dim
    on 'data', its param dims on 'model'."""
    gbuf = worlds[2][0]["plan_in_shardings"]
    assert gbuf["embed"] == (None, "data", "model", None)
    assert gbuf["layers"]["attn"]["wo"][:2] == (None, "data")


def test_what_a_mesh_does_not_run_names_its_item(worlds):
    """Only compression over an FSDP arch's data shards raises (A.20);
    compression and the packed kernels over a model axis build and run."""
    for out in worlds[2] + worlds[4]:
        assert "ROADMAP A.20" in out["raises"]["fsdp-compress"]
    assert set(worlds[2][0]["raises"]) == {"fsdp-compress"}
    assert set(worlds[4][0]["raises"]) == {"fsdp-compress", "model-compress",
                                           "model-kernels"}
    for out in worlds[4]:
        for what in ("model-compress", "model-kernels"):
            assert out["raises"][what] == "did not raise", what
        assert out["model-runs"]["model-compress"]["sparsity"] > 0.5
        assert out["model-runs"]["model-kernels"]["delivery"] == "packed"


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_gather_pieces_and_exchange(worlds, world):
    """A gather issued in many flat pieces gives every rank the whole
    tensor (uneven ``torch.chunk`` parts, any dim); the reduce-scatter's
    exchange gives each rank its chunk of the ranks' sum in rank order,
    bit for bit."""
    for out in worlds[world]:
        assert all(out["collectives"]["gathers"])
        assert out["collectives"]["reduce_scatter"]


def _cli_rows_under_torchrun(arch: str) -> None:
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 2x1
    --cpu --arch ARCH``: rank 0 prints the in-process run's rows."""
    import json
    from repro_torch.launch import train
    args = ["--arch", arch, "--reduced", "--cpu", "--steps", "4",
            "--stale", "2", "--batch", "8", "--seq", "16", "--workers", "2",
            "--log-every", "2"]
    env = _env()
    env.pop("PYTHONPATH")
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--mesh", "2x1"] + args,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    ref = train.main(args)["result"].history
    assert len(rows) == len(ref) == 2
    for got, want in zip(rows, ref):
        got.pop("wall_s"), want.pop("wall_s")
        assert got == want
    assert out.stdout.count("done:") == 1          # rank 0 alone prints


def test_train_cli_under_torchrun_prints_the_one_process_rows():
    """Reduced deepseek-7b: the per-worker ring gathers in the one-process
    order, so the rows are equal."""
    _cli_rows_under_torchrun("deepseek-7b")


def test_fsdp_train_cli_under_torchrun_prints_the_one_process_rows():
    """Reduced deepseek-67b (FSDP: params, momentum and the ring's data
    dims sharded over the two ranks): the per-worker ring gathers the
    params whole once a step and delivers in the one-process order, so the
    rows (loss, grad_norm, staleness) are equal."""
    _cli_rows_under_torchrun("deepseek-67b")


# -- the FSDP archs on a mesh ------------------------------------------------------

FSDP_GRID = [(label, name) for label in W.FSDP_MESHES
             for name in W.fsdp_cases(label)]


@pytest.fixture(scope="module")
def fsdp_one_process():
    return {(label, name): W.fsdp_case(name, None, label)
            for label, name in FSDP_GRID}


def _fsdp_ranks(worlds, label):
    data, model = W.FSDP_MESHES[label]
    return [out["fsdp"][label] for out in worlds[data * model]]


@pytest.mark.parametrize("label,case", FSDP_GRID)
def test_fsdp_mesh_equals_one_process(worlds, fsdp_one_process, label, case):
    """Reduced deepseek-67b and kimi-k2 (momentum, P = 4) in the four modes
    on 2x1, 4x1 and (deepseek-67b) 2x2 meshes, against one process under
    ``use_mesh`` of the same shape. Bitwise in simulate (no FSDP shards)
    and the per-worker rings (params gathered whole, the aggregate summed
    in the one-process order, each rank applying its block of it); sync
    and the aggregate ring reduce-scatter the gradients of two or four
    batch shards, so they are held to the MLP sync cases' fp32 limits.
    The per-worker grad_norm is bitwise where no model axis sums its
    squares in pieces."""
    ref = fsdp_one_process[label, case]
    exact = not W.fsdp_split(case)
    model = W.FSDP_MESHES[label][1]
    for got in _fsdp_ranks(worlds, label):
        got = got[case]
        assert got["kernels"]["delivery"] == (
            "none" if "sync" in case else "tree")
        assert got.get("fsdp") == (not case.endswith("simulate"))
        _same(got, ref, exact)
        assert len(got["grad_norms"]) == len(ref["grad_norms"])
        for g, r in zip(got["grad_norms"], ref["grad_norms"]):
            if exact and model == 1:
                assert g == r
            else:
                assert abs(g - r) <= 1e-6 * abs(r)


@pytest.mark.parametrize("label", list(W.FSDP_MESHES))
def test_fsdp_sync_gathers_one_layer_at_a_time(worlds, label):
    """A sync step's data-axis gathers: one layer's slice of each stacked
    leaf (twice under remat: the backward pass gathers the layer again),
    plus ``embed``, ``head`` and ``final_ln``; never a stacked ``[L, ...]``
    leaf whole. Each gather's backward reduce-scatters once."""
    from repro_torch import configs as cfglib
    for case in W.fsdp_cases(label):
        if not case.endswith("-sync"):
            continue
        arch, kw = W.FSDP_CASES[case]
        api = cfglib.get(arch).api(reduced=True)
        params, _ = api.init(0, device="meta")
        stacked = {tuple(x.shape) for x in tm.tree_leaves(params["layers"])}
        n_layers, n_leaves = api.cfg.num_layers, len(
            tm.tree_leaves(params["layers"]))
        per_gather = 2 if kw.get("remat_override") else 1
        for got in _fsdp_ranks(worlds, label):
            traffic = got[case]["traffic"]
            gathers = [(name, shape) for kind, name, shape, _ in traffic
                       if kind == "data.gather"]
            scatters = [name for kind, name, _, _ in traffic
                        if kind == "data.reduce_scatter"]
            assert {name for name, _ in gathers} == {
                "layers", "embed", "head", "final_ln"}
            layer_shapes = [shape for name, shape in gathers
                            if name == "layers"]
            assert all(shape not in stacked for shape in layer_shapes)
            assert {shape for shape in layer_shapes} <= {
                s[1:] for s in stacked}
            assert len(layer_shapes) == per_gather * n_layers * n_leaves
            assert len(gathers) == len(layer_shapes) + 3
            assert len(scatters) == n_layers * n_leaves + 3


@pytest.mark.parametrize("label", list(W.FSDP_MESHES))
def test_fsdp_init_keeps_blocks_as_drawn(worlds, label):
    """``Engine.init`` on an FSDP rank hands the placement each value as
    the initialiser draws it: one layer's slice of a stacked leaf at a
    time, never a stacked ``[L, ...]`` leaf whole (the rank keeps its
    blocks; the trajectories above show they are the one-process init's
    blocks)."""
    from repro_torch import configs as cfglib
    for case in W.fsdp_cases(label):
        if case.endswith("simulate"):
            continue
        api = cfglib.get(W.FSDP_CASES[case][0]).api(reduced=True)
        params, _ = api.init(0, device="meta")
        stacked = {tuple(x.shape) for x in tm.tree_leaves(params["layers"])}
        for got in _fsdp_ranks(worlds, label):
            drawn = got[case]["drawn"]
            assert drawn, case
            assert not set(drawn) & stacked, case


def test_fsdp_per_worker_reduce_scatter_is_planted_fault(worlds,
                                                         fsdp_one_process):
    """The per-worker modes gather params whole outside autograd: a
    reduce-scatter backward there (the batch-split read, planted) would sum
    each rank's workers' gradients into the other rank's workers' rows,
    and the run parts from the one-process run."""
    ref = fsdp_one_process["2x1", "deepseek-67b-ssp"]
    for out in _fsdp_ranks(worlds, "2x1"):
        got = out["planted"]
        assert any(kind == "data.reduce_scatter"
                   for kind, *_ in got["traffic"])
        assert _max_diff(got["params"], ref["params"]) > 1e-3
        assert got["losses"] != ref["losses"]


# -- serving on a mesh -----------------------------------------------------------

SERVE_MESHES = {"2x1": 2, "1x2": 2, "2x2": 4}


@pytest.fixture(scope="module")
def serve_one_process(tmp_path_factory):
    out = {name: W.serve_case(name) for name in W.SERVE_CASES}
    out["kimi-k2-1t-a32b-auto"] = W.serve_case("kimi-k2-1t-a32b-auto")
    out["refresh"] = W.refresh_case(str(tmp_path_factory.mktemp("refresh")))
    out["refresh-67b"] = W.refresh_case(
        str(tmp_path_factory.mktemp("refresh-67b")), None, "deepseek-67b",
        "auto")
    return out


def _serve_ranks(worlds, label):
    return [out["serve"][label] for out in worlds[SERVE_MESHES[label]]]


# The tensor-parallel serve's limits (``test_torch_tp.py`` holds it, teacher-
# forced, against one process and JAX): logits within SERVE_RTOL of the
# largest |logit|, tokens equal up to a near-tie (a one-process top-2
# margin below NEAR_TIE).
SERVE_RTOL, NEAR_TIE = 1e-5, 1e-4


def _held_tensor_parallel(got: dict, ref: dict) -> None:
    """A free-running tensor-parallel serve against one process: each
    request's tokens equal up to its first near-tie, and the logits of
    every token whose inputs were still the one process's (up to and
    including the first that differs) within SERVE_RTOL."""
    from chip_smoke import logit_gap, parting
    assert not parting(got["tokens"], ref["record"], NEAR_TIE)["parted"]
    upto = {rid: next((j + 1 for j, (a, b) in enumerate(
        zip(toks, ref["tokens"][rid])) if a != b), len(toks))
        for rid, toks in got["tokens"].items()}
    cut = {"logits": {rid: x[:upto[rid]]
                      for rid, x in got["record"]["logits"].items()}}
    assert logit_gap(cut, ref["record"])["rel"] <= SERVE_RTOL


@pytest.mark.parametrize("label", list(SERVE_MESHES))
@pytest.mark.parametrize("case", list(W.SERVE_CASES) + ["refresh"])
def test_mesh_serve_equals_one_process(worlds, serve_one_process, label,
                                       case):
    """Reduced deepseek-7b on the paged and gather routes, greedy and at
    temperature 0.7, and reduced deepseek-67b (FSDP: ``embed`` on data,
    the gather route), served over a 2x1, 1x2 and 2x2 mesh: each rank's
    tokens and staleness stamps are the one process's, with the same
    counts, and every rank returns the same report (rank 0's decisions,
    its clock and stamps included). Bitwise where the params are whole
    (2x1, and deepseek-67b, whose one kv head the model axis cannot
    split); deepseek-7b at 1x2 and 2x2 serves tensor-parallel on its
    shards, whose logits part at fp32 roundoff: its tokens up to a
    near-tie and its logits within SERVE_RTOL (``_held_tensor_parallel``).
    ``refresh``: a snapshot swapped in at decode step 4 of the served
    stream; the ranks load the step rank 0 polled."""
    ref = serve_one_process[case]
    ranks = _serve_ranks(worlds, label)
    tensor_parallel = label != "2x1" and "67b" not in case
    for got in ranks:
        assert got[case]["route"] == ref["route"]
        assert got[case]["model_compute"][0] == (
            None if label == "2x1" else
            "tensor-parallel" if tensor_parallel else "gathered")
        if tensor_parallel:
            _held_tensor_parallel(got[case], ref)
        else:
            assert got[case]["tokens"] == ref["tokens"]
        assert got[case]["counts"] == ref["counts"]
        steps = {rid: [b for b, _ in st] for rid, st in
                 got[case]["stamps"].items()}
        assert steps == {rid: [b for b, _ in st] for rid, st in
                         ref["stamps"].items()}
        assert {rid: [a is None for _, a in st] for rid, st in
                got[case]["stamps"].items()} == \
            {rid: [a is None for _, a in st] for rid, st in
             ref["stamps"].items()}
        assert got[case]["report"] == ranks[0][case]["report"]
    if case == "refresh":
        assert ref["boot"] == 1 and ref["step"] == 2
        assert ref["counts"][3] == 1                 # one swap
        assert all(got[case]["step"] == 2 for got in ranks)
        # Stamps run 1 step behind until the swap, then 0.
        stamps = [b for st in ref["stamps"].values() for b, _ in st]
        assert 0 in stamps and 1 in stamps


def _data_sharded(arch: str, n: int) -> dict:
    """{top-level key: leaves whose ``embed`` dim (the FSDP rule's data
    axis) ``n`` divides} of the reduced ``arch``."""
    from repro_torch import configs as cfglib
    from repro_torch.sharding.rules import axes_leaves
    params, axes = cfglib.get(arch).api(reduced=True).init(0, device="meta")
    return {key: sum(1 for x, ax in zip(tm.tree_leaves(params[key]),
                                        axes_leaves(axes[key]))
                     if "embed" in ax and x.shape[ax.index("embed")] % n == 0)
            for key in params}


@pytest.mark.parametrize("label", ["2x1", "2x2"])
def test_fsdp_serve_reads_one_layer_at_a_time(worlds, label):
    """Reduced deepseek-67b (``embed`` on data) served on its data blocks:
    a rank's served params are its blocks (half of every ``embed`` dim, the
    model dims whole on 2x2's gathered route, whose one kv head the model
    axis cannot split); each decode step gathers every data-sharded leaf
    once, in the order the model reads them (``embed``, one layer's slice
    at a time, ``final_ln``, ``head``), and never a stacked ``[L, ...]``
    leaf whole; no model-axis gather runs during the serve."""
    from collections import Counter
    from repro_torch import configs as cfglib
    api = cfglib.get("deepseek-67b").api(reduced=True)
    params, _ = api.init(0, device="meta")
    stacked = {tuple(x.shape) for x in tm.tree_leaves(params["layers"])}
    k = _data_sharded("deepseek-67b", W.FSDP_MESHES[label][0])
    layers = api.cfg.num_layers
    want = ["embed"] + ["layers"] * (layers * k["layers"]) + [
        "final_ln", "head"]
    for got in _serve_ranks(worlds, label):
        got = got["deepseek-67b-auto"]
        have, served, shapes_ok = got["bytes"]
        assert shapes_ok and have == served
        assert got["whole_gathers"] == 0
        assert len(got["reads"]) == got["counts"][0]
        for step in got["reads"]:
            names = [name for name, _ in step]
            assert Counter(names) == Counter(want)
            assert names[0] == "embed" and names[-2:] == ["final_ln", "head"]
            assert not {shape for name, shape in step
                        if name == "layers"} & stacked


@pytest.mark.parametrize("case", ["kimi-k2-1t-a32b-auto", "refresh-67b"])
def test_fsdp_serve_2x1_equals_one_process(worlds, serve_one_process, case):
    """Reduced kimi-k2 (MoE) and deepseek-67b (booted from snapshot 1,
    snapshot 2 swapped in mid-serve) on their data blocks at 2x1: tokens,
    staleness steps and counts bit for bit the one process's, the swap on
    its decode step, the params after it bitwise this rank's blocks of
    snapshot 2, and no whole gather."""
    ref = serve_one_process[case]
    for got in _serve_ranks(worlds, "2x1"):
        got = got[case]
        assert got["route"] == ref["route"] == ("gather", "FSDP placement")
        assert got["tokens"] == ref["tokens"]
        assert got["counts"] == ref["counts"]
        assert {rid: [b for b, _ in st] for rid, st in got["stamps"].items()} \
            == {rid: [b for b, _ in st] for rid, st in ref["stamps"].items()}
        if case == "refresh-67b":
            assert got["swaps"] == ref["swaps"] and len(got["swaps"]) == 1
            assert (got["boot"], got["step"]) == (1, 2)
            assert got["served_2"] and got["whole_gathers"] == 0


def test_fsdp_serve_init_holds_only_blocks(worlds):
    """A rank that inits its own deepseek-67b params at 2x1 (no params
    handed to the server) cuts each value to its data block as it is
    drawn: its params are bitwise its blocks of the one-process init, every
    value went through the placement's ``keep`` one layer's slice at a
    time (never a stacked ``[L, ...]`` leaf whole), and the init's live
    param bytes stay below the whole params'."""
    from repro_torch import configs as cfglib
    params, _ = cfglib.get("deepseek-67b").api(reduced=True).init(
        0, device="meta")
    stacked = {tuple(x.shape) for x in tm.tree_leaves(params["layers"])}
    for out in _serve_ranks(worlds, "2x1"):
        got = out["fsdp-init"]
        have, served, shapes_ok = got["bytes"]
        assert got["blocks"] and shapes_ok and have == served
        assert not set(got["drawn"]) & stacked
        assert got["kept"] <= have < got["whole"]
        assert got["peak"] < got["whole"], got


def test_fsdp_serve_dropped_gather_is_a_planted_fault(worlds,
                                                      serve_one_process):
    """With the data fetch's gather delivering nothing (every other rank's
    block zeros, ``chip_smoke.NoGather``) the 2x1 deepseek-67b tokens part
    from the one process's."""
    ref = serve_one_process["deepseek-67b-auto"]["tokens"]
    for out in _serve_ranks(worlds, "2x1"):
        got = out["deepseek-67b-planted"]["tokens"]
        assert got.keys() == ref.keys() and got != ref


def test_mesh_serve_routes_follow_the_veto(worlds):
    """Under "auto" a model axis > 1 takes the gather route, as JAX does;
    "on" overrides it (the cases above run the kernel's route)."""
    for label in ("1x2", "2x2"):
        for got in _serve_ranks(worlds, label):
            assert got["deepseek-7b-paged-greedy"]["route"] == ("paged", "")
            assert got["deepseek-67b-auto"]["route"] == ("gather",
                                                         "FSDP placement")


@pytest.mark.parametrize("label", ["1x2", "2x2"])
def test_serve_restore_gives_model_shards(worlds, label):
    """``restore(shardings=)`` with the serve plan's placement returns a
    DTensor for every leaf with a ``"model"`` part (this rank's shard) and
    a plain tensor for every other; the placement's ``whole`` gives the
    saved params back bit for bit, and leaves the model extent does not
    divide too."""
    for got in _serve_ranks(worlds, label):
        kinds = got["restore"]["kinds"]
        assert any(sharded for _, sharded in kinds)
        assert all((kind == "DTensor") == sharded for kind, sharded in kinds)
        assert got["restore"]["whole"] and got["restore"]["uneven"]


def test_serve_cli_under_torchrun_prints_the_one_process_rows():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1x2
    --cpu``: "auto" resolves to the gather route (model axis extent 2) and
    the ranks serve reduced deepseek-7b tensor-parallel on their shards;
    rank 0 alone prints the route, the report of the in-process CLI on the
    gather route and its sample row (up to a near-tie of that run's, as
    ``_held_tensor_parallel`` holds the tokens)."""
    import json
    from repro_torch.launch import serve
    from repro_torch.serving import Server
    from chip_smoke import Forcing, parting
    args = ["--arch", "deepseek-7b", "--reduced", "--cpu", "--greedy",
            "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    env = _env()
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.serve", "--mesh", "1x2"] + args,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    records, run = [], Server.run

    def recorded(self, reqs, **kw):
        with Forcing(self) as rec:
            report = run(self, reqs, **kw)
        records.append(rec.record())
        return report
    Server.run = recorded
    try:
        ref = serve.main(args + ["--paged", "off"])["report"]
    finally:
        Server.run = run
    assert out.stdout.count("serve dispatch:") == 1   # rank 0 alone prints
    assert "paged=gather (model axis extent 2)" in out.stdout
    assert out.stdout.count("model axis: tensor-parallel") == 1
    start = out.stdout.index("{")
    summary = json.loads(out.stdout[start:out.stdout.index("\n}", start) + 2])
    want = ref.summary()
    for key in ("requests_completed", "tokens_total", "decode_steps", "joins",
                "evicts", "refreshes", "prefill_calls", "staleness"):
        assert summary[key] == want[key], key
    first = min(ref.completed, key=lambda r: r.rid)
    row = out.stdout.split("sample row 0: ")[1].splitlines()[0]
    got = json.loads(row)
    assert len(got) == len(first.tokens[:24])
    only = {k: {first.rid: v[first.rid]} for k, v in records[0].items()}
    assert not parting({first.rid: got}, only, NEAR_TIE)["parted"]
