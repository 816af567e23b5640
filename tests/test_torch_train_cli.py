"""The port's train CLI (``python -m repro_torch.launch.train``) against the
JAX package's (``python -m repro.launch.train``).

Both drivers run in this process on the same arguments (reduced
``deepseek-7b``, a few steps). Their numbers differ (each package draws its
own init and delays), so what is compared is what the text and files say
about the run: every flag with its default, choices and type; the same
``SystemExit`` checks with the same messages; the header and ``params:``
lines, the columns of every JSON row, the ``delay:``, ``compensate:``,
``kernel dispatch:`` and ``done:`` lines; and the files that ``--ckpt-dir``,
``--trace-out`` and ``--out`` leave. A checkpoint the port's CLI writes
restores into the JAX package's tree, and its recorded trace replays
through ``--trace``.
"""
import ast
import json
import os
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint import checkpoint as jckpt
from repro.kernels import dispatch as jdispatch
from repro.launch import train as jtrain
from repro_torch import configs as tcfg
from repro_torch import treemath as tm
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import train as ttrain

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
BASE = ["--arch", "deepseek-7b", "--reduced", "--batch", "8", "--seq", "16",
        "--workers", "4", "--log-every", "2"]


def _flags(path: Path) -> dict:
    """--flag -> its add_argument keywords (as source text), read from the
    driver's source."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg in ("default", "choices", "type", "action")}
            out[node.args[0].value] = kw
    return out


def test_every_flag_of_the_jax_driver_with_its_defaults():
    jflags = _flags(SRC / "repro" / "launch" / "train.py")
    tflags = _flags(SRC / "repro_torch" / "launch" / "train.py")
    assert set(tflags) == set(jflags) | {"--cpu"}
    for flag, kw in jflags.items():
        assert tflags[flag] == kw, flag
    assert tflags["--cpu"] == {"action": "'store_true'"}


def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    jtrain.main()


@pytest.mark.parametrize("argv,msg", [
    (["--delay", "uniform", "--trace", "t.jsonl"], "mutually exclusive"),
    (["--delay", "uniform"], "need a non-sync mode"),
    (["--stale", "2", "--batch", "6"], "divisible by --workers"),
    (["--stale", "2", "--lr-scale", "theorem1"], "pass --coherence"),
])
def test_system_exits_match_the_jax_driver(argv, msg, monkeypatch):
    with pytest.raises(SystemExit) as jerr:
        _jax_main(BASE + argv, monkeypatch)
    with pytest.raises(SystemExit) as terr:
        ttrain.main(BASE + argv + ["--cpu"])
    assert msg in str(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_mesh_specs():
    with pytest.raises(SystemExit, match="--mesh expects 'DATAxMODEL'"):
        ttrain.main(BASE + ["--mesh", "four", "--cpu"])
    # A mesh other than 1x1 runs under torchrun (A.12; the two-rank run is
    # in test_torch_mesh_engine.py); without its process group it says so.
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.main(BASE + ["--mesh", "2x1", "--cpu"])


def _lines(text):
    rows = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    other = [x for x in text.splitlines() if not x.startswith("{")]
    return rows, other


def _run_both(argv, tmp_path, monkeypatch, capsys):
    """Run both drivers with ``argv``; paths under ``{d}`` go to a
    per-driver directory. Returns (jax (rows, lines, dir), port (...),
    the port driver's return value). Each package's dispatch report is
    process-wide, so both are cleared first: the drivers then report this
    run's decisions only."""
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        args = [a.replace("{d}", str(d)) for a in argv]
        jdispatch.reset_report()
        tdispatch.reset_report()
        capsys.readouterr()
        if name == "jax":
            _jax_main(args, monkeypatch)
            ret = None
        else:
            ret = ttrain.main(args + ["--cpu"])
        rows, lines = _lines(capsys.readouterr().out)
        out[name] = (rows, lines, d)
    return out["jax"], out["port"], ret


def _check_text(j, t, kernel_line):
    (jrows, jlines, _), (trows, tlines, _) = j, t
    assert tlines[0] == jlines[0]                    # arch=... header
    assert tlines[1] == jlines[1]                    # params: N.NM
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    for jr, tr in zip(jrows, trows):
        assert set(tr) == set(jr)
        assert all(np.isfinite(v) for v in tr.values()
                   if isinstance(v, float))
    for prefix in ("delay: ", "compensate: ", "kernel dispatch: ", "done: "):
        jl = [x for x in jlines if x.startswith(prefix)]
        tl = [x for x in tlines if x.startswith(prefix)]
        assert len(tl) == len(jl), prefix
    kd = [x for x in tlines if x.startswith("kernel dispatch: ")]
    assert kd == [kernel_line]
    jops = {x.split("->")[0].strip() for x in jlines if "->" in x}
    tops = {x.split("->")[0].strip() for x in tlines if "->" in x}
    assert tops == jops
    assert all(x.endswith("(cpu tensor)") for x in tlines if "->" in x)
    comp = [x for x in tlines if x.startswith("compensate: ")]
    jcomp = [x for x in jlines if x.startswith("compensate: ")]
    strip = lambda s: re.sub(r"[0-9.]+$", "", re.sub(r"\d\.\d+", "N", s))
    assert [strip(x) for x in comp] == [strip(x) for x in jcomp]
    done = [x for x in tlines if x.startswith("done: ")][0]
    jdone = [x for x in jlines if x.startswith("done: ")][0]
    assert done.split(" in ")[0] == jdone.split(" in ")[0]


def test_ring_run_with_every_hook_matches_the_jax_driver(tmp_path,
                                                         monkeypatch, capsys):
    """stale-psum with a delay spec, compression, the coherence monitor,
    checkpoints, a recorded trace and a history dump: the same text and the
    same files; the port's checkpoint restores into the JAX tree and its
    trace replays."""
    argv = BASE + ["--steps", "4", "--stale", "2", "--delay", "uniform",
                   "--compress", "topk:0.25", "--kernels", "on",
                   "--coherence", "--ckpt-dir", "{d}/ckpt", "--ckpt-every",
                   "2", "--trace-out", "{d}/trace.jsonl", "--out",
                   "{d}/hist.json"]
    j, t, ret = _run_both(argv, tmp_path, monkeypatch, capsys)
    _check_text(j, t, "kernel dispatch: config=on delivery=packed")
    assert {"mu", "grad_norm"} <= set(t[0][-1])
    jdir, tdir = j[2], t[2]
    assert sorted(os.listdir(tdir / "ckpt")) == sorted(os.listdir(
        jdir / "ckpt"))
    assert tckpt.steps_in(str(tdir / "ckpt")) == [2, 4]
    # The port's last snapshot restores into the JAX package's tree and
    # equals the port's final params.
    like = jax.eval_shape(
        lambda: jcfg.get("deepseek-7b").api(reduced=True).init(
            jax.random.PRNGKey(0))[0])
    restored = jckpt.restore(jckpt.step_path(str(tdir / "ckpt"), 4), like)[0]
    final = ret["engine"].params(ret["result"].state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), tm.tree_leaves(final)):
        assert np.array_equal(np.asarray(a), b.numpy())
    jhist = json.loads((jdir / "hist.json").read_text())
    thist = json.loads((tdir / "hist.json").read_text())
    assert set(thist) == set(jhist)
    assert set(thist["args"]) == set(jhist["args"]) | {"cpu"}
    assert thist["params_m"] == jhist["params_m"]
    jtrace = [json.loads(x) for x in (jdir / "trace.jsonl").read_text()
              .splitlines()]
    ttrace = [json.loads(x) for x in (tdir / "trace.jsonl").read_text()
              .splitlines()]
    assert len(ttrace) == len(jtrace)
    assert [set(x) for x in ttrace] == [set(x) for x in jtrace]
    # The recorded trace replays: a second port run through --trace.
    capsys.readouterr()
    ttrain.main(BASE + ["--steps", "3", "--stale", "2", "--trace",
                        str(tdir / "trace.jsonl"), "--cpu"])
    rows, lines = _lines(capsys.readouterr().out)
    assert [r["step"] for r in rows] == [2]
    assert any(x.startswith("delay: realized mean total delay") for x in lines)


def test_sync_run_with_fused_adam_matches_the_jax_driver(tmp_path,
                                                         monkeypatch, capsys):
    argv = BASE + ["--steps", "2", "--stale", "0", "--kernels", "on"]
    j, t, ret = _run_both(argv, tmp_path, monkeypatch, capsys)
    _check_text(j, t, "kernel dispatch: config=on delivery=none")
    assert ret["engine"].meta["kernels"]["megakernel"] == "fused"
    assert any("fused_adam" in x for x in t[1])


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-7b", dict(stale_s=2, num_workers=2, kernels="on")),
    ("deepseek-7b", dict(stale_s=0, kernels="on")),
    ("deepseek-67b", dict(mode="stale-psum", num_workers=2, kernels="auto")),
    ("qwen2-moe-a2.7b", dict(mode="ssp", stale_s=3, num_workers=2)),
])
def test_make_train_engine_matches_the_jax_planner(arch, kw):
    """The same mode, bound, worker count, per-worker-delay form, buffer
    dtype, routing verdict and fused-Adam opt-in as the JAX package's
    make_train_engine on a one-device mesh. deepseek-67b is an FSDP arch:
    the aggregate ring, and kernels="auto" keeps the tree layout."""
    from repro.engine.plan import make_train_engine as jmake
    from repro.launch.mesh import make_host_mesh
    from repro_torch.configs.base import InputShape
    from repro_torch.engine.plan import make_train_engine as tmake

    shape = InputShape("train_small", 8, 4, "train")
    jshape = jcfg.InputShape("train_small", 8, 4, "train")
    je = jmake(arch, jshape, make_host_mesh(1, 1), reduced=True, **kw)
    te = tmake(arch, shape, reduced=True, device="cpu", **kw)
    for field in ("mode", "s", "num_workers", "per_worker_delays",
                  "kernels"):
        assert getattr(te.cfg, field) == getattr(je.cfg, field), field
    assert str(te.cfg.buffer_dtype) == f"torch.{je.cfg.buffer_dtype.__name__}"
    assert te.meta["kernels"] == je.meta["kernels"]
    assert te.meta["optimizer"] == je.plan().meta["optimizer"]


def test_fsdp_arch_refuses_the_packed_ring_as_the_jax_engine_does():
    from repro.engine.api import kernel_placement_ok as jok
    from repro_torch.engine.api import kernel_placement_ok as tok
    from repro_torch.engine.plan import make_train_engine as tmake
    for kernels in ("off", "auto", "on"):
        for arch in ("deepseek-67b", "kimi-k2-1t-a32b", "deepseek-7b"):
            assert tok(kernels, arch) == jok(kernels, arch), (kernels, arch)
    with pytest.raises(ValueError, match="FSDP"):
        tmake("deepseek-67b", "train_4k", reduced=True, stale_s=2,
              kernels="on", device="cpu")
    # On a mesh (A.12) the FSDP veto holds and the plan puts 'embed' on
    # the data axis; running an FSDP arch over a data axis > 1 is A.17.
    from repro_torch.sharding.rules import AbstractMesh
    planned = tmake("deepseek-67b", "train_4k",
                    mesh=AbstractMesh(("data", "model"), (2, 1)),
                    reduced=True, stale_s=2, kernels="auto")
    assert planned.meta["kernels"]["fallback"] == "FSDP placement"
    assert planned.plan().in_shardings[0].inner.params["embed"] == \
        ("model", "data")


@pytest.mark.parametrize("arch_id", sorted(tcfg.REGISTRY))
def test_fsdp_is_the_arch_field_of_the_jax_sharding_rules(arch_id):
    from repro.sharding.rules import FSDP_ARCHS
    assert tcfg.get(arch_id).fsdp == (arch_id in FSDP_ARCHS)


@pytest.mark.parametrize("mode", ["stale-psum", "ssp", "simulate"])
def test_fsdp_arch_under_auto_runs_no_kernel_and_records_why(mode):
    """On one device an FSDP arch keeps the tree layout under
    kernels="auto": no packed ring, no fused Adam, and the engine's meta
    names the FSDP veto."""
    from repro_torch.configs.base import InputShape
    from repro_torch.engine.plan import make_train_engine as tmake
    shape = InputShape("train_small", 8, 4, "train")
    te = tmake("deepseek-67b", shape, reduced=True, mode=mode, stale_s=2,
               num_workers=2, kernels="auto", device="cpu")
    assert te.meta["kernels"]["delivery"] == "tree"
    assert te.meta["kernels"]["fallback"] == "FSDP placement"
    assert te.meta["kernels"]["megakernel"] == "off"


def test_the_driver_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(BASE + ["--steps", "1"])
