"""repro_torch.figures against the JAX package's figure scripts
(``benchmarks/fig1_depth_staleness.py``, ``fig2_algorithms.py``,
``fig3_mf_lda_vae.py``).

No training: the experiment functions of ``benchmarks.common`` and of
``repro_torch.experiments`` are replaced by one fake that returns a fixed
result for each set of arguments (some of them unconverged, so the -1 and
NaN branches run). Each twin must then call the experiments with the same
arguments, in the same order, and emit the reference's rows and CSV text.
"""
import json
import sys
import types
import zlib
from pathlib import Path

import pytest
import torch

from repro_torch import experiments, figures
from repro_torch.models import mf, resnet, vae

# One intra-op thread: the suite's workers share the cores, and at these
# sizes a thread pool a worker only makes them wait on each other.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import common  # noqa: E402
from benchmarks import fig1_depth_staleness as fig1  # noqa: E402
from benchmarks import fig2_algorithms as fig2  # noqa: E402
from benchmarks import fig3_mf_lda_vae as fig3  # noqa: E402

NAMES = ("dnn_experiment", "cnn_experiment", "mf_experiment",
         "vae_experiment", "lda_experiment")


def _fake(name, calls):
    def run(**kw):
        kw.pop("device", None)
        calls.append((name, kw))
        h = zlib.crc32(repr((name, sorted(kw.items()))).encode())
        if name == "lda_experiment":
            return [(5, -2000.0), (10, -1000.0 - h % 997)] if h % 7 else []
        converged = h % 5 != 0
        return types.SimpleNamespace(
            batches_to_target=8 * (1 + h % 97) if converged else None,
            converged=converged, curve=[], wall_s=0.0)
    return run


@pytest.fixture
def faked(monkeypatch):
    """Both packages' experiments replaced; returns the two call logs."""
    logs = {"jax": [], "torch": []}
    for name in NAMES:
        monkeypatch.setattr(common, name, _fake(name, logs["jax"]))
        monkeypatch.setattr(experiments, name, _fake(name, logs["torch"]))
    return logs


TWINS = [
    (figures.fig1_run, fig1.run),
    (figures.fig1_run_cnn, fig1.run_cnn),
    (figures.fig2_run, fig2.run),
    (figures.fig2_run_dnn_algos, fig2.run_dnn_algos),
    (figures.fig3_run_mf, fig3.run_mf),
    (figures.fig3_run_lda, fig3.run_lda),
    (figures.fig3_run_vae, fig3.run_vae),
]


def _same(a, b):
    """Rows equal, NaN equal to NaN."""
    return json.dumps(a) == json.dumps(b)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("twin,ref", TWINS,
                         ids=[t.__name__ for t, _ in TWINS])
def test_twin_emits_the_reference_rows_and_csv(faked, capsys, twin, ref,
                                               quick):
    want = ref(quick=quick)
    want_out = capsys.readouterr().out
    got = twin(quick=quick, device="cpu")
    got_out = capsys.readouterr().out
    assert faked["torch"] == faked["jax"] and faked["jax"]
    assert _same(got, want)
    assert got_out == want_out
    assert want_out.startswith("# ")


@pytest.mark.parametrize("only,ref", [("fig1", fig1.main),
                                      ("fig2", fig2.main),
                                      ("fig3", fig3.main)])
@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_main_collects_each_figure_as_the_reference(faked, capsys, tmp_path,
                                                    only, ref, quick):
    want = ref(quick=quick)
    out = tmp_path / "rows.json"
    got = figures.main(only=only, quick=quick, out=str(out), device="cpu")
    assert list(got) == [only] and _same(got[only], want)
    assert json.loads(out.read_text()).keys() == {only}
    with pytest.raises(ValueError, match="unknown figure"):
        figures.main(only="fig9", device="cpu")


@pytest.mark.parametrize("call", [
    lambda: figures.fig1_run_cnn(quick=True),
    lambda: figures.fig3_run_mf(quick=True),
    lambda: figures.fig3_run_lda(quick=True),
    lambda: figures.fig3_run_vae(quick=True),
    lambda: experiments.cnn_experiment(n_blocks=1, algo="sgd", s=0,
                                       workers=1),
    lambda: experiments.lda_experiment(s=0, workers=1),
    lambda: resnet.init(0, resnet.ResNetConfig()),
    lambda: mf.init(0, mf.MFConfig(num_users=3, num_items=2)),
    lambda: vae.init(0, vae.VAEConfig()),
], ids=["fig1_cnn", "fig3_mf", "fig3_lda", "fig3_vae", "cnn_experiment",
        "lda_experiment", "resnet", "mf", "vae"])
def test_paper_entry_points_default_to_cuda(monkeypatch, call):
    """Without a device argument every new entry point asks for CUDA and
    raises where there is none; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
