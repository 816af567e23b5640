"""Port parity: the cross-attention families through the engine and the
train CLI, ``repro_torch`` against ``repro``.

* ``build_engine`` in all four modes on reduced ``whisper-base`` with the
  kernels on, through ``test_torch_lm_train.check_run`` (its grid, inputs
  and tolerances; the batches carry ``frames`` beside the tokens and the
  cross gates start at 0.5), as the reference's own matrix runs whisper as
  one of its three families (``tests/test_engine_matrix.py``).
* The train CLI on both arch ids against the JAX CLI on the same
  arguments (``test_torch_train_cli.py``'s check: the text the two print;
  each package draws its own init, so the numbers differ). The CLI draws
  ``frames`` / ``cross_feats`` into every batch.
"""
import numpy as np
import pytest

from repro_torch import configs as tcfg
from repro_torch.launch import train as ttrain

from test_torch_lm_train import MODES, check_run
from test_torch_train_cli import _check_text, _run_both

WHISPER, VISION, SEQ = "whisper-base", "llama-3.2-vision-11b", 8


@pytest.mark.parametrize("mode", MODES)
def test_whisper_engine_matches_jax(mode):
    check_run(WHISPER, mode, "on", seq=SEQ)


@pytest.mark.parametrize("arch,extra,kernel_line", [
    (WHISPER, ["--stale", "2"], "kernel dispatch: config=on delivery=packed"),
    (VISION, ["--stale", "0"], "kernel dispatch: config=on delivery=none"),
])
def test_train_cli_matches_the_jax_cli(arch, extra, kernel_line, tmp_path,
                                       monkeypatch, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "4", "--seq", "16",
            "--workers", "2", "--log-every", "1", "--steps", "3",
            "--kernels", "on"] + extra
    j, t, ret = _run_both(argv, tmp_path, monkeypatch, capsys)
    _check_text(j, t, kernel_line)
    assert all(np.isfinite(r["loss"]) for r in t[0])
    assert t[1][0].startswith(f"arch={arch} ")
    api = tcfg.get(arch).api(reduced=True)
    batch = ttrain.make_batch_fn(api, 4, 16, 0)()
    assert set(batch) == {"tokens", "frames" if arch == WHISPER
                          else "cross_feats"}
