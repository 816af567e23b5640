"""chip_smoke.py's shared-state check of the paper legs, on the CPU.

At each step of a kernels-off run the kernels-on engine is handed the off
state and both step once (``chip_smoke.shared_state_check``). On the CPU the
plain versions stand in for the kernels (CPU tensors), so the check must
pass; with a planted fault in the packed route's delivery or fused Adam it
must fail: the tolerances sit between the two. Tiny widths, 6 steps.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import staleness  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

TINY = dict(resnet_n=1, resnet_widths=(4, 8, 8), image_hw=8, mf_users=300,
            mf_items=200, mf_density=0.1, vae_dim=24, vae_depth=1,
            vae_latent=4)
STEPS = 6
ADAM, ACCUM = dispatch.fused_adam, dispatch.stale_accum
FAULTS = {
    "adam_lr": ("fused_adam", lambda p, m, v, g, lr, *a:
                ADAM(p, m, v, g, lr * 1.001, *a)),
    "adam_step": ("fused_adam", lambda p, m, v, g, lr, b1, b2, eps, step:
                  ADAM(p, m, v, g, lr, b1, b2, eps, max(step - 1, 1))),
    "accum_weight": ("stale_accum", lambda p, buf, w:
                     ACCUM(p, buf, w * 0.9999)),
}


@pytest.fixture
def table(monkeypatch):
    for key, value in TINY.items():
        monkeypatch.setitem(cs.PAPER, key, value)
    t = np.random.default_rng(0).integers(0, cs.STALENESS,
                                          (cs.STEPS, cs.WORKERS))
    t[0, 0] = cs.STALENESS - 1
    return t


def _over(model, algo, table):
    m = cs.paper_model(torch.device("cpu"), model)
    got = cs.shared_state_check(torch.device("cpu"), m, algo, table,
                                steps=STEPS)
    return [k for k in got if got[k] > cs.TOL_SHARED[k]]


@pytest.mark.parametrize("model,algo", [("resnet", "adam"), ("mf", "sgd"),
                                        ("vae", "adam")])
def test_sound_routes_pass_from_shared_states(table, model, algo):
    assert _over(model, algo, table) == []


@pytest.mark.parametrize("model,algo,fault", [
    ("vae", "adam", "adam_lr"), ("vae", "adam", "adam_step"),
    ("vae", "adam", "accum_weight"), ("mf", "sgd", "accum_weight")])
def test_planted_faults_fail_from_shared_states(table, monkeypatch, model,
                                                algo, fault):
    name, fn = FAULTS[fault]
    monkeypatch.setattr(staleness.dispatch, name, fn)
    assert _over(model, algo, table) != []
