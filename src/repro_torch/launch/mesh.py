"""Host mesh spec (twin of ``repro/launch/mesh.py::parse_host_mesh``).

The port runs on one GPU: only the ``"1x1"`` mesh is accepted until
multi-GPU placement is ported (ROADMAP A.12).
"""
from __future__ import annotations


def parse_host_mesh(spec: str) -> tuple:
    """'DATAxMODEL' CLI spec -> (data, model) extents; only '1x1' runs."""
    try:
        data, model = (int(x) for x in spec.split("x"))
    except ValueError:
        raise SystemExit(
            f"--mesh expects 'DATAxMODEL' (e.g. 1x1), got {spec!r}") from None
    if (data, model) != (1, 1):
        raise NotImplementedError(
            f"mesh {spec!r}: only '1x1' runs until multi-GPU placement is "
            "ported (ROADMAP A.12)")
    return data, model
