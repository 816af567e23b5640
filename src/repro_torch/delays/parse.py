"""CLI delay-spec grammar (port of ``repro/delays/parse.py``).

    uniform[:S]                     r ~ Categorical(0..S-1)   (default S = s)
    zero                            always 0 (sync limit)
    constant:D                      every delay == D
    geometric[:TRUNC]               Appendix-A.3 straggler mix matched to s
    multipod:PODS[:INTER_S[:INTRA_S]]
                                    hierarchical intra/inter-pod composition
                                    (defaults: inter uniform(s), intra zero)
    trace:PATH[:BOUND]              replay measured wall-times (SSP clocks)

``s = 0`` normalization: every spec whose staleness parameter resolves to 0
parses to :class:`repro_torch.delays.Zero`, the explicit synchronous limit:
``uniform``/``uniform:0`` with ``s = 0``, ``geometric`` with ``s = 0``, and
a ``multipod`` sub-spec with ``INTER_S = 0`` / ``INTRA_S = 0``.
``constant:0`` stays ``Constant(0)``: it names an explicit delay value, not
a staleness bound.

``trace:`` paths may themselves contain colons (drive letters, URLs): only
the *last* ``:``-segment is the bound, and only when it is an unsigned
integer. ``trace:C:\\runs\\t.jsonl:8`` replays ``C:\\runs\\t.jsonl`` with
bound 8; ``trace:http://host/t.jsonl`` is all path.
"""
from __future__ import annotations

from repro_torch.delays.models import (ConstantDelay, DelaySpec, UniformDelay,
                                       Zero, matched_geometric)
from repro_torch.delays.multipod import MultiPod, pods_of
from repro_torch.delays.trace import Trace


def _uniform_or_zero(s: int) -> DelaySpec:
    """The s = 0 normalization: a zero staleness parameter means the
    synchronous limit, as an explicit ``Zero()``."""
    return UniformDelay(s) if s > 0 else Zero()


def _parse_trace(rest: str, s: int) -> Trace:
    if not rest:
        raise ValueError("trace needs a path: trace:PATH[:BOUND]")
    # The bound is split off the RIGHT, and only when the last segment is
    # an unsigned integer; anything else belongs to the path.
    path, bound = rest, (s if s else None)
    head, sep, tail = rest.rpartition(":")
    if sep and tail.isdigit():
        path, bound = head, int(tail)
    if not path:
        raise ValueError("trace needs a path: trace:PATH[:BOUND]")
    return Trace(path, bound=bound)


def parse_spec(text: str, s: int = 0, num_workers: int = 1) -> DelaySpec:
    """Parse a ``--delay`` CLI string; ``s`` and ``num_workers`` supply the
    defaults the grammar leaves implicit (see module docstring)."""
    kind, _, rest = text.strip().partition(":")
    if kind == "trace":
        return _parse_trace(rest, s)
    args = rest.split(":") if rest else []
    try:
        if kind == "uniform":
            return _uniform_or_zero(int(args[0]) if args else s)
        if kind == "zero":
            return Zero()
        if kind == "constant":
            return ConstantDelay(int(args[0]))
        if kind == "geometric":
            if s == 0:
                return Zero()
            trunc = int(args[0]) if args else max(s - 1, 1)
            return matched_geometric(s, num_workers, trunc=trunc)
        if kind == "multipod":
            pods = int(args[0])
            inter_s = int(args[1]) if len(args) > 1 else s
            intra_s = int(args[2]) if len(args) > 2 else 0
            return MultiPod(pod_of=pods_of(num_workers, pods),
                            intra=_uniform_or_zero(intra_s),
                            inter=_uniform_or_zero(inter_s))
    except (IndexError, ValueError) as e:
        raise ValueError(f"bad delay spec {text!r}: {e}") from e
    raise ValueError(
        f"unknown delay spec {text!r}; grammar: uniform[:S] | zero | "
        "constant:D | geometric[:TRUNC] | multipod:PODS[:INTER_S[:INTRA_S]] "
        "| trace:PATH[:BOUND]")
