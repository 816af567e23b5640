"""Common layer building blocks (port of ``repro/models/layers.py``).

Params are built as nested dicts whose leaves are ``Param(value, axes)``;
``unzip`` splits one tree into (values, axes). The logical-axes trees are
plain tuples; ``sharding/rules.py`` maps them to mesh placements.

The initialisers draw from a ``torch.Generator``, so the weights differ from
``jax.random``'s; tests carry JAX's weights across with
``convert.params_from_jax``. On the ``meta`` device they only allocate
shapes. Under ``use_keep`` each value is cut to the block this process
keeps as soon as it is drawn (``engine/placement.py::MeshPlacement.keep``);
under ``draw_by_layer`` (the FSDP archs' init, ``configs.base.ArchDef``)
a stacked leaf is drawn a slice at a time, so such a rank never holds a
whole stacked leaf.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class Param(NamedTuple):
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def is_param(x) -> bool:
    return isinstance(x, Param)


def unzip(tree: Any) -> Tuple[Any, Any]:
    """(values, axes) of a tree whose leaves are ``Param``s."""
    def walk(node, pick):
        if is_param(node):
            return pick(node)
        if isinstance(node, dict):
            return {k: walk(v, pick) for k, v in node.items()}
        return node
    return walk(tree, lambda p: p.value), walk(tree, lambda p: p.axes)


def _fill(t: torch.Tensor, fn) -> torch.Tensor:
    if t.device.type != "meta":
        fn(t)
    return t


_KEEP: list = []


class use_keep:
    """``with use_keep(fn):`` the initialisers hand every value they make
    (a whole leaf, or one slice of a stacked leaf) to ``fn(value, axes)``,
    ``axes`` the logical axes of its trailing dims, and keep what it
    returns. ``use_keep(None)`` keeps values whole."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        _KEEP.append(self.fn)
        return self.fn

    def __exit__(self, *exc):
        _KEEP.pop()
        return False


_BY_LAYER: list = []


@contextlib.contextmanager
def draw_by_layer():
    """``with draw_by_layer():`` the initialisers draw a stacked leaf one
    slice at a time, each its own draw in order, where they would draw it
    at once. The values differ from one draw's, so an arch draws one way
    wherever it inits (``configs.base.ArchDef.api``)."""
    _BY_LAYER.append(True)
    try:
        yield
    finally:
        _BY_LAYER.pop()


def _kept(w: torch.Tensor, axes, dtype) -> torch.Tensor:
    fn = _KEEP[-1] if _KEEP else None
    return (w if fn is None else fn(w, tuple(axes))).to(dtype)


def _stacked(lead, shape, device, fill, axes, dtype) -> torch.Tensor:
    """A ``lead + shape`` leaf (fp32, filled by ``fill``) kept as drawn:
    in one draw, or under ``draw_by_layer`` a ``shape`` slice at a time
    in order."""
    if not _BY_LAYER:
        return _kept(_fill(torch.empty(tuple(lead) + tuple(shape),
                                       dtype=torch.float32, device=device),
                           fill), axes, dtype)
    out = None
    for i in range(math.prod(lead)):
        w = _fill(torch.empty(tuple(shape), dtype=torch.float32,
                              device=device), fill)
        block = _kept(w, axes, dtype)
        del w
        if out is None:
            out = block.new_empty((math.prod(lead),) + tuple(block.shape))
        out[i] = block
        del block
    if out is None:             # a lead dim of 0: nothing to draw
        kept = _kept(torch.empty(tuple(shape), device="meta"), axes, dtype)
        return torch.empty(tuple(lead) + tuple(kept.shape), dtype=dtype,
                           device=device)
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


def dense_init(gen: torch.Generator, shape, axes, in_axis: int = 0,
               scale: float = 1.0, dtype=torch.float32, device=None,
               lead: Tuple[int, ...] = ()) -> Param:
    """Truncated-normal fan-in init; ``in_axis`` marks the contraction dim
    used for the fan-in (negative counts from the end). ``lead`` prepends
    stacked axes (e.g. ``[L]`` layers)."""
    std = scale / math.sqrt(max(shape[in_axis], 1))
    return Param(_stacked(lead, shape, device, lambda t: (
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=gen).mul_(std)), axes, dtype),
                 axes)


def embed_init(gen: torch.Generator, shape, axes, dtype=torch.float32,
               device=None) -> Param:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    _fill(w, lambda t: t.normal_(0.0, 0.02, generator=gen))
    return Param(_kept(w, axes, dtype), axes)


def scale_init(shape, axes, value: float = 1.0, dtype=torch.float32,
               device=None) -> Param:
    """A constant leaf; ``axes`` name the trailing dims of ``shape`` (a
    stacked leaf's lead dims come first). Under ``use_keep`` only the
    kept block is made (its shape from a meta value)."""
    fn = _KEEP[-1] if _KEEP else None
    if fn is not None:
        shape = fn(torch.empty(tuple(shape), device="meta"), tuple(axes)).shape
    return Param(torch.full(tuple(shape), value, dtype=dtype, device=device),
                 axes)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rotary(theta: float, positions: torch.Tensor,
           head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary position embedding tables: (cos, sin) of shape
    [..., head_dim // 2] for the given positions."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions.float()[..., None] * freqs          # [..., half]
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: [..., head_dim], rotated in the half-split layout (the first half
    pairs with the second); cos/sin broadcast over the head axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    while cos.dim() < x1.dim():
        cos = cos.unsqueeze(-2)
        sin = sin.unsqueeze(-2)
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return F.silu(x_gate) * x_up


class _MmF32(torch.autograd.Function):
    """``a [N, K] @ w [K, M]`` of 16-bit operands with an fp32 result, on
    the tensor cores (``torch.mm(out_dtype=)``, which has no derivative of
    its own). The gradient that comes back is a 16-bit one cast up (the
    result is only ever summed and rounded back), so the backward products
    run in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.t(), a.t() @ g


def contract_f32(a: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``a``'s last ``n`` dims contracted with ``w``'s first ``n``, in
    ``a``'s dtype, the result fp32 (a rank-partial product, summed before
    it rounds). On the card 16-bit operands stay on the tensor cores with
    fp32 accumulation; elsewhere both are cast up, which is the same
    product (a product of two bf16 numbers is exact in fp32)."""
    lead, tail = a.shape[:a.dim() - n], w.shape[n:]
    a2 = a.reshape(math.prod(lead), -1)
    w2 = w.to(a.dtype).reshape(a2.shape[1], -1)
    if a2.is_cuda and a2.dtype in (torch.bfloat16, torch.float16):
        out = _MmF32.apply(a2, w2)
    else:
        out = a2.float() @ w2.float()
    return out.reshape(*lead, *tail)


def causal_mask(q_len: int, kv_len: int, q_offset, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; q positions are offset by
    ``q_offset`` relative to kv position 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def sliding_window_mask(q_len: int, kv_len: int, q_offset, window: int,
                        device=None) -> torch.Tensor:
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return (k_pos <= q_pos) & (k_pos > q_pos - window)


def stacked_axes(axes: Any) -> Any:
    """Prefix every leaf's axes tuple with ``"layers"`` (the stacked layer
    axis)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return ("layers",) + tuple(node)
    return walk(axes)

