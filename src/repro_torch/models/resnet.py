"""ResNet with 6n+2 weight layers on CIFAR-shaped inputs (He et al. 2016),
port of ``repro/models/resnet.py``: 3 groups of n residual blocks with
16/32/64 feature maps, GroupNorm, global average pooling, softmax.

Params keep the JAX layout and tree: convolution weights are HWIO
``[kh, kw, Cin, Cout]``, images NHWC, so ``convert.params_from_jax``
carries them over unchanged and packed views agree element for element.
The layout changes only inside ``apply``, to NCHW tensors kept
channels-last in memory (NHWC, the images' own order, which cuDNN's
convolutions read without a transpose).

Every function also takes worker-stacked params (a leading ``[P]`` axis on
every leaf) with images ``x: [P, b, H, W, C]`` and labels ``y: [P, b]``,
and ``make_loss_fn``'s loss then returns the ``[P]`` per-worker losses: the
port's written-out ``vmap``. The P workers' activations ride in one
``[b, P*C, H, W]`` tensor, worker-major along the channels, so each layer
is ONE grouped convolution (``groups=P``, each worker's own weights) and
ONE ``F.group_norm`` with ``P*g`` groups, no group crossing workers.
Unstacked params run as P = 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch import treemath as tm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    n: int = 1                # 6n+2 weight layers: n=1 -> ResNet8, n=5 -> ResNet32
    num_classes: int = 10
    widths: tuple = (16, 32, 64)
    groups: int = 8           # GroupNorm groups


def block_strides(cfg: ResNetConfig) -> tuple:
    """The static stride of each block: 2 at the first block of every group
    after the first, 1 elsewhere (the ``strides`` that ``init`` returns)."""
    return tuple(2 if (gi > 0 and bi == 0) else 1
                 for gi in range(len(cfg.widths)) for bi in range(cfg.n))


def init(key, cfg: ResNetConfig, device=None):
    """``({"params": ...}, strides)`` as the JAX ``init`` returns them: He
    init for the convolutions, ``sqrt(1/C)`` for the head. ``key`` is an
    int seed or a ``torch.Generator`` on ``device``; the draws differ from
    ``jax.random``'s (use ``convert.params_from_jax`` for identical
    weights)."""
    dev = device_lib.resolve(device)
    gen = key if isinstance(key, torch.Generator) else device_lib.generator(key, dev)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dev)

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)))

    def gn(c):
        return {"scale": torch.ones((c,), device=dev),
                "bias": torch.zeros((c,), device=dev)}

    strides = block_strides(cfg)
    params: dict = {"stem": {"w": conv(3, 3, 3, cfg.widths[0]),
                             "gn": gn(cfg.widths[0])}}
    blocks = []
    cin = cfg.widths[0]
    for width, stride in zip([w for w in cfg.widths for _ in range(cfg.n)],
                             strides):
        blk = {"w1": conv(3, 3, cin, width), "gn1": gn(width),
               "w2": conv(3, 3, width, width), "gn2": gn(width)}
        if stride != 1 or cin != width:
            blk["proj"] = conv(1, 1, cin, width)
        blocks.append(blk)
        cin = width
    params["blocks"] = blocks
    params["head"] = {"w": normal((cin, cfg.num_classes), math.sqrt(1.0 / cin)),
                      "b": torch.zeros((cfg.num_classes,), device=dev)}
    return {"params": params}, strides


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial axis: ``(before, after)``. At
    stride 2 on an even size it pads 0 before and 1 after, which
    ``F.conv2d(padding=1)`` does not express."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``h: [b, P*Cin, H, W]``, ``w: [P, kh, kw, Cin, Cout]`` (HWIO per
    worker) -> ``[b, P*Cout, H', W']``: one grouped convolution, SAME
    padding, channels-last operands."""
    p, kh, kw, cin, cout = w.shape
    top, bottom = _same_pad(h.shape[2], kh, stride)
    left, right = _same_pad(h.shape[3], kw, stride)
    if top or bottom or left or right:
        h = F.pad(h, (left, right, top, bottom))
    # OIHW view of [P*Cout, kh, kw, Cin] memory (channels-last).
    weight = w.permute(0, 4, 1, 2, 3).reshape(p * cout, kh, kw, cin)
    return F.conv2d(h.contiguous(memory_format=torch.channels_last),
                    weight.permute(0, 3, 1, 2), stride=stride, groups=p)


def _gn(h: torch.Tensor, gp: dict, groups: int, p: int) -> torch.Tensor:
    """The JAX ``_gn`` per worker (``g = min(groups, C)`` groups, variance
    with ddof 0, ``rsqrt(var + 1e-5)``), for all P workers at once."""
    c = h.shape[1] // p
    g = min(groups, c)
    return F.group_norm(h, p * g, gp["scale"].reshape(-1),
                        gp["bias"].reshape(-1), eps=1e-5)


def _stacked(params: Any, x: torch.Tensor):
    """Unstacked params and ``x: [b, H, W, C]`` as P = 1."""
    if params["params"]["stem"]["w"].dim() == 4:
        return tm.tree_map(lambda a: a.unsqueeze(0), params), x.unsqueeze(0), True
    return params, x, False


def apply(params: Any, strides, x: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """Logits ``[b, classes]``, or ``[P, b, classes]`` for worker-stacked
    params and ``x: [P, b, H, W, C]``."""
    params, x, squeeze = _stacked(params, x)
    pr = params["params"]
    p, b = x.shape[0], x.shape[1]
    # [P, b, H, W, C] -> [b, P*C, H, W] (NHWC memory), worker-major
    # channels.
    h = x.permute(1, 2, 3, 0, 4).reshape(b, x.shape[2], x.shape[3],
                                         p * x.shape[4]).permute(0, 3, 1, 2)
    h = F.relu(_gn(_conv(h, pr["stem"]["w"]), pr["stem"]["gn"], cfg.groups, p))
    for blk, stride in zip(pr["blocks"], strides):
        resid = h
        o = F.relu(_gn(_conv(h, blk["w1"], stride), blk["gn1"], cfg.groups, p))
        o = _gn(_conv(o, blk["w2"]), blk["gn2"], cfg.groups, p)
        if "proj" in blk:
            resid = _conv(resid, blk["proj"], stride)
        h = F.relu(o + resid)
    pooled = h.mean(dim=(2, 3)).reshape(b, p, -1).transpose(0, 1)  # [P, b, C]
    logits = pooled @ pr["head"]["w"] + pr["head"]["b"].unsqueeze(-2)
    return logits[0] if squeeze else logits


def make_loss_fn(cfg: ResNetConfig, strides):
    def loss_fn(params, batch):
        """Mean cross-entropy over the batch axis: a scalar, or ``[P]``."""
        x, y = batch
        logp = F.log_softmax(apply(params, strides, x, cfg), dim=-1)
        picked = torch.take_along_dim(logp, y.long().unsqueeze(-1), dim=-1)
        return -picked.squeeze(-1).mean(dim=-1)
    return loss_fn


def make_accuracy_fn(cfg: ResNetConfig, strides):
    def acc(params, x, y):
        pred = torch.argmax(apply(params, strides, x, cfg), dim=-1)
        return (pred == y.long()).float().mean(dim=-1)
    return acc
