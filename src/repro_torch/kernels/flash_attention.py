"""CUDA kernel: blockwise online-softmax attention over a whole sequence
(``csrc/flash_attention.cu``), the port of
``repro/kernels/flash_attention.py``.

Causal and sliding-window masks, GQA head groups, q right-aligned to the
keys (q row i at position i + Sk - Sq); fp32 or bf16 operands, fp32 scores,
softmax and accumulation, output in q's dtype. bf16 operands run on the
tensor cores (``mma.sync``, with the probabilities fed as an exact bf16
hi/lo pair), fp32 operands on the fp32 pipes. Any head width up to 256 and
any Sq <= Sk run: the kernel masks its own ragged edges, so there is no
block-size contract and no shape falls back. Sums run in a fixed order, so
two calls on the same inputs are equal bit for bit. CPU tensors go to
``kernels/ref.py`` through ``kernels/dispatch.py``, never through here.

Forward only, as the TPU kernel is: no model calls it in either package
(the transformer trains through its own differentiable attention), so it
has no backward kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q [B,Sq,H,hd], k/v [B,Sk,Hkv,hd] (one dtype, fp32 or bf16, on one
    CUDA device) -> [B,Sq,H,hd] in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "[B, S, heads, hd]")
    b, sq, h, hd = q.shape
    bk, sk, hkv, hdk = k.shape
    if bk != b or hdk != hd or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if not 1 <= hd <= 256:
        raise ValueError(f"flash_attention: head_dim={hd} outside [1, 256]")
    if window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    if (causal or window) and sq > sk:
        raise ValueError(f"flash_attention: Sq={sq} > Sk={sk} under a "
                         "causal mask leaves query rows with no key")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H={b * h} > 65535")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: operands must share one dtype, "
                         f"fp32 or bf16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"on {dev}, got {t.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if min(b, sq, sk) == 0:
        return out
    # 1 / sqrt(hd) as the JAX oracle computes it, in fp32.
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.repro_flash_attention(
            out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            DTYPES[q.dtype], b, sq, sk, h, hkv, hd, int(bool(causal)),
            int(window), scale, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
