"""Carry parameters across from the JAX package.

``repro``'s initialisers draw from ``jax.random``, which torch cannot
reproduce. A caller that wants both packages to start from the same weights
converts the JAX tree to numpy (``jax.tree.map(np.asarray, params)``) and
hands it here; nothing of JAX is imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dict/list/tuple of numpy arrays -> the same structure of
    tensors on ``device`` (CUDA unless ``device="cpu"``). Shapes and layout
    are kept as they are (``w`` stays ``[d_in, d_out]``), so packed views
    agree element-wise with ``repro.treemath.tree_pack``."""
    dev = device_lib.resolve(device)

    def conv(node):
        if node is None:          # an empty subtree, as in JAX
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            kids = [conv(v) for v in node]
            return kids if isinstance(node, list) else tuple(kids)
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":
            # numpy has no bf16 of its own (JAX's is ml_dtypes'): carry the
            # bits.
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    return conv(tree)
