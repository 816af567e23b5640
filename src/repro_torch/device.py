"""Device choice shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or left as the default) and
    absent; nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def generator(seed: Optional[int], device: torch.device) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (the port's stand-in for a
    ``jax.random`` key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if seed is None else int(seed))
    return gen


def init_generator(key, device: torch.device) -> torch.Generator:
    """A model init's generator: ``key`` itself if it is one, else one
    seeded from it on ``device`` (on the CPU for ``meta``, which makes
    shapes only and has no generator)."""
    if isinstance(key, torch.Generator):
        return key
    return generator(key, torch.device("cpu") if device.type == "meta"
                     else device)
