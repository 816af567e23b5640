"""Mesh construction (port of ``repro/launch/mesh.py``).

``make_host_mesh`` builds a real ``DeviceMesh`` over the initialised
process group, one rank a device (``nccl`` for CUDA, ``gloo`` for the
CPU); ``make_production_mesh`` returns the JAX package's production shapes
as :class:`~repro_torch.sharding.rules.AbstractMesh` es, for planning only.
``parse_host_mesh`` is the CLIs' ``--mesh DATAxMODEL``: it joins the process
group a ``torchrun`` launch describes in its environment.
"""
from __future__ import annotations

import os

import torch

from repro_torch import device as device_lib
from repro_torch.sharding.rules import (AbstractMesh, data_extent,  # noqa: F401
                                        model_extent)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips a pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def backend_for(device) -> str:
    """The process-group backend that moves tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device=None) -> None:
    """Join the process group ``torchrun`` (or any launcher setting
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``) describes, on
    the backend of ``device`` (CUDA unless ``device="cpu"``; raises without
    CUDA otherwise); a no-op once it is up."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        raise RuntimeError(
            "no process group: launch under torchrun (e.g. `torchrun "
            "--nproc-per-node N -m repro_torch.launch.train --mesh Nx1`) or "
            "call torch.distributed.init_process_group first")
    dev = device_lib.resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(dev))


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` DeviceMesh named ``("data", "model")`` over the
    initialised process group, whose world size must be ``data * model``.
    ``device`` picks the device type (CUDA unless ``device="cpu"``; raises
    without CUDA otherwise); rank r sits at ``(r // model, r % model)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialised process group "
            "(torch.distributed.init_process_group, or torchrun)")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; "
                         f"the process group has {world}")
    dev = device_lib.resolve(device)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def parse_spec(spec: str) -> tuple:
    """'DATAxMODEL' -> (data, model); a malformed spec exits."""
    try:
        data, model = (int(x) for x in spec.split("x"))
    except ValueError:
        raise SystemExit(
            f"--mesh expects 'DATAxMODEL' (e.g. 2x1), got {spec!r}") from None
    if data < 1 or model < 1:
        raise SystemExit(f"--mesh extents must be >= 1, got {spec!r}")
    return data, model


def parse_host_mesh(spec: str, device=None):
    """'DATAxMODEL' CLI spec (e.g. '2x1') -> host mesh, or None for '1x1'
    outside a process group (the one-device run). Any other spec joins the
    ``torchrun`` process group first and needs DATA x MODEL ranks."""
    data, model = parse_spec(spec)
    import torch.distributed as dist
    if (data, model) == (1, 1) and not dist.is_initialized() \
            and "WORLD_SIZE" not in os.environ:
        return None
    init_process_group(device)
    return make_host_mesh(data, model, device=device)
