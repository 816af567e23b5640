"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and bind them with
``ctypes``.

Every ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers), so
each compiles in seconds. On first use in a process, :func:`library` compiles
the sources in parallel (one ``nvcc`` per file, all started together), links
them into one shared library under ``build/repro_torch_kernels/`` at the root
of the checkout (listed in ``.gitignore``), and loads it. The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and a
finished build is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
# name -> (argtypes, restype) of every C entry point in csrc/.
SIGNATURES = {
    "repro_stale_accum_f32": (
        [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P], ctypes.c_int),
    "repro_fused_adam_f32": (
        [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong]
        + [ctypes.c_float] * 8 + [_P], ctypes.c_int),
    "repro_fused_update_f32": (
        [_P] * 17 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_float] * 8 + [_P], ctypes.c_int),
    "repro_sparsify_f32": (
        [_P] * 4 + [ctypes.c_longlong, ctypes.c_longlong, _P], ctypes.c_int),
    "repro_coherence_f32": (
        [_P] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, _P], ctypes.c_int),
    "repro_paged_attention_f32": (
        [_P] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 4 + [_P], ctypes.c_int),
    "repro_flash_attention": (
        [_P] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, _P], ctypes.c_int),
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: under the CUDA toolkit PyTorch found, else on
    ``PATH``. Raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str, float]:
    """Compile and link ``csrc/*.cu`` unless a build of these exact sources
    exists. Returns ``(library path, compiler log, seconds spent)``."""
    srcs = sources()
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest(srcs)}.so"
    if lib_path.exists():
        return lib_path, "", 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen(
            [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    log = "\n".join(f"== {src.name}\n{text}" for src, text in zip(srcs, logs))
    return lib_path, log, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with ``argtypes``
    and ``restype`` declared for every entry point."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_operand(op: str, name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous fp32 tensor of ``shape`` on the
    CUDA ``device`` (what every kernel in ``csrc/`` takes)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{op}: {name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{op}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = torch.cuda.cudart().cudaGetErrorString(err)
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
