"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, then linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``build/kernels/<content hash>/`` at the root of the checkout on first
use, so an unchanged tree reuses it and an edited source rebuilds.

Nothing here runs at import time: the CPU tests import every module of
the port on a host without ``nvcc``.

``LAUNCHES`` counts kernel launches per kernel name. Each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (src/repro_torch/kernels/build.py -> parents[3])
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libcanal_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES: Dict[str, int] = {
    "fabric_sweep": 0,
    "fabric_sweep_batch": 0,
    "fabric_fused_batch": 0,
    "fabric_fused_run": 0,
    "rv_sweeps": 0,
    "minplus_step": 0,
    "net_bboxes": 0,
    "hpwl": 0,
    "flash_attention": 0,
    "ssd_scan": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: every pointer and the stream as c_void_p, ints as c_int
_SIGNATURES = {
    "canal_fabric_sweep": [_P] * 4 + [_I] * 5 + [_P],
    "canal_fabric_sweep_batch": [_P] * 4 + [_I] * 10 + [_P],
    "canal_fabric_fused_batch": [_P] * 15 + [_P] * 3 + [_I] * 9 + [_P],
    "canal_fabric_fused_run": [_P] * 18 + [_P] * 5 + [_I] * 13 + [_P],
    "canal_fabric_fused_clusters": [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
    "canal_rv_sweeps": [_P] * 17 + [_I] * 5 + [_P],
    "canal_rv_sweeps_clusters": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "canal_minplus_step": [_P, _P, _P, _I, _I, _P],
    "canal_net_bboxes": [_P, _P, _P] + [_I] * 6 + [_P],
    "canal_hpwl": [_P, _P, _P] + [_I] * 6 + [_P],
    "canal_flash_attention": [_P] * 4 + [_I] * 9 + [_P],
    "canal_ssd_scan": [_P] * 8 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was reused)
build_seconds = 0.0


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(kernel: str, n: int = 1) -> None:
    """Add ``n`` to ``kernel``'s launch count (the wrappers run on several
    threads: the DSE queues, the ``run_batch`` split)."""
    with _count_lock:
        LAUNCHES[kernel] += n


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _content_hash(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(sources + sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = Path(home) / "bin" / "nvcc"
        cand = str(path) if path.exists() else None
    if cand is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this host")
    return cand


def _build(out_dir: Path) -> Path:
    """Compile every source (one nvcc process each, all started together)
    and link them. Objects go to a directory of this process's own and the
    library lands by an atomic rename, so concurrent builders (test
    workers) cannot see each other's half-written files."""
    nvcc = _nvcc()
    work = out_dir / f"tmp{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    sources = _sources()
    objs = [work / (p.stem + ".o") for p in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                               str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    errors = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = work / LIB_NAME
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    lib = out_dir / LIB_NAME
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` at first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _content_hash(_sources())
            lib_path = out_dir / LIB_NAME
            t0 = time.perf_counter()
            if not lib_path.exists():
                lib_path = _build(out_dir)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(lib_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(kernel: str, device, dtype, **tensors) -> None:
    """Check that every named tensor is a contiguous ``dtype`` tensor on
    ``device``; a kernel takes nothing else."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def require_shape(kernel: str, name: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream
