"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries are cached under
``build/kernels/`` at the repository root, keyed by a hash of the source and
the shared headers (``csrc/*.cuh``), so an edited source rebuilds and an
unchanged one loads at once; nvcc's output (the ptxas register and spill
report) is kept beside each library as ``lib<name>-<hash>.log``.  Nothing is
built when a module is imported: the first launch builds what it needs, and
:func:`build_all` builds every source in parallel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I = ctypes.c_void_p, ctypes.c_int
# C signatures of the exported entry points (every pointer and the stream
# as c_void_p, every int as c_int; each returns a cudaError_t)
SIGNATURES = {
    "flash_fwd": ("ospo_flash_fwd", [P] * 7 + [I] * 8 + [P]),
    "flash_bwd_dq": ("ospo_flash_bwd_dq", [P] * 9 + [I] * 8 + [P]),
    "flash_bwd_dkv": ("ospo_flash_bwd_dkv", [P] * 10 + [I] * 8 + [P]),
    "decode_attention": ("ospo_decode_attention", [P] * 9 + [I] * 10 + [P]),
    "int4_matmul_row": ("ospo_int4_matmul_row", [P] * 5 + [I] * 6 + [P]),
    "int4_matmul_group": ("ospo_int4_matmul_group", [P] * 5 + [I] * 7 + [P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    """The library's path, keyed by the source, the shared headers of
    ``csrc/`` and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process or None)."""
    target = _target(name)
    if target.exists() and target.with_suffix(".log").exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> str:
    """Wait for nvcc; returns its output, or the kept output of a cached
    library."""
    log = target.with_suffix(".log")
    if job is None:
        return log.read_text() if log.exists() else ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    log.write_text(out)
    os.replace(tmp, target)
    return out


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Build the named kernels in parallel (one nvcc each); returns each
    build's compiler output (ptxas register/spill report), kept from the
    build that made a cached library."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    logs = {n: _finish(n, *jobs[n]) for n in names}
    for n in names:
        load(n)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(target))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
