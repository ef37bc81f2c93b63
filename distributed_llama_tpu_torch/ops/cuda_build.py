"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C entry point. It is compiled by
``nvcc`` for sm_90a into its own shared library under ``build/kernels/``
(named by a hash of the source, so an edited kernel rebuilds) at first use,
and loaded with ``ctypes``. Nothing here runs at import time: the package
imports on machines without CUDA, where the kernels' wrappers take their
plain PyTorch versions for CPU tensors.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel library name -> (source file, C function, argtypes)
KERNELS = {
    "q40_int8": ("q40_int8.cu", "q40_int8_matmul", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "q40_dequant": ("q40_dequant.cu", "q40_dequant_matmul", [_P, _P, _P, _P, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, object] = {}
build_log: dict[str, str] = {}  # kernel name -> nvcc's output (registers, spills)


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | None = None) -> float:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent; raises
    with nvcc's output if a build fails."""
    names = list(KERNELS) if names is None else names
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    start = time.perf_counter()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - start


def function(name: str):
    """The ctypes function of kernel ``name``, building its library first
    if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _src, fn_name, argtypes = KERNELS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return _loaded[name]
