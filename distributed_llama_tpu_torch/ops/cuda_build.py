"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C entry point. It is compiled by
``nvcc`` for sm_90a into its own shared library under ``build/kernels/``
(named by a hash of the source and the headers beside it, so an edited
kernel rebuilds) at first use, and loaded with ``ctypes``. Nothing here runs at import time: the package
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
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers, one per rank
# kernel library name -> (source file, C function, argtypes)
KERNELS = {
    "q40_int8": ("q40_int8.cu", "q40_int8_matmul", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "q40_dequant": ("q40_dequant.cu", "q40_dequant_matmul", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "paged_attention": ("paged_attention.cu", "paged_attention", [_P] * 14 + [_I] * 10 + [_P]),
    "ring_all_reduce": ("ring_all_reduce.cu", "ring_all_reduce", [_PP, _PP, _I, ctypes.c_longlong, _I, _P]),
    "fused_matmul_ring": ("fused_matmul_ring.cu", "fused_matmul_ring", [_PP] * 6 + [_I] * 4 + [_P]),
}
_LL = ctypes.c_longlong
_OUT = ctypes.POINTER(ctypes.c_void_p)  # where a C function writes a pointer or handle it made
# further C functions of a kernel library: its passes, called alone to hold
# each against its plain version, K5's launch shape, and K4's cross-process
# form (staging buffers and interprocess events shared through IPC handles)
SYMBOLS = {
    "ring_all_reduce": {
        "ring_ipc_alloc": [_I, _LL, _OUT, ctypes.c_char_p],
        "ring_ipc_open": [_I, ctypes.c_char_p, _OUT],
        "ring_ipc_close": [_I, _P],
        "ring_ipc_free": [_I, _P],
        "ring_ipc_event_create": [_I, _OUT, ctypes.c_char_p],
        "ring_ipc_event_open": [_I, ctypes.c_char_p, _OUT],
        "ring_ipc_event_destroy": [_I, _P],
        "ring_ipc_stage": [_I, _PP, _I, _P, _LL, _LL, _PP, _I, _P, _P],
        "ring_ipc_reduce": [_I, _PP, _PP, _I, _I, _LL, _I, _PP, _I, _P, _P],
        "ring_ipc_fetch": [_I, _PP, _PP, _I, _LL, _PP, _I, _P, _P],
    },
    "fused_matmul_ring": {"fused_matmul_ring_cluster": [_I, ctypes.POINTER(ctypes.c_int)]},
    "paged_attention": {
        "paged_attention_partials": [_P] * 14 + [_I] * 10 + [_P],
        "paged_attention_merge": [_P, _P] + [_I] * 7 + [_P],
    },
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
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


def function(name: str, symbol: str | None = None):
    """The ctypes function of kernel ``name`` (or its library's C function
    ``symbol``, one of ``SYMBOLS[name]``), building the library first if
    needed."""
    _src, fn_name, argtypes = KERNELS[name]
    if symbol is not None and symbol != fn_name:
        fn_name, argtypes = symbol, SYMBOLS[name][symbol]
    with _lock:
        if fn_name not in _loaded:
            build([name])
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[fn_name] = fn
        return _loaded[fn_name]
