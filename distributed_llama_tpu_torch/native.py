"""The port's C++ host library: BPE encode and the Q40 f32 dequant.

The port's copy of the JAX package's ``native`` module, over its own
sources in ``csrc/host/`` and with the same C ABI (``bpe_new`` /
``bpe_encode`` / ``bpe_free``, ``q40_dequant_f32``) plus
``bpe_encode_after``, which merges the dummy-prefix space token in as the
Python encode does. The library is built
by ``g++`` with the JAX package's ``native/Makefile`` flags at first use,
into ``build/host/`` under a name keyed by a hash of the sources and the
flags (as :mod:`ops.cuda_build` names the kernels), written aside and
renamed, so processes that build at once never load a half-written file.
A failed build raises with the compiler's output: there is no Python
fallback on any path. :meth:`tokenizer.Tokenizer.encode` and
:func:`quants.deserialize_tensor` run it; their Python and numpy versions
(``encode_plain``, ``dequantize_q40``) stay beside them as the plain
versions the tests hold it against.

Each wrapper counts its calls into the library in :data:`launches`, as the
kernel wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG.parent / "build" / "host"
SOURCES = ("bpe_native.cpp", "q40_native.cpp")
CXX = "g++"
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-Wall", "-Werror", "-shared"]

# C function -> calls since the last reset_launches(); a wrapper adds one
# where it calls into the library and nowhere else
launches: dict[str, int] = {"bpe_encode_after": 0, "q40_dequant_f32": 0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def cxx_path() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"the C++ compiler {CXX!r} was not found: the port's host library is built with it")
    return found


def lib_path() -> Path:
    digest = hashlib.sha256(
        b"".join((HOST_SRC / s).read_bytes() for s in SOURCES) + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libdllama_host-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx_path(), *CXX_FLAGS, *(str(HOST_SRC / s) for s in SOURCES), "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed ({' '.join(cmd)}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load_library():
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.q40_dequant_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.q40_dequant_f32.restype = None
            lib.bpe_new.restype = ctypes.c_void_p
            lib.bpe_new.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_free.restype = None
            lib.bpe_encode_after.restype = ctypes.c_int32
            lib.bpe_encode_after.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
                                             ctypes.c_void_p]
            _lib = lib
        return _lib


def q40_dequant_f32(blocks: np.ndarray, n_values: int) -> np.ndarray:
    """Raw Q40 file blocks -> f32 [n_values]."""
    lib = load_library()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    if n_values % 32 or blocks.size < n_values // 32 * 18:
        raise ValueError(f"{blocks.size} bytes do not hold {n_values} Q40 values")
    out = np.empty(n_values, np.float32)
    launches["q40_dequant_f32"] += 1
    lib.q40_dequant_f32(blocks.ctypes.data, n_values // 32, out.ctypes.data)
    return out


class NativeBpe:
    """A native tokenizer handle over copies of the vocab: the UTF-8 split
    with byte fallback and the greedy merge of ``Tokenizer.encode``."""

    def __init__(self, vocab: list[bytes], scores: list[float]):
        self._lib = load_library()
        offsets = np.zeros(len(vocab) + 1, np.int64)
        np.cumsum([len(t) for t in vocab], out=offsets[1:])
        blob = np.frombuffer(b"".join(vocab), np.uint8).copy()
        scores_arr = np.asarray(scores, np.float32)
        self._handle = self._lib.bpe_new(blob.ctypes.data, offsets.ctypes.data, scores_arr.ctypes.data, len(vocab))

    def encode(self, text: bytes, first: int = -1) -> list[int]:
        """Token ids of ``text`` after the token ``first`` (the dummy-prefix
        space; -1: none), which takes part in the merges. No BOS or EOS."""
        out = np.empty(len(text) + 1, np.int32)
        launches["bpe_encode_after"] += 1
        n = self._lib.bpe_encode_after(self._handle, first, text, len(text), out.ctypes.data)
        if n < 0:
            raise IndexError("a byte-fallback token id lies past the vocab")
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
            self._handle = None
