"""`.m` model file format: header + flat tensor stream.

Layout:

  int32 magic = 0xA00ABCD
  int32 header_size            # bytes, including magic and this field
  (int32 key, int32 value) *   # HeaderKey pairs
  tensor bytes ...             # fixed order, see tensor_layout()

The legacy fixed-struct header (magic 0xABCD00/0xABCD01) is readable too.

Tensor order:

  embedding (F32) [vocab, dim]
  per layer:
    q [dim, dim], k [kv_dim, dim], v [kv_dim, dim], wo [dim, dim]
    if moe:  router [n_experts, dim];
             per expert: up [hidden, dim], gate [hidden, dim], down [dim, hidden]
    else:    gate/w1 [hidden, dim], down/w2 [dim, hidden], up/w3 [hidden, dim]
    rms_att (F32) [dim], rms_ffn (F32) [dim]
    if grok1: rms_moe (F32) [dim], rms_ffn2 (F32) [dim]
  rms_final (F32) [dim]
  wcls [vocab, dim]

All matrices are row-major [d_out, d_in] (y = W @ x).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import struct
from typing import BinaryIO, Iterator

import numpy as np

from distributed_llama_tpu_torch.quants import (
    QK,
    FloatType,
    deserialize_tensor,
    serialize_tensor,
    tensor_bytes,
)

MAGIC_KV = 0xA00ABCD
LEGACY_MAGICS = (0xABCD00, 0xABCD01)


class ArchType(enum.IntEnum):
    LLAMA = 0xABCD00
    GROK1 = 0xABCD01
    MIXTRAL = 0xABCD02


class HiddenAct(enum.IntEnum):
    GELU = 0
    SILU = 1


class RopeType(enum.IntEnum):
    UNKNOWN = -1
    LLAMA = 0
    FALCON = 1
    LLAMA3_1 = 2


class HeaderKey(enum.IntEnum):
    VERSION = 0
    ARCH_TYPE = 1
    DIM = 2
    HIDDEN_DIM = 3
    N_LAYERS = 4
    N_HEADS = 5
    N_KV_HEADS = 6
    N_EXPERTS = 7
    N_ACTIVE_EXPERTS = 8
    VOCAB_SIZE = 9
    SEQ_LEN = 10
    HIDDEN_ACT = 11
    ROPE_THETA = 12
    WEIGHTS_FLOAT_TYPE = 13
    ROPE_SCALING_FACTOR = 14
    ROPE_SCALING_LOW_FREQ_FACTOR = 15
    ROPE_SCALING_HIGH_FREQ_FACTORY = 16
    ROPE_SCALING_ORIG_MAX_SEQ_LEN = 17
    ROPE_TYPE = 18


_KEY_FIELDS = {
    HeaderKey.VERSION: "version",
    HeaderKey.ARCH_TYPE: "arch_type",
    HeaderKey.DIM: "dim",
    HeaderKey.HIDDEN_DIM: "hidden_dim",
    HeaderKey.N_LAYERS: "n_layers",
    HeaderKey.N_HEADS: "n_heads",
    HeaderKey.N_KV_HEADS: "n_kv_heads",
    HeaderKey.N_EXPERTS: "n_experts",
    HeaderKey.N_ACTIVE_EXPERTS: "n_active_experts",
    HeaderKey.VOCAB_SIZE: "vocab_size",
    HeaderKey.SEQ_LEN: "seq_len",
    HeaderKey.HIDDEN_ACT: "hidden_act",
    HeaderKey.ROPE_THETA: "rope_theta",
    HeaderKey.WEIGHTS_FLOAT_TYPE: "weights_float_type",
    HeaderKey.ROPE_SCALING_FACTOR: "rope_scaling_factor",
    HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR: "rope_scaling_low_freq_factor",
    HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTORY: "rope_scaling_high_freq_factor",
    HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN: "rope_scaling_orig_max_seq_len",
    HeaderKey.ROPE_TYPE: "rope_type",
}


@dataclasses.dataclass
class ModelSpec:
    """Parsed model header."""

    arch_type: ArchType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    n_experts: int = 0
    n_active_experts: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    rope_theta: float = 10000.0
    rope_type: RopeType = RopeType.UNKNOWN
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    weights_float_type: FloatType = FloatType.Q40
    version: int = 0
    header_size: int = 0
    file_size: int = 0
    orig_seq_len: int = 0

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return (self.dim * self.n_kv_heads) // self.n_heads

    def resolved_rope_type(self) -> RopeType:
        """Default rope by arch when the header names none."""
        if self.rope_type != RopeType.UNKNOWN:
            return self.rope_type
        if self.arch_type == ArchType.LLAMA:
            return RopeType.LLAMA
        return RopeType.FALCON

    def clamp_seq_len(self, max_seq_len: int | None) -> "ModelSpec":
        """Apply the ``--max-seq-len`` clamp."""
        spec = dataclasses.replace(self)
        spec.orig_seq_len = self.seq_len if self.orig_seq_len == 0 else self.orig_seq_len
        if max_seq_len and spec.seq_len > max_seq_len:
            spec.seq_len = max_seq_len
        return spec


def _header_pairs(spec: ModelSpec) -> list[tuple[int, int]]:
    pairs = [
        (HeaderKey.VERSION, spec.version),
        (HeaderKey.ARCH_TYPE, int(spec.arch_type)),
        (HeaderKey.DIM, spec.dim),
        (HeaderKey.HIDDEN_DIM, spec.hidden_dim),
        (HeaderKey.N_LAYERS, spec.n_layers),
        (HeaderKey.N_HEADS, spec.n_heads),
        (HeaderKey.N_KV_HEADS, spec.n_kv_heads),
        (HeaderKey.N_EXPERTS, spec.n_experts),
        (HeaderKey.N_ACTIVE_EXPERTS, spec.n_active_experts),
        (HeaderKey.VOCAB_SIZE, spec.vocab_size),
        (HeaderKey.SEQ_LEN, spec.seq_len),
        (HeaderKey.HIDDEN_ACT, int(spec.hidden_act)),
        (HeaderKey.ROPE_THETA, int(spec.rope_theta)),
        (HeaderKey.WEIGHTS_FLOAT_TYPE, int(spec.weights_float_type)),
    ]
    if spec.rope_type != RopeType.UNKNOWN:
        pairs.append((HeaderKey.ROPE_TYPE, int(spec.rope_type)))
    if spec.rope_scaling_factor:
        # header values are int32: the float scaling params are truncated
        pairs += [
            (HeaderKey.ROPE_SCALING_FACTOR, int(spec.rope_scaling_factor)),
            (HeaderKey.ROPE_SCALING_LOW_FREQ_FACTOR, int(spec.rope_scaling_low_freq_factor)),
            (HeaderKey.ROPE_SCALING_HIGH_FREQ_FACTORY, int(spec.rope_scaling_high_freq_factor)),
            (HeaderKey.ROPE_SCALING_ORIG_MAX_SEQ_LEN, spec.rope_scaling_orig_max_seq_len),
        ]
    return pairs


def write_header(f: BinaryIO, spec: ModelSpec) -> int:
    """Write magic + header; returns header_size (8 + key/value bytes)."""
    data = b"".join(struct.pack("<ii", int(k), int(v)) for k, v in _header_pairs(spec))
    header_size = 8 + len(data)
    f.write(struct.pack("<i", MAGIC_KV))
    f.write(struct.pack("<i", header_size))
    f.write(data)
    return header_size


def read_spec(path: str, weights_float_type: FloatType | None = None) -> ModelSpec:
    """Parse the `.m` header. ``weights_float_type`` must be given for
    legacy-magic files, whose header has no dtype field."""
    fields: dict = dict(
        hidden_act=HiddenAct.SILU,
        rope_type=RopeType.UNKNOWN,
        rope_theta=10000.0,
        n_experts=0,
        n_active_experts=0,
    )
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
        if magic in LEGACY_MAGICS:
            (
                fields["dim"], fields["hidden_dim"], fields["n_layers"],
                fields["n_heads"], fields["n_kv_heads"], fields["n_experts"],
                fields["n_active_experts"], fields["vocab_size"], fields["seq_len"],
            ) = struct.unpack("<9i", f.read(36))
            fields["arch_type"] = ArchType(magic)
            fields["header_size"] = 4 + 36
            fields["weights_float_type"] = (
                None if weights_float_type is None else int(weights_float_type)
            )
        elif magic == MAGIC_KV:
            (header_size,) = struct.unpack("<i", f.read(4))
            n_ints = (header_size - 8) // 4
            raw = struct.unpack(f"<{n_ints}i", f.read(n_ints * 4))
            fields["header_size"] = header_size
            for i in range(0, n_ints, 2):
                key, value = raw[i], raw[i + 1]
                try:
                    name = _KEY_FIELDS[HeaderKey(key)]
                except ValueError:
                    raise ValueError(f"unsupported header key: {key}") from None
                fields[name] = value
        else:
            raise ValueError(f"unsupported model file magic: {magic & 0xFFFFFFFF:#x}")
        fields["file_size"] = os.fstat(f.fileno()).st_size

    fields["arch_type"] = ArchType(fields["arch_type"])
    fields["hidden_act"] = HiddenAct(fields["hidden_act"])
    fields["rope_type"] = RopeType(fields.get("rope_type", -1))
    fields["rope_theta"] = float(fields["rope_theta"])
    if fields.get("weights_float_type") is None:
        raise ValueError("legacy header does not carry a weights float type; pass it explicitly")
    fields["weights_float_type"] = FloatType(fields["weights_float_type"])
    fields["orig_seq_len"] = fields["seq_len"]
    return ModelSpec(**fields)


@dataclasses.dataclass(frozen=True)
class TensorEntry:
    name: str
    shape: tuple[int, ...]
    float_type: FloatType
    offset: int  # absolute byte offset in the file
    nbytes: int

    @property
    def n_values(self) -> int:
        return int(np.prod(self.shape))


def tensor_layout(spec: ModelSpec) -> list[TensorEntry]:
    """The fixed tensor order of the `.m` stream."""
    wt = spec.weights_float_type
    dim, hidden, kv_dim, vocab = spec.dim, spec.hidden_dim, spec.kv_dim, spec.vocab_size
    entries: list[TensorEntry] = []
    offset = spec.header_size

    def add(name: str, shape: tuple[int, ...], ft: FloatType):
        nonlocal offset
        nbytes = tensor_bytes(ft, int(np.prod(shape)))
        entries.append(TensorEntry(name, shape, ft, offset, nbytes))
        offset += nbytes

    add("embedding", (vocab, dim), FloatType.F32)
    for l in range(spec.n_layers):
        p = f"layers.{l}."
        add(p + "q", (dim, dim), wt)
        add(p + "k", (kv_dim, dim), wt)
        add(p + "v", (kv_dim, dim), wt)
        add(p + "wo", (dim, dim), wt)
        if spec.n_experts > 0:
            add(p + "moe_router", (spec.n_experts, dim), wt)
            for e in range(spec.n_experts):
                ep = f"{p}experts.{e}."
                add(ep + "up", (hidden, dim), wt)
                add(ep + "gate", (hidden, dim), wt)
                add(ep + "down", (dim, hidden), wt)
        else:
            add(p + "gate", (hidden, dim), wt)  # w1
            add(p + "down", (dim, hidden), wt)  # w2
            add(p + "up", (hidden, dim), wt)  # w3
        add(p + "rms_att", (dim,), FloatType.F32)
        add(p + "rms_ffn", (dim,), FloatType.F32)
        if spec.arch_type == ArchType.GROK1:
            add(p + "rms_moe", (dim,), FloatType.F32)
            add(p + "rms_ffn2", (dim,), FloatType.F32)
    add("rms_final", (dim,), FloatType.F32)
    add("wcls", (vocab, dim), wt)
    return entries


class ModelFileReader:
    """mmap-backed random access to the tensors of a `.m` file."""

    def __init__(
        self,
        path: str,
        spec: ModelSpec | None = None,
        weights_float_type: FloatType | None = None,
    ):
        self.path = path
        self.spec = spec or read_spec(path, weights_float_type=weights_float_type)
        self.entries = {e.name: e for e in tensor_layout(self.spec)}
        last = max(self.entries.values(), key=lambda e: e.offset)
        expected = last.offset + last.nbytes
        if self.spec.file_size and expected != self.spec.file_size:
            raise ValueError(
                f"model file size mismatch: layout expects {expected} bytes, "
                f"file has {self.spec.file_size}"
            )
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")
        self.bytes_read = 0  # the bytes every read below served (a sharded load reads its ranks' only)

    def raw(self, name: str) -> np.ndarray:
        e = self.entries[name]
        self.bytes_read += e.nbytes
        return self._mmap[e.offset : e.offset + e.nbytes]

    def tensor(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in its logical shape."""
        e = self.entries[name]
        return deserialize_tensor(self.raw(name), e.float_type, e.n_values).reshape(e.shape)

    # -- per-shard range readers (tensor parallelism): each rank's pack is
    # -- built from its own byte ranges, the read-time form of the
    # -- reference's RowMatmulSlice / ColMatmulSlice

    def raw_rows(self, name: str, row_start: int, row_end: int) -> np.ndarray:
        """Raw bytes of a contiguous row (output-dim) range: the exact-repack
        shard read of an output-sharded Q40 matrix."""
        e = self.entries[name]
        row_bytes = tensor_bytes(e.float_type, e.shape[1])
        start = e.offset + row_start * row_bytes
        nbytes = (row_end - row_start) * row_bytes
        self.bytes_read += nbytes
        return self._mmap[start : start + nbytes]

    def raw_row_blocks(self, name: str, col_start: int, col_end: int) -> np.ndarray:
        """Raw bytes of a column (input-dim) range of every row, cut on
        quant-block boundaries: the shard read of an input-sharded Q40
        matrix. Returns [d_out, col_bytes] bytes."""
        e = self.entries[name]
        d_out, d_in = e.shape
        if col_start % QK or col_end % QK:
            raise ValueError(f"column range ({col_start},{col_end}) not {QK}-aligned")
        lo, hi = tensor_bytes(e.float_type, col_start), tensor_bytes(e.float_type, col_end)
        rows = self._mmap[e.offset : e.offset + e.nbytes].reshape(d_out, tensor_bytes(e.float_type, d_in))
        out = np.ascontiguousarray(rows[:, lo:hi])
        self.bytes_read += out.nbytes
        return out

    def tensor_rows(self, name: str, row_start: int, row_end: int) -> np.ndarray:
        """f32 rows [row_start, row_end) of a matrix, reading only them."""
        e = self.entries[name]
        if len(e.shape) != 2:
            raise ValueError(f"tensor_rows on non-matrix {name}")
        n = e.shape[1]
        nrows = row_end - row_start
        return deserialize_tensor(self.raw_rows(name, row_start, row_end), e.float_type, nrows * n).reshape(nrows, n)

    def tensor_cols(self, name: str, col_start: int, col_end: int) -> np.ndarray:
        """f32 columns [col_start, col_end) of every row of a matrix: block
        formats (Q40/Q80) cut on quant-block boundaries when the range is
        aligned, else decode whole rows. Returns [d_out, cols]."""
        e = self.entries[name]
        if len(e.shape) != 2:
            raise ValueError(f"tensor_cols on non-matrix {name}")
        d_out, d_in = e.shape
        ncols = col_end - col_start
        if e.float_type in (FloatType.Q40, FloatType.Q80):
            if col_start % QK == 0 and col_end % QK == 0:
                buf = self.raw_row_blocks(name, col_start, col_end)
                return deserialize_tensor(buf.reshape(-1), e.float_type, d_out * ncols).reshape(d_out, ncols)
            return self.tensor(name)[:, col_start:col_end]
        lo, hi = tensor_bytes(e.float_type, col_start), tensor_bytes(e.float_type, col_end)
        rows = self._mmap[e.offset : e.offset + e.nbytes].reshape(d_out, tensor_bytes(e.float_type, d_in))
        buf = np.ascontiguousarray(rows[:, lo:hi])
        self.bytes_read += buf.nbytes
        return deserialize_tensor(buf.reshape(-1), e.float_type, d_out * ncols).reshape(d_out, ncols)

    def close(self):
        del self._mmap


class ModelFileWriter:
    """Sequential `.m` writer."""

    def __init__(self, f: BinaryIO, spec: ModelSpec):
        self.f = f
        self.spec = spec
        self.header_size = write_header(f, spec)
        self._layout = tensor_layout(dataclasses.replace(spec, header_size=self.header_size))
        self._next = 0

    def _take(self, name: str | None) -> TensorEntry:
        entry = self._layout[self._next]
        if name is not None and name != entry.name:
            raise ValueError(f"expected tensor {entry.name!r}, got {name!r}")
        return entry

    def write_tensor(self, array: np.ndarray, name: str | None = None) -> TensorEntry:
        """Encode and write the next tensor in layout order."""
        entry = self._take(name)
        if tuple(array.shape) != entry.shape and array.size != entry.n_values:
            raise ValueError(
                f"tensor {entry.name}: shape {array.shape} incompatible with {entry.shape}"
            )
        self.f.write(serialize_tensor(array, entry.float_type))
        self._next += 1
        return entry

    def write_raw(self, data: np.ndarray, name: str | None = None) -> TensorEntry:
        """Write the next tensor's already-encoded bytes (no quantize pass)."""
        entry = self._take(name)
        buf = np.ascontiguousarray(data, dtype=np.uint8)
        if buf.nbytes != entry.nbytes:
            raise ValueError(f"tensor {entry.name}: {buf.nbytes} bytes, expected {entry.nbytes}")
        self.f.write(buf.data)
        self._next += 1
        return entry

    def remaining(self) -> Iterator[TensorEntry]:
        return iter(self._layout[self._next :])

    def finish(self):
        if self._next != len(self._layout):
            missing = [e.name for e in self._layout[self._next :]]
            raise ValueError(f"model file incomplete, missing tensors: {missing[:5]}...")
