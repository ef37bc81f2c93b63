"""Block quantization formats Q40 and Q80 (the `.m` file's block layout).

The port's own copy of the file-format half of the JAX package's
``quants`` module: the same bytes, the same quantization math. Host-side
numpy, and the C++ host library (:mod:`native`) for the f32 read of a Q40
tensor, whose numpy version :func:`dequantize_q40` is the plain one; the
device layout lives in :mod:`ops.q40`.

Q40: blocks of 32 values; delta = signed absmax / -8 stored as f16;
q = clip(floor(x/delta + 8.5), 0, 15); byte j packs value j in the low
nibble and value j+16 in the high nibble; dequant = (nibble - 8) * delta.

Q80: blocks of 32 values; delta = absmax / 127 stored as f16;
q = round(x/delta) as int8; dequant = q * delta.
"""

from __future__ import annotations

import enum

import numpy as np

from distributed_llama_tpu_torch import native

QK = 32  # block size shared by Q40 and Q80
Q40_BLOCK_BYTES = 2 + QK // 2  # f16 scale + 16 packed nibble bytes
Q80_BLOCK_BYTES = 2 + QK  # f16 scale + 32 int8


class FloatType(enum.IntEnum):
    """On-disk tensor dtypes."""

    F32 = 0
    F16 = 1
    Q40 = 2
    Q80 = 3

    @property
    def short_name(self) -> str:
        return self.name.lower()


FLOAT_TYPE_BY_NAME = {t.short_name: t for t in FloatType}


def parse_float_type(name: str) -> FloatType:
    """"f32" | "f16" | "q40" | "q80" (any case) -> FloatType."""
    try:
        return FLOAT_TYPE_BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(f"unsupported float type: {name!r}") from None


def tensor_bytes(float_type: FloatType, n_values: int) -> int:
    """Serialized size of a flat tensor."""
    if float_type == FloatType.F32:
        return n_values * 4
    if float_type == FloatType.F16:
        return n_values * 2
    if n_values % QK != 0:
        raise ValueError(f"quantized tensor length {n_values} not divisible by {QK}")
    n_blocks = n_values // QK
    if float_type == FloatType.Q40:
        return n_blocks * Q40_BLOCK_BYTES
    if float_type == FloatType.Q80:
        return n_blocks * Q80_BLOCK_BYTES
    raise ValueError(f"unsupported float type: {float_type}")


def quantize_q40(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Float array -> (qs uint8 [..., n/32, 16], scales f16 [..., n/32])."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[-1]
    if n % QK != 0:
        raise ValueError(f"last dim {n} not divisible by {QK}")
    groups = x.reshape(*x.shape[:-1], n // QK, QK)
    gmax = groups.max(axis=-1)
    gmin = groups.min(axis=-1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = np.clip(groups * inv[..., None] + 8.5, 0, 15).astype(np.int32)
    lo = q[..., : QK // 2] & 0xF
    hi = (q[..., QK // 2 :] & 0xF) << 4
    qs = (lo | hi).astype(np.uint8)
    return qs, deltas.astype(np.float16)


def dequantize_q40(qs: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_q40` -> float32 [..., n]."""
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=-1).astype(np.float32)
    vals *= np.asarray(scales, dtype=np.float32)[..., None]
    return vals.reshape(*vals.shape[:-2], vals.shape[-2] * QK)


def q40_to_bytes(qs: np.ndarray, scales: np.ndarray) -> bytes:
    """Serialize to the block-interleaved file form (scale, then 16 bytes)."""
    n_blocks = scales.size
    out = np.empty((n_blocks, Q40_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = scales.reshape(-1).astype(np.float16).view(np.uint8).reshape(n_blocks, 2)
    out[:, 2:] = qs.reshape(n_blocks, QK // 2)
    return out.tobytes()


def q40_from_bytes(buf: bytes | np.ndarray, n_values: int) -> tuple[np.ndarray, np.ndarray]:
    """Parse a file-form Q40 array into ``(qs [n/32, 16], scales f16 [n/32])``."""
    if n_values % QK != 0:
        raise ValueError(f"length {n_values} not divisible by {QK}")
    n_blocks = n_values // QK
    raw = np.frombuffer(buf, dtype=np.uint8, count=n_blocks * Q40_BLOCK_BYTES)
    raw = raw.reshape(n_blocks, Q40_BLOCK_BYTES)
    scales = raw[:, :2].copy().view(np.float16).reshape(n_blocks)
    qs = raw[:, 2:].copy()
    return qs, scales


def quantize_q80(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Float array -> (int8 [..., n/32, 32], f16 scales [..., n/32])."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[-1]
    if n % QK != 0:
        raise ValueError(f"last dim {n} not divisible by {QK}")
    groups = x.reshape(*x.shape[:-1], n // QK, QK)
    absmax = np.abs(groups).max(axis=-1)
    deltas = absmax / 127.0
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = np.round(groups * inv[..., None]).astype(np.int8)
    return q, deltas.astype(np.float16)


def dequantize_q80(qs: np.ndarray, scales: np.ndarray) -> np.ndarray:
    vals = qs.astype(np.float32) * np.asarray(scales, dtype=np.float32)[..., None]
    return vals.reshape(*vals.shape[:-2], vals.shape[-2] * QK)


def q80_to_bytes(qs: np.ndarray, scales: np.ndarray) -> bytes:
    n_blocks = scales.size
    out = np.empty((n_blocks, Q80_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = scales.reshape(-1).astype(np.float16).view(np.uint8).reshape(n_blocks, 2)
    out[:, 2:] = qs.reshape(n_blocks, QK).view(np.uint8)
    return out.tobytes()


def q80_from_bytes(buf: bytes | np.ndarray, n_values: int) -> tuple[np.ndarray, np.ndarray]:
    if n_values % QK != 0:
        raise ValueError(f"length {n_values} not divisible by {QK}")
    n_blocks = n_values // QK
    raw = np.frombuffer(buf, dtype=np.uint8, count=n_blocks * Q80_BLOCK_BYTES)
    raw = raw.reshape(n_blocks, Q80_BLOCK_BYTES)
    scales = raw[:, :2].copy().view(np.float16).reshape(n_blocks)
    qs = raw[:, 2:].copy().view(np.int8)
    return qs, scales


def serialize_tensor(x: np.ndarray, float_type: FloatType) -> bytes:
    """Flatten + encode a tensor the way the `.m` writer stores it."""
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    if float_type == FloatType.F32:
        return flat.tobytes()
    if float_type == FloatType.F16:
        return flat.astype(np.float16).tobytes()
    if float_type == FloatType.Q40:
        return q40_to_bytes(*quantize_q40(flat))
    if float_type == FloatType.Q80:
        return q80_to_bytes(*quantize_q80(flat))
    raise ValueError(f"unsupported float type: {float_type}")


def deserialize_tensor(buf: bytes | np.ndarray, float_type: FloatType, n_values: int) -> np.ndarray:
    """Decode a serialized tensor back to float32 (flat)."""
    if float_type == FloatType.F32:
        return np.frombuffer(buf, dtype=np.float32, count=n_values).copy()
    if float_type == FloatType.F16:
        return np.frombuffer(buf, dtype=np.float16, count=n_values).astype(np.float32)
    if float_type == FloatType.Q40:
        if n_values % QK != 0:
            raise ValueError(f"length {n_values} not divisible by {QK}")
        raw = np.frombuffer(buf, dtype=np.uint8, count=tensor_bytes(float_type, n_values))
        return native.q40_dequant_f32(raw, n_values)
    if float_type == FloatType.Q80:
        return dequantize_q80(*q80_from_bytes(buf, n_values))
    raise ValueError(f"unsupported float type: {float_type}")
