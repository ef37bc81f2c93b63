"""Synthetic `.m`/`.t` files: seeded random weights in the real file format.

Two writers:

* :func:`write_synthetic_model` quantizes seeded float weights (rms weights
  near 1, everything else ~N(0, 1/sqrt(d_in))) — the small models the tests
  run through both packages;
* :func:`write_random_q40_model` writes random Q40 blocks directly (random
  nibbles, f16 scales of a realistic magnitude) with no float quantize pass,
  so a file at full Llama-2-7B width is written in seconds.
"""

from __future__ import annotations

import numpy as np

from distributed_llama_tpu_torch.formats.model_file import (
    ArchType,
    HiddenAct,
    ModelFileWriter,
    ModelSpec,
    RopeType,
    tensor_layout,
)
from distributed_llama_tpu_torch.formats.tokenizer_file import TokenizerData
from distributed_llama_tpu_torch.quants import Q40_BLOCK_BYTES, QK, FloatType


def tiny_spec(**overrides) -> ModelSpec:
    """A CPU-friendly llama spec; override any field."""
    defaults = dict(
        arch_type=ArchType.LLAMA,
        dim=32,
        hidden_dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        vocab_size=64,
        seq_len=24,
        hidden_act=HiddenAct.SILU,
        rope_theta=10000.0,
        rope_type=RopeType.UNKNOWN,
        weights_float_type=FloatType.F32,
    )
    defaults.update(overrides)
    return ModelSpec(**defaults)


def llama2_7b_spec(n_layers: int = 32, seq_len: int = 4096) -> ModelSpec:
    """Llama-2-7B's published widths (dim 4096, hidden 11008, 32 heads,
    32 kv heads, vocab 32000, Llama rope) with Q40 weights."""
    return ModelSpec(
        arch_type=ArchType.LLAMA, dim=4096, hidden_dim=11008, n_layers=n_layers,
        n_heads=32, n_kv_heads=32, vocab_size=32000, seq_len=seq_len,
        hidden_act=HiddenAct.SILU, rope_theta=10000.0, rope_type=RopeType.LLAMA,
        weights_float_type=FloatType.Q40,
    )


def _is_norm(name: str) -> bool:
    return name.startswith("rms") or ".rms" in name


def random_tensors(spec: ModelSpec, seed: int = 0) -> dict[str, np.ndarray]:
    """Random float weights keyed by the `.m` layout names, shaped [d_out, d_in]."""
    rng = np.random.RandomState(seed)
    out: dict[str, np.ndarray] = {}
    for e in tensor_layout(spec):
        if _is_norm(e.name):
            t = 1.0 + 0.1 * rng.randn(*e.shape)
        else:
            t = rng.randn(*e.shape) / np.sqrt(e.shape[-1])
        out[e.name] = t.astype(np.float32)
    return out


def write_model_file(path: str, spec: ModelSpec, tensors: dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        w = ModelFileWriter(f, spec)
        for e in w.remaining():
            w.write_tensor(tensors[e.name], e.name)
        w.finish()


def write_synthetic_model(path: str, spec: ModelSpec, seed: int = 0) -> str:
    write_model_file(path, spec, random_tensors(spec, seed=seed))
    return path


def random_q40_bytes(rng: np.random.Generator, d_out: int, d_in: int) -> np.ndarray:
    """File-form Q40 bytes of a [d_out, d_in] matrix: uniform random nibbles
    and f16 scales drawn so that each dequantized weight has a standard
    deviation near 1/sqrt(d_in) (a uniform nibble has std ~4.6 about 8)."""
    n_blocks = d_out * d_in // QK
    raw = rng.integers(0, 256, size=(n_blocks, Q40_BLOCK_BYTES), dtype=np.uint8)
    scale = 1.0 / (4.6 * np.sqrt(d_in))
    scales = (scale * rng.uniform(0.5, 1.5, size=n_blocks)).astype(np.float16)
    raw[:, :2] = scales.view(np.uint8).reshape(n_blocks, 2)
    return raw


def write_random_q40_model(path: str, spec: ModelSpec, seed: int = 0) -> str:
    """A Q40 `.m` file of random blocks (no float quantize pass)."""
    if spec.weights_float_type != FloatType.Q40:
        raise ValueError("write_random_q40_model writes Q40 weights only")
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        w = ModelFileWriter(f, spec)
        for e in list(w.remaining()):
            if e.float_type == FloatType.Q40:
                w.write_raw(random_q40_bytes(rng, *e.shape), e.name)
            elif _is_norm(e.name):
                w.write_tensor(1.0 + 0.1 * rng.standard_normal(e.shape, np.float32), e.name)
            else:
                w.write_tensor(rng.standard_normal(e.shape, np.float32) * 0.02, e.name)
        w.finish()
    return path


def synthetic_tokenizer_data(vocab_size: int | None = None) -> TokenizerData:
    """A sentencepiece-style vocab with full byte fallback: <unk>/<s>/</s>,
    256 byte tokens, a few merge-scored words. ``vocab_size`` pads it with
    unique filler pieces up to a model's vocab size."""
    vocab: list[bytes] = [b"<unk>", b"<s>", b"</s>"]
    scores: list[float] = [0.0, 0.0, 0.0]
    for b in range(256):
        vocab.append(f"<0x{b:02X}>".encode())
        scores.append(0.0)
    for tok, score in (
        (b" ", -1.0), (b"h", -2.0), (b"e", -2.0), (b"l", -2.0),
        (b"o", -2.0), (b"he", -3.0), (b"ll", -4.0), (b"hell", -5.0),
        (b"hello", -6.0), (b" hello", -7.0), (b"w", -2.0), (b"r", -2.0),
        (b"d", -2.0), (b"wo", -3.0), (b"wor", -4.0), (b"worl", -5.0),
        (b"world", -6.5), (b" world", -7.5),
    ):
        vocab.append(tok)
        scores.append(score)
    if vocab_size is not None:
        if vocab_size < len(vocab):
            raise ValueError(f"vocab_size {vocab_size} < base vocab {len(vocab)}")
        for i in range(vocab_size - len(vocab)):
            vocab.append(f" tok{i}".encode())
            scores.append(-100.0 - i)
    return TokenizerData(vocab=vocab, scores=scores, bos_id=1, eos_id=2, chat_eos_id=2)
