"""Synthetic `.m`/`.t` files: seeded random weights in the real file format.

Two writers:

* :func:`write_synthetic_model` quantizes seeded float weights (rms weights
  near 1, everything else ~N(0, 1/sqrt(d_in))) — the small models the tests
  run through both packages;
* :func:`write_random_q40_model` writes random Q40 blocks directly (random
  nibbles, f16 scales of a realistic magnitude) with no float quantize pass,
  so a file at full Llama-2-7B width is written in seconds.

And the converters' inputs: :func:`write_hf_checkpoint` lays `.m`-named
tensors out as a Hugging Face safetensors checkpoint (Q/K back in the neox
layout, split over several files with an index) and :func:`write_hf_tokenizer`
writes a ``tokenizer.json`` BPE vocabulary with its ``tokenizer_config.json``.
"""

from __future__ import annotations

import itertools
import json
import os

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


def mixtral_8x7b_spec(n_layers: int = 32, seq_len: int = 32768) -> ModelSpec:
    """Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
    config.json: dim 4096, hidden 14336, 32 heads, 8 kv heads, 8 experts, 2
    active, vocab 32000, rope theta 1e6, silu) with Q40 weights; the rope is
    the interleaved (Llama) one the converter writes for Mixtral."""
    return ModelSpec(
        arch_type=ArchType.MIXTRAL, dim=4096, hidden_dim=14336, n_layers=n_layers,
        n_heads=32, n_kv_heads=8, n_experts=8, n_active_experts=2, vocab_size=32000, seq_len=seq_len,
        hidden_act=HiddenAct.SILU, rope_theta=1000000.0, rope_type=RopeType.LLAMA,
        weights_float_type=FloatType.Q40,
    )


def grok1_spec(n_layers: int = 64, seq_len: int = 8192) -> ModelSpec:
    """Grok-1's published widths (xai-org/grok-1 run.py: emb 6144, ffn
    32768, 48 heads, 8 kv heads, 8 experts, 2 selected, vocab 131072,
    gelu) with Q40 weights; the header names no rope, so it resolves to
    the falcon/neox rope, as a converted Grok-1 file does."""
    return ModelSpec(
        arch_type=ArchType.GROK1, dim=6144, hidden_dim=32768, n_layers=n_layers,
        n_heads=48, n_kv_heads=8, n_experts=8, n_active_experts=2, vocab_size=131072, seq_len=seq_len,
        hidden_act=HiddenAct.GELU, rope_theta=10000.0, rope_type=RopeType.UNKNOWN,
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


def random_f16_tensors(spec: ModelSpec, seed: int = 0) -> dict[str, np.ndarray]:
    """Random float16 weights keyed by the `.m` layout names, shaped
    [d_out, d_in], drawn fast enough for full widths: matrix entries are
    f16 bit patterns of random sign and mantissa with a magnitude in
    [2^-7, 2^-5) (std ~0.012), norms 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {}
    for e in tensor_layout(spec):
        if _is_norm(e.name):
            out[e.name] = (1.0 + 0.1 * rng.standard_normal(e.shape, np.float32)).astype(np.float16)
        else:
            bits = rng.integers(0, 1 << 16, size=e.shape, dtype=np.uint16)
            out[e.name] = ((bits & 0x87FF) | 0x2000).view(np.float16)
    return out


def hf_config(spec: ModelSpec, model_type: str, **extra) -> dict:
    """A Hugging Face ``config.json`` describing ``spec`` (``extra`` adds or
    overrides fields)."""
    config = {
        "model_type": model_type,
        "hidden_size": spec.dim,
        "intermediate_size": spec.hidden_dim,
        "num_hidden_layers": spec.n_layers,
        "num_attention_heads": spec.n_heads,
        "num_key_value_heads": spec.n_kv_heads,
        "vocab_size": spec.vocab_size,
        "max_position_embeddings": spec.seq_len,
        "rms_norm_eps": 1e-5,
        "rope_theta": spec.rope_theta,
        "hidden_act": "gelu" if spec.hidden_act == HiddenAct.GELU else "silu",
        "tie_word_embeddings": False,
    }
    if spec.n_experts:
        experts = "num_experts" if model_type == "grok-1" else "num_local_experts"
        config.update({experts: spec.n_experts, "num_experts_per_tok": spec.n_active_experts})
    config.update(extra)
    return config


def write_hf_checkpoint(out_dir: str, spec: ModelSpec, tensors: dict[str, np.ndarray], config: dict,
                        n_files: int = 1, dtype=None) -> list[str]:
    """``tensors`` (keyed by `.m` names, Q/K in the interleaved rope layout)
    as a Hugging Face checkpoint in ``out_dir``: ``config.json``, the HF
    names in plan order split over ``n_files`` safetensors files (each
    tensor cast to ``dtype`` when given) and, for several files,
    ``model.safetensors.index.json``. Q/K go back to the neox layout that
    the converter permutes from (Grok-1 keeps its layout); a tied
    checkpoint holds no ``lm_head``. Returns the safetensors paths."""
    from distributed_llama_tpu_torch.converter.hf import hf_tensor_plan, unpermute_qk, write_safetensors

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    plan = [(m, h, p) for m, h, p in hf_tensor_plan(spec)
            if not (m == "wcls" and config.get("tie_word_embeddings"))]
    per_file = -(-len(plan) // n_files)
    paths, weight_map, total = [], {}, 0
    for i in range(n_files):
        name = "model.safetensors" if n_files == 1 else f"model-{i + 1:05d}-of-{n_files:05d}.safetensors"
        part = {}
        for m_name, hf_name, permute in plan[i * per_file : (i + 1) * per_file]:
            t = tensors[m_name]
            if permute:
                t = unpermute_qk(t, spec.n_heads if m_name.endswith(".q") else spec.n_kv_heads)
            part[hf_name] = t if dtype is None else np.asarray(t).astype(dtype)
            weight_map[hf_name] = name
            total += part[hf_name].nbytes
        paths.append(os.path.join(out_dir, name))
        write_safetensors(paths[-1], part, {"format": "pt"})
    if n_files > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return paths


CHATML_TEMPLATE = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + message['content'] "
                   "+ '<|im_end|>' + '\\n'}}{% endfor %}{% if add_generation_prompt %}"
                   "{{ '<|im_start|>assistant\\n' }}{% endif %}")


def hf_bpe_vocab(vocab_size: int) -> list[str]:
    """A byte-level BPE vocabulary of ``vocab_size`` pieces in the
    sentencepiece order the `.t` tokenizer's byte fallback expects:
    ``<unk>``, ``<s>``, ``</s>``, the 256 ``<0xNN>`` byte pieces, the
    printable ASCII characters, then merges (pairs, then triples, then
    quadruples of lowercase letters and space) up to the size."""
    alphabet = " abcdefghijklmnopqrstuvwxyz"
    pieces = itertools.chain(
        ["<unk>", "<s>", "</s>"], (f"<0x{b:02X}>" for b in range(256)), (chr(c) for c in range(0x20, 0x7F)), ["\n"],
        *(("".join(g) for g in itertools.product(alphabet, repeat=n)) for n in (2, 3, 4)))
    vocab = list(itertools.islice(pieces, vocab_size))
    if len(vocab) != vocab_size or vocab_size < 259:
        raise ValueError(f"vocab_size {vocab_size} is outside this generator's 259..{len(vocab)} pieces")
    return vocab


def write_hf_tokenizer(out_dir: str, vocab_size: int, chat_template: str | None = CHATML_TEMPLATE,
                       added: tuple[str, ...] = ("<|im_start|>", "<|im_end|>"), eos_token: str = "<|im_end|>",
                       bos_token: str = "<s>") -> None:
    """``tokenizer.json`` (a BPE model over :func:`hf_bpe_vocab`, the
    ``added`` tokens last) and ``tokenizer_config.json`` (fast tokenizer,
    the BOS/EOS names and the chat template) in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    base = hf_bpe_vocab(vocab_size - len(added))
    tok = {"version": "1.0", "model": {"type": "BPE", "vocab": {t: i for i, t in enumerate(base)}, "merges": []},
           "added_tokens": [{"id": len(base) + i, "content": t, "special": True} for i, t in enumerate(added)]}
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tok, f, ensure_ascii=False)
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": bos_token, "eos_token": eos_token}
    if chat_template is not None:
        cfg["chat_template"] = chat_template
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f, ensure_ascii=False)
