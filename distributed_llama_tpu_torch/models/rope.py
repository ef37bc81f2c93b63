"""Rotary position embeddings: llama (interleaved pairs), falcon (neox
halves), llama-3.1 (frequency scaling).

The cos/sin table is built once on the host in float64 and stored as f32
[seq_len, head_size/2, 2]; the forward gathers its rows by position.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distributed_llama_tpu_torch.formats.model_file import RopeType
from distributed_llama_tpu_torch.models.config import LlamaConfig


def _llama3_scale_freqs(freqs: np.ndarray, cfg: LlamaConfig) -> np.ndarray:
    """Llama 3.1 NTK-by-parts frequency scaling."""
    factor = cfg.rope_scaling_factor
    low = cfg.rope_scaling_low_freq_factor
    high = cfg.rope_scaling_high_freq_factor
    orig = cfg.rope_scaling_orig_max_seq_len
    if factor == 0 or orig == 0:
        return freqs
    wavelen = 2.0 * math.pi / freqs
    low_wavelen = orig / low
    high_wavelen = orig / high
    scaled = np.where(wavelen > low_wavelen, freqs / factor, freqs)
    smooth = (orig / wavelen - low) / (high - low)
    smoothed = (1 - smooth) * freqs / factor + smooth * freqs
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(mid, smoothed, scaled).astype(freqs.dtype)


def build_rope_table(cfg: LlamaConfig) -> np.ndarray:
    """[seq_len, head_size/2, 2] (cos, sin) in float32."""
    half = cfg.head_size // 2
    j = np.arange(half, dtype=np.float64)
    freqs = 1.0 / (cfg.rope_theta ** (2.0 * j / cfg.head_size))
    if cfg.rope_type == RopeType.LLAMA3_1 and not cfg.rope_llama3_reference_quirk:
        freqs = _llama3_scale_freqs(freqs.astype(np.float64), cfg)
    pos = np.arange(cfg.seq_len, dtype=np.float64)
    angles = pos[:, None] * freqs[None, :]
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def _reference_llama3_value_scale(v: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """The reference runtime's Llama-3.1 scale applied to rotated values."""
    factor = cfg.rope_scaling_factor
    low = cfg.rope_scaling_low_freq_factor
    high = cfg.rope_scaling_high_freq_factor
    orig = cfg.rope_scaling_orig_max_seq_len
    wave_len = 2.0 * math.pi * v
    smooth = (orig / wave_len - low) / (high - low)
    smoothed = (1 - smooth) * v / factor + smooth * v
    return torch.where(
        wave_len < orig / high, v, torch.where(wave_len > orig / low, v / factor, smoothed)
    )


def apply_rope_interleaved(x: torch.Tensor, table_slice: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Rotate interleaved pairs. ``x`` [T, n_heads, head_size];
    ``table_slice`` [T, head_size/2, 2]."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], cfg.head_size // 2, 2)
    cos = table_slice[:, None, :, 0]
    sin = table_slice[:, None, :, 1]
    v0, v1 = xp[..., 0], xp[..., 1]
    r0 = v0 * cos - v1 * sin
    r1 = v0 * sin + v1 * cos
    if cfg.rope_type == RopeType.LLAMA3_1 and cfg.rope_llama3_reference_quirk:
        r0 = _reference_llama3_value_scale(r0, cfg)
        r1 = _reference_llama3_value_scale(r1, cfg)
    return torch.stack([r0, r1], dim=-1).reshape(shape)


def apply_rope_neox(x: torch.Tensor, table_slice: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Falcon/neox rotation of pairs (j, j+half)."""
    half = cfg.head_size // 2
    v0, v1 = x[..., :half], x[..., half:]
    cos = table_slice[:, None, :, 0]
    sin = table_slice[:, None, :, 1]
    return torch.cat([v0 * cos - v1 * sin, v0 * sin + v1 * cos], dim=-1)


def apply_rope(x: torch.Tensor, table_slice: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    if cfg.rope_type == RopeType.FALCON:
        return apply_rope_neox(x, table_slice, cfg)
    return apply_rope_interleaved(x, table_slice, cfg)
