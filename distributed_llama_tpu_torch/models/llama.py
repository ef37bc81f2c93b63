"""Llama-family transformer forward over one stream (dense models).

The layer loop is unrolled over a list of per-layer parameter dicts; each
layer's KV cache leaf is written in place. Numerical conventions follow the
JAX package: rmsnorm eps 1e-5 added to the mean square, scores scaled by
1/sqrt(head_size), SwiGLU silu(w1 x) * (w3 x) then w2, all matmuls with f32
accumulation. Q40 weights route to the hand-written kernels through
:func:`ops.q40.q40_matmul` / :func:`ops.q40.rmsnorm_q40_matmul`: four
launches per layer (qkv, wo, gate_up, down) and one for ``wcls``.

Positions are host ints throughout, so no step reads back from the device
to decide a shape or a chunk bound.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from distributed_llama_tpu_torch.formats.model_file import HiddenAct
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.models.rope import apply_rope
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.ops.q40 import (
    QuantizedMatrix,
    _true_f32_matmul,
    q40_matmul,
    rmsnorm_q40_matmul,
    rmsnorm_ref,
)

Params = dict[str, Any]

# key-axis chunk of the blocked attention: caches whose seq_len is a
# multiple of it use the online-softmax path; smaller/odd caches keep the
# full-S masked softmax. T > 8 keeps the full-S path below
# ATT_BLOCK_PREFILL_S (the JAX package's branch rule, kept so both packages
# take the same branch).
ATT_CHUNK = 512
ATT_BLOCK_PREFILL_S = 4096


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rmsnorm_ref(x, weight, eps)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """exp(x - max) / sum, with a true division (the JAX formula)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _activation(x: torch.Tensor, act: HiddenAct) -> torch.Tensor:
    if act == HiddenAct.GELU:
        return torch.nn.functional.gelu(x, approximate="tanh")
    return x * torch.sigmoid(x)


def _matmul(x: torch.Tensor, w, path: str = "int8") -> torch.Tensor:
    """x [T, n] @ w [n, d] with f32 accumulation. ``w`` is a plain tensor
    (bf16/f32; bf16 products are exact in f32) or a Q40 QuantizedMatrix."""
    if isinstance(w, QuantizedMatrix):
        return q40_matmul(x, w, path)
    return _true_f32_matmul(x.to(torch.float32), w.to(torch.float32))


def _norm_matmul(x: torch.Tensor, weight: torch.Tensor, w, path: str = "int8") -> torch.Tensor:
    """rmsnorm(x, weight) @ w."""
    if isinstance(w, QuantizedMatrix):
        return rmsnorm_q40_matmul(x, weight, w, path=path)
    return _matmul(rmsnorm(x, weight).to(w.dtype), w, path)


def project_qkv(cfg: LlamaConfig, lp: Params, x: torch.Tensor, rope_rows: torch.Tensor, path: str = "int8"):
    """Norm + QKV projection + rope: [T, dim] -> (q [T, H, hd], k [T, K, hd],
    v [T, K, hd])."""
    T = x.shape[0]
    hd = cfg.head_size
    if "qkv" in lp:
        fused = _norm_matmul(x, lp["rms_att"], lp["qkv"], path)
        d_q = lp["wo"].shape[-2]
        d_kv = (fused.shape[-1] - d_q) // 2
        q, k, v = fused[:, :d_q], fused[:, d_q : d_q + d_kv], fused[:, d_q + d_kv :]
    else:
        xc = rmsnorm(x, lp["rms_att"]).to(lp["q"].dtype)
        q, k, v = (_matmul(xc, lp[n], path) for n in ("q", "k", "v"))
    H, K = q.shape[-1] // hd, k.shape[-1] // hd
    q = apply_rope(q.reshape(T, H, hd), rope_rows, cfg)
    k = apply_rope(k.reshape(T, K, hd), rope_rows, cfg)
    return q, k, v.reshape(T, K, hd)


def embed(cfg: LlamaConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens].to(torch.float32)


def attention(cfg: LlamaConfig, x: torch.Tensor, lp: Params, cache_l: torch.Tensor, pos: int,
              rope_rows: torch.Tensor, path: str = "int8"):
    """Causal GQA attention for T tokens at positions pos..pos+T-1 over the
    fused [2, S, K, hd] leaf (written in place). Returns (mix [T, H*hd],
    cache_l)."""
    T = x.shape[0]
    S = cache_l.shape[1]
    hd = cfg.head_size
    q, k, v = project_qkv(cfg, lp, x, rope_rows, path)
    H, K = q.shape[1], k.shape[1]
    cache_l = kvc.fused_update_rows(cache_l, k, v, pos)
    keys, values = cache_l[0], cache_l[1]
    cdt = kvc.compute_dtype(keys)
    qg = q.reshape(T, K, H // K, hd).to(cdt)
    use_blocked = S % ATT_CHUNK == 0 and S > ATT_CHUNK and (T <= 8 or S >= ATT_BLOCK_PREFILL_S)
    if use_blocked:
        from distributed_llama_tpu_torch.ops.attention import blocked_attention

        att = blocked_attention(qg.to(torch.float32), keys, values, pos, ATT_CHUNK)
        return att.to(torch.float32).reshape(T, H * hd), cache_l
    scores = kvc.scores_einsum(qg, keys) / math.sqrt(hd)
    t_idx = pos + torch.arange(T, device=x.device)[:, None]
    s_idx = torch.arange(S, device=x.device)[None, :]
    scores = torch.where((s_idx <= t_idx)[:, None, None, :], scores, float("-inf"))
    att = kvc.mix_einsum(softmax(scores, dim=-1), values, cdt).reshape(T, H * hd)
    return att, cache_l


def ffn(cfg: LlamaConfig, x: torch.Tensor, lp: Params, path: str = "int8") -> torch.Tensor:
    """SwiGLU FFN."""
    if "gate_up" in lp:
        fused = _norm_matmul(x, lp["rms_ffn"], lp["gate_up"], path)
        hidden = fused.shape[-1] // 2
        h = _activation(fused[:, :hidden], cfg.hidden_act) * fused[:, hidden:]
    else:
        xn = rmsnorm(x, lp["rms_ffn"]).to(lp["gate"].dtype)
        h = _activation(_matmul(xn, lp["gate"], path), cfg.hidden_act) * _matmul(xn, lp["up"], path)
    return _matmul(h.to(lp["down"].dtype), lp["down"], path)


def block_tail(cfg: LlamaConfig, x: torch.Tensor, att: torch.Tensor, lp: Params, path: str = "int8") -> torch.Tensor:
    """wo projection, residual, FFN, residual."""
    out = _matmul(att.to(lp["wo"].dtype), lp["wo"], path)
    x = x + out.to(x.dtype)
    return x + ffn(cfg, x, lp, path).to(x.dtype)


def block_forward(cfg, x, lp, cache_l, pos: int, rope_rows, path: str = "int8"):
    att, cache_l = attention(cfg, x, lp, cache_l, pos, rope_rows, path)
    return block_tail(cfg, x, att, lp, path), cache_l


def final_logits(cfg: LlamaConfig, params: Params, x: torch.Tensor, path: str = "int8") -> torch.Tensor:
    return _norm_matmul(x, params["rms_final"], params["wcls"], path)


def forward_tokens(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, cache: list, pos: int,
                   path: str = "int8"):
    """Run T tokens (int [T] on the params' device) from absolute position
    ``pos``. ``cache`` is the per-layer list of fused leaves, updated in
    place. Returns (logits f32 [T, vocab], cache)."""
    T = tokens.shape[0]
    x = embed(cfg, params, tokens)
    rope_rows = params["rope_table"][pos : pos + T]
    for l, lp in enumerate(params["layers"]):
        x, cache[l] = block_forward(cfg, x, lp, cache[l], pos, rope_rows, path)
    return final_logits(cfg, params, x, path), cache


def init_cache(cfg: LlamaConfig, dtype: torch.dtype, device) -> list:
    """Per-layer fused [2, S, K, hd] cache leaves (the JAX package's
    ``layered=True`` layout, the only one ported)."""
    shape = (cfg.seq_len, cfg.n_kv_heads, cfg.head_size)
    return [kvc.init_fused(shape, dtype, device) for _ in range(cfg.n_layers)]
