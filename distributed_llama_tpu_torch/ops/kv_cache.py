"""The single-stream KV cache: one fused [2, S, K, hd] leaf per layer.

Keys and values share a leading 2-axis, so each layer's K/V write is one
indexed copy. Unlike the JAX package, whose arrays are immutable and whose
donated leaves alias in place, the port writes the cache IN PLACE
(:func:`fused_update_rows` mutates its argument and returns it).

Only bf16 and f32 halves are ported; the int8 cache (``QuantizedKV``) is
later work.
"""

from __future__ import annotations

import torch


def init_fused(shape: tuple[int, ...], dtype: torch.dtype, device) -> torch.Tensor:
    """One fused per-layer leaf: keys+values as [2, *shape], zeroed."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype} not supported (bf16 or f32)")
    return torch.zeros((2,) + tuple(shape), dtype=dtype, device=device)


def fused_update_rows(leaf: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor, pos: int) -> torch.Tensor:
    """Write T tokens' keys and values ([T, K, hd] each) at slots
    pos..pos+T-1, in place. Returns ``leaf``."""
    T = k_rows.shape[0]
    leaf[0, pos : pos + T] = k_rows.to(leaf.dtype)
    leaf[1, pos : pos + T] = v_rows.to(leaf.dtype)
    return leaf


def slice_rows(half: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Cache slots [start, start+n) of one half (a view)."""
    return half[start : start + n]


def compute_dtype(half: torch.Tensor) -> torch.dtype:
    """The einsum operand dtype: the cache's storage dtype."""
    return half.dtype


def scores_einsum(qg: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """scores[t,k,m,s] = q[t,k,m,:] . key[s,k,:] with operands in the cache
    dtype and f32 accumulation (bf16 products are exact in f32)."""
    return torch.einsum("tkmh,skh->tkms", qg.to(torch.float32), keys.to(torch.float32))


def mix_einsum(weights: torch.Tensor, values: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """att[t,k,m,h] = sum_s w[t,k,m,s] * value[s,k,h]; the weights are
    rounded to the cache dtype first, products accumulate in f32."""
    return torch.einsum(
        "tkms,skh->tkmh", weights.to(cdt).to(torch.float32), values.to(torch.float32)
    )
