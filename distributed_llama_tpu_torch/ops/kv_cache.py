"""KV caches: the single-stream [2, S, K, hd] leaf, the batched slab
[2, B_max, S, K, hd] leaf, and the prefix cache's page pool.

Keys and values share a leading 2-axis, so each layer's K/V write is one
indexed copy. Unlike the JAX package, whose arrays are immutable and whose
donated leaves alias in place, the port writes caches IN PLACE: the update
helpers mutate their argument, a slab row is a view of the slab
(:func:`slab_row`, replacing the JAX ``fused_take_row``/``fused_put_row``
pair), and a publish writes pool pages in place.

The page pool holds immutable prefix pages, one [P, page, K, hd] tensor per
half and layer; a row reads its matched prefix through a page table of pool
page ids (``tables``), the same bytes the row would hold after a copy.

Only bf16 and f32 halves are ported; the int8 cache (``QuantizedKV``) is
later work.
"""

from __future__ import annotations

import torch

from distributed_llama_tpu_torch.platform import to_device


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


# ---------------------------------------------------------------------------
# Batched slab [2, B_max, S, K, hd]
# ---------------------------------------------------------------------------


def write_index(slots, S: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Device (rows, slots) index tensors of a batched write from the host
    slots ``slots[b]``: rows whose slot is >= S (inactive rows, the JAX
    package's dropped writes) are left out."""
    keep = [(b, int(s)) for b, s in enumerate(slots) if 0 <= int(s) < S]
    idx = to_device([[b for b, _ in keep], [s for _, s in keep]], device, torch.int64)
    return idx[0], idx[1]


def fused_update_row_batched(leaf: torch.Tensor, k_rows: torch.Tensor, v_rows: torch.Tensor,
                             write: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Batched decode write, in place: row ``rows[j]``'s key and value
    ([B, K, hd] inputs) land at slab slot ``slots[j]`` of that row, in one
    indexed copy; ``write = (rows, slots)`` from :func:`write_index`."""
    rows, slots = write
    leaf[:, rows, slots] = torch.stack([k_rows[rows], v_rows[rows]]).to(leaf.dtype)
    return leaf


def slab_row(leaf: torch.Tensor, row: int) -> torch.Tensor:
    """Slab row ``row`` as a single-stream [2, S, K, hd] leaf: a view, so
    the single-stream forward writes the slab in place."""
    return leaf[:, row]


def slice_rows_batched(half: torch.Tensor, start: int, n: int, rows: int | None = None) -> torch.Tensor:
    """Slots [start, start+n) of the first ``rows`` slab rows (a view)."""
    return half[: half.shape[0] if rows is None else rows, start : start + n]


# ---------------------------------------------------------------------------
# Page pool [P, page, K, hd] per half
# ---------------------------------------------------------------------------


def init_page_pool_half(n_pages: int, page: int, kl: int, hd: int, dtype: torch.dtype, device) -> torch.Tensor:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype} not supported (bf16 or f32)")
    return torch.zeros((n_pages, page, kl, hd), dtype=dtype, device=device)


def pool_page_size(pool_half: torch.Tensor) -> int:
    return pool_half.shape[1]


def gather_pool_pages(pool_half: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Pool pages ``ids`` [..., n] -> [..., n*page, K, hd]."""
    v = pool_half[ids.to(torch.int64)]
    return v.reshape(v.shape[:-4] + (-1,) + v.shape[-2:])


def _table_window(n_table: int, i: int, ppc: int) -> int:
    """Start of chunk ``i``'s page-table window, clamped into the table (as
    the JAX package's dynamic_slice clamps it)."""
    return min(max(i * ppc, 0), n_table - ppc)


def pool_chunk(pool_half: torch.Tensor, tables: torch.Tensor, i: int, pages_per_chunk: int) -> torch.Tensor:
    """Chunk ``i`` of every row read through its page table: pages
    ``tables[:, i*ppc : (i+1)*ppc]`` -> [B, ppc*page, K, hd]."""
    base = _table_window(tables.shape[1], i, pages_per_chunk)
    return gather_pool_pages(pool_half, tables[:, base : base + pages_per_chunk])


def pool_chunk_row(pool_half: torch.Tensor, table: torch.Tensor, i: int, pages_per_chunk: int) -> torch.Tensor:
    """Single-row :func:`pool_chunk`: ``table`` [n_table] -> [ppc*page, K, hd]."""
    base = _table_window(table.shape[0], i, pages_per_chunk)
    return gather_pool_pages(pool_half, table[base : base + pages_per_chunk])


def select_kv(sel: torch.Tensor, pool_kv: torch.Tensor, slab_kv: torch.Tensor) -> torch.Tensor:
    """Per-position source select: ``sel`` [..., n] True takes the pool byte."""
    return torch.where(sel[..., None, None], pool_kv, slab_kv)


def virtual_row(half: torch.Tensor, pool_half: torch.Tensor, table: torch.Tensor, matched: int) -> torch.Tensor:
    """[S, K, hd] view of one row: pool bytes below ``matched``, the slab
    row beyond (materialized; the small-cache fallback's read)."""
    S = half.shape[0]
    pooled = gather_pool_pages(pool_half, table)[:S]
    return select_kv(torch.arange(S, device=half.device) < matched, pooled, half)


def virtual_rows_batched(half_b: torch.Tensor, pool_half: torch.Tensor, tables: torch.Tensor,
                         matched: torch.Tensor) -> torch.Tensor:
    """Batched :func:`virtual_row` with per-row tables and matched lengths."""
    S = half_b.shape[1]
    pooled = gather_pool_pages(pool_half, tables)[:, :S]
    sel = torch.arange(S, device=half_b.device)[None, :] < matched.to(half_b.device)[:, None]
    return select_kv(sel, pooled, half_b)


def publish_row_pages(pool_half: torch.Tensor, slab_half: torch.Tensor, row: int, src_page, page_ids,
                      page: int) -> torch.Tensor:
    """Copy slab row ``row``'s page slots ``src_page[i]`` into pool pages
    ``page_ids[i]``, in place (the prefix-cache publish). Host sequences;
    ids at or beyond P are dropped."""
    P = pool_half.shape[0]
    keep = [(int(s), int(p)) for s, p in zip(src_page, page_ids) if int(p) < P]
    if not keep:
        return pool_half
    dev = pool_half.device
    slots = to_device([s * page + j for s, _ in keep for j in range(page)], dev, torch.int64)
    ids = to_device([p for _, p in keep], dev, torch.int64)
    vals = slab_half[row, slots]
    pool_half[ids] = vals.reshape((len(keep), page) + vals.shape[1:])
    return pool_half


# ---------------------------------------------------------------------------
# Batched and verify einsums (operands as in scores_einsum / mix_einsum)
# ---------------------------------------------------------------------------


def scores_einsum_batched(qg: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """scores[b,k,m,s] = q[b,k,m,:] . key[b,s,k,:]: each row scores only its
    own cache row."""
    return torch.einsum("bkmh,bskh->bkms", qg.to(torch.float32), keys.to(torch.float32))


def mix_einsum_batched(weights: torch.Tensor, values: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """att[b,k,m,h] = sum_s w[b,k,m,s] * v[b,s,k,h], weights rounded to the
    cache dtype first."""
    return torch.einsum("bkms,bskh->bkmh", weights.to(cdt).to(torch.float32), values.to(torch.float32))


def scores_einsum_verify(qg: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Verify-window scores[b,t,k,m,s] = q[b,t,k,m,:] . key[b,s,k,:]."""
    return torch.einsum("btkmh,bskh->btkms", qg.to(torch.float32), keys.to(torch.float32))


def mix_einsum_verify(weights: torch.Tensor, values: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Verify-window att[b,t,k,m,h] = sum_s w[b,t,k,m,s] * v[b,s,k,h]."""
    return torch.einsum("btkms,bskh->btkmh", weights.to(cdt).to(torch.float32), values.to(torch.float32))
