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

The int8 cache (``cache dtype "i8"``) stores each half as a
:class:`QuantizedKV`: int8 rows and per-(slot, head) f32 scales with a
trailing unit axis, quantized on write (:func:`quantize_rows`). Every helper
here takes either kind of half. Reads never dequantize: the score einsum
multiplies the bf16-rounded queries by the int8 values (each product exact
in f32) and applies the slot's key scale after the dot; the value mix folds
the slot's value scale into the softmax weight before rounding it to bf16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_llama_tpu_torch.platform import to_device

I8_SENTINELS = ("i8", "int8")


@dataclasses.dataclass
class QuantizedKV:
    """One int8 cache half (or a fused leaf of both halves on a leading
    2-axis): ``data`` int8 [..., K, hd] and ``scales`` f32 [..., K, 1].
    Indexing slices both tensors (views), so ``leaf[0]``/``leaf[1]`` and
    ``keys, values = leaf`` work as for a plain tensor leaf."""

    data: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.data.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __getitem__(self, idx) -> "QuantizedKV":
        return QuantizedKV(self.data[idx], self.scales[idx])

    def __iter__(self):
        return iter((self[0], self[1]))

    def contiguous(self) -> "QuantizedKV":
        return QuantizedKV(self.data.contiguous(), self.scales.contiguous())


def is_quantized_cache_dtype(dtype) -> bool:
    return isinstance(dtype, str) and dtype in I8_SENTINELS


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, hd] -> (int8 [..., K, hd], f32 scales [..., K, 1]),
    symmetric per (row, head): scale = max(amax, 1e-8) / 127, q =
    clip(round_half_even(x / scale), -127, 127), the JAX package's op
    order with true divisions, so values and scales are bit-identical."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which can differ in the last bit
    scales = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(xf / scales), -127, 127).to(torch.int8), scales


def _store(half, rows: torch.Tensor):
    """``rows`` in the storage of ``half``: (int8, scales) for a quantized
    half, else the rows cast to its dtype."""
    if isinstance(half, QuantizedKV):
        return quantize_rows(rows)
    return rows.to(half.dtype)


def _set(dst, idx, val) -> None:
    """``dst[idx] = val`` for a plain tensor, or for a quantized half with
    ``val`` = (int8 rows, scales)."""
    if isinstance(dst, QuantizedKV):
        dst.data[idx] = val[0]
        dst.scales[idx] = val[1]
    else:
        dst[idx] = val


def init_fused(shape: tuple[int, ...], dtype, device):
    """One fused per-layer leaf: keys+values as [2, *shape], zeroed (a
    :class:`QuantizedKV` with [2, *shape[:-1], 1] scales for "i8")."""
    if is_quantized_cache_dtype(dtype):
        full = (2,) + tuple(shape)
        return QuantizedKV(torch.zeros(full, dtype=torch.int8, device=device),
                           torch.zeros(full[:-1] + (1,), dtype=torch.float32, device=device))
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype} not supported (bf16, f32 or i8)")
    return torch.zeros((2,) + tuple(shape), dtype=dtype, device=device)


def fused_update_rows(leaf, k_rows: torch.Tensor, v_rows: torch.Tensor, pos: int):
    """Write T tokens' keys and values ([T, K, hd] each) at slots
    pos..pos+T-1, in place (quantized for an i8 leaf). Returns ``leaf``."""
    T = k_rows.shape[0]
    _set(leaf[0], slice(pos, pos + T), _store(leaf, k_rows))
    _set(leaf[1], slice(pos, pos + T), _store(leaf, v_rows))
    return leaf


def scatter_rows(leaf, slots, k_rows: torch.Tensor, v_rows: torch.Tensor):
    """Masked scatter of T tokens' keys and values ([T, K, hd] each) into a
    fused leaf, in place: row t lands at slot ``slots[t]`` (host ints). A
    slot outside [0, S) drops its row, as the JAX package's ``mode="drop"``
    scatter does with its out-of-bounds sentinel: the rows are filtered on
    the host, so no index tensor ever holds an out-of-range slot (torch's
    indexed copy raises on one on the CPU and asserts on the card). Returns
    ``leaf``."""
    S = leaf.shape[1]
    keep = [(t, int(s)) for t, s in enumerate(slots) if 0 <= int(s) < S]
    if not keep:
        return leaf
    idx = to_device([[t for t, _ in keep], [s for _, s in keep]], k_rows.device, torch.int64)
    rows, dst = idx[0], idx[1]
    _set(leaf, (slice(None), dst), _store(leaf, torch.stack([k_rows[rows], v_rows[rows]])))
    return leaf


def select_row_update(leaf, k_row: torch.Tensor, v_row: torch.Tensor, lpos: int, owner: bool):
    """Owner-masked single-row write of one token's key and value ([1, K, hd]
    each) at slot ``lpos``, in place: the leaf of the rank that owns the
    position takes the row, every other rank's leaf keeps its bytes (the
    JAX package's every-shard write of the row a non-owner already had).
    Returns ``leaf``."""
    if owner:
        fused_update_rows(leaf, k_row, v_row, lpos)
    return leaf


def slice_rows(half, start: int, n: int):
    """Cache slots [start, start+n) of one half (a view)."""
    return half[start : start + n]


def compute_dtype(half) -> torch.dtype:
    """The einsum operand dtype: the cache's storage dtype, bf16 for i8
    (int8 magnitudes are exact in bf16)."""
    return torch.bfloat16 if isinstance(half, QuantizedKV) else half.dtype


def _scale_axis(scales: torch.Tensor) -> torch.Tensor:
    """Per-slot scales [..., s, K, 1] -> [..., K, s] (the score layout's
    last two axes)."""
    return scales[..., 0].transpose(-1, -2)


def scores_einsum(qg: torch.Tensor, keys) -> torch.Tensor:
    """scores[t,k,m,s] = q[t,k,m,:] . key[s,k,:] with operands in the cache
    dtype and f32 accumulation (bf16 products are exact in f32); for an i8
    half the slot's scale multiplies the raw int8 dot afterwards."""
    if isinstance(keys, QuantizedKV):
        raw = torch.einsum("tkmh,skh->tkms", qg.to(torch.float32), keys.data.to(torch.float32))
        return raw * _scale_axis(keys.scales)[None, :, None, :]
    return torch.einsum("tkmh,skh->tkms", qg.to(torch.float32), keys.to(torch.float32))


def mix_einsum(weights: torch.Tensor, values, cdt: torch.dtype) -> torch.Tensor:
    """att[t,k,m,h] = sum_s w[t,k,m,s] * value[s,k,h]; the weights are
    rounded to the cache dtype first (for i8: scaled by the slot's value
    scale, then rounded to bf16), products accumulate in f32."""
    if isinstance(values, QuantizedKV):
        weights = weights * _scale_axis(values.scales)[None, :, None, :]
        values = values.data
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


def fused_update_row_batched(leaf, k_rows: torch.Tensor, v_rows: torch.Tensor,
                             write: tuple[torch.Tensor, torch.Tensor]):
    """Batched decode write, in place: row ``rows[j]``'s key and value
    ([B, K, hd] inputs) land at slab slot ``slots[j]`` of that row, in one
    indexed copy; ``write = (rows, slots)`` from :func:`write_index`."""
    rows, slots = write
    _set(leaf, (slice(None), rows, slots), _store(leaf, torch.stack([k_rows[rows], v_rows[rows]])))
    return leaf


def verify_write_index(pos, active, T: int, S: int, device) -> tuple[torch.Tensor, ...]:
    """Device (rows, offsets, slots) index tensors of a verify-window write
    from host positions: row b's token t lands at slot pos[b] + t; inactive
    rows and slots at or beyond S (context-limit clamps) are left out."""
    keep = [(b, t, int(p) + t) for b, (p, a) in enumerate(zip(pos, active)) if a
            for t in range(T) if int(p) + t < S]
    idx = to_device([[b for b, _, _ in keep], [t for _, t, _ in keep], [s for _, _, s in keep]],
                    device, torch.int64)
    return idx[0], idx[1], idx[2]


def fused_update_verify_batched(leaf, k_rows: torch.Tensor, v_rows: torch.Tensor,
                                write: tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """Multi-token verify write, in place: ``k_rows``/``v_rows`` [B, T, K, hd];
    token (rows[j], offsets[j]) lands at slot ``slots[j]`` of its row, all in
    one indexed copy; ``write`` from :func:`verify_write_index`."""
    rows, offs, slots = write
    stacked = torch.stack([k_rows[rows, offs], v_rows[rows, offs]])
    _set(leaf, (slice(None), rows, slots), _store(leaf, stacked))
    return leaf


def slab_row(leaf, row: int):
    """Slab row ``row`` as a single-stream [2, S, K, hd] leaf: a view, so
    the single-stream forward writes the slab in place."""
    return leaf[:, row]


def slice_rows_batched(half, start: int, n: int, rows: int | None = None):
    """Slots [start, start+n) of the first ``rows`` slab rows (a view)."""
    return half[: half.shape[0] if rows is None else rows, start : start + n]


# ---------------------------------------------------------------------------
# Page pool [P, page, K, hd] per half
# ---------------------------------------------------------------------------


def init_page_pool_half(n_pages: int, page: int, kl: int, hd: int, dtype, device):
    """One pool half of ``n_pages`` zeroed pages: [P, page, K, hd] (a
    :class:`QuantizedKV` with [P, page, K, 1] scales for "i8")."""
    if is_quantized_cache_dtype(dtype):
        return QuantizedKV(torch.zeros((n_pages, page, kl, hd), dtype=torch.int8, device=device),
                           torch.zeros((n_pages, page, kl, 1), dtype=torch.float32, device=device))
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype} not supported (bf16, f32 or i8)")
    return torch.zeros((n_pages, page, kl, hd), dtype=dtype, device=device)


def pool_page_size(pool_half) -> int:
    return pool_half.shape[1]


def gather_pool_pages(pool_half, ids: torch.Tensor):
    """Pool pages ``ids`` [..., n] -> [..., n*page, K, hd]."""
    if isinstance(pool_half, QuantizedKV):
        return QuantizedKV(gather_pool_pages(pool_half.data, ids), gather_pool_pages(pool_half.scales, ids))
    v = pool_half[ids.to(torch.int64)]
    return v.reshape(v.shape[:-4] + (-1,) + v.shape[-2:])


def _table_window(n_table: int, i: int, ppc: int) -> int:
    """Start of chunk ``i``'s page-table window, clamped into the table (as
    the JAX package's dynamic_slice clamps it)."""
    return min(max(i * ppc, 0), n_table - ppc)


def pool_chunk(pool_half, tables: torch.Tensor, i: int, pages_per_chunk: int):
    """Chunk ``i`` of every row read through its page table: pages
    ``tables[:, i*ppc : (i+1)*ppc]`` -> [B, ppc*page, K, hd]."""
    base = _table_window(tables.shape[1], i, pages_per_chunk)
    return gather_pool_pages(pool_half, tables[:, base : base + pages_per_chunk])


def pool_chunk_row(pool_half, table: torch.Tensor, i: int, pages_per_chunk: int):
    """Single-row :func:`pool_chunk`: ``table`` [n_table] -> [ppc*page, K, hd]."""
    base = _table_window(table.shape[0], i, pages_per_chunk)
    return gather_pool_pages(pool_half, table[base : base + pages_per_chunk])


def select_kv(sel: torch.Tensor, pool_kv, slab_kv):
    """Per-position source select: ``sel`` [..., n] True takes the pool byte
    (data and scale alike for i8)."""
    if isinstance(slab_kv, QuantizedKV):
        return QuantizedKV(select_kv(sel, pool_kv.data, slab_kv.data), select_kv(sel, pool_kv.scales, slab_kv.scales))
    return torch.where(sel[..., None, None], pool_kv, slab_kv)


def virtual_row(half, pool_half, table: torch.Tensor, matched: int):
    """[S, K, hd] view of one row: pool bytes below ``matched``, the slab
    row beyond (materialized; the small-cache fallback's read)."""
    S = half.shape[0]
    pooled = gather_pool_pages(pool_half, table)[:S]
    return select_kv(torch.arange(S, device=half.device) < matched, pooled, half)


def virtual_rows_batched(half_b, pool_half, tables: torch.Tensor, matched: torch.Tensor):
    """Batched :func:`virtual_row` with per-row tables and matched lengths."""
    S = half_b.shape[1]
    pooled = gather_pool_pages(pool_half, tables)[:, :S]
    sel = torch.arange(S, device=half_b.device)[None, :] < matched.to(half_b.device)[:, None]
    return select_kv(sel, pooled, half_b)


def publish_row_pages(pool_half, slab_half, row: int, src_page, page_ids, page: int):
    """Copy slab row ``row``'s page slots ``src_page[i]`` into pool pages
    ``page_ids[i]``, in place (the prefix-cache publish; data and scales
    for i8). Host sequences; ids at or beyond P are dropped."""
    if isinstance(pool_half, QuantizedKV):
        publish_row_pages(pool_half.data, slab_half.data, row, src_page, page_ids, page)
        publish_row_pages(pool_half.scales, slab_half.scales, row, src_page, page_ids, page)
        return pool_half
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
# A pool page's bytes on the host: the spill tier's entries (engine/spill.py)
# ---------------------------------------------------------------------------

# numpy has no bfloat16: a bf16 page is kept as its raw 16-bit words in a
# one-field structured dtype, so the tag travels with the array (the arena's
# CRC runs over the raw bytes and the disk tier's template tells a bf16 page
# from any other) and the tensor is restored bit for bit
BF16_WORDS = np.dtype([("bf16", "<u2")])


_HOST_DTYPES = {torch.bfloat16: BF16_WORDS, torch.float32: np.dtype(np.float32), torch.int8: np.dtype(np.int8)}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool array of ``dtype`` is kept in on the host."""
    return _HOST_DTYPES[dtype]


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The inverse of :func:`host_dtype`; ValueError for any other dtype."""
    for t, n in _HOST_DTYPES.items():
        if n == dtype:
            return t
    raise ValueError(f"no pool dtype is kept on the host as {dtype}")


def to_host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's values as a numpy array (sharing its memory); bf16 as
    :data:`BF16_WORDS`."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def from_host_array(a: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`to_host_array`: a CPU tensor over ``a``'s bytes."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16_WORDS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def slice_pool_page(pool_half, pid: int) -> list:
    """Pool page ``pid`` as a flat tensor list (views): the spill entry's
    layout, ``[data]`` for a plain half and ``[data, scales]`` for int8."""
    if isinstance(pool_half, QuantizedKV):
        return [pool_half.data[pid], pool_half.scales[pid]]
    return [pool_half[pid]]


def pool_page_arrays_per_half(pool_half) -> int:
    """How many arrays :func:`slice_pool_page` yields for this half (2 for
    int8 data and scales, 1 otherwise): the spill entry's layout contract."""
    return 2 if isinstance(pool_half, QuantizedKV) else 1


def download_pool_page(pool_half, pid: int) -> list[np.ndarray]:
    """Host copies of pool page ``pid``'s arrays, verbatim bytes. Blocking
    (tests and tools); the scheduler downloads every layer's slices of a
    page in one copy instead (``BatchScheduler._download_page``)."""
    return [to_host_array(t.cpu().clone()) for t in slice_pool_page(pool_half, pid)]


def upload_pool_page(pool_half, pid: int, tensors: list) -> None:
    """Write one downloaded page back into pool page ``pid`` in place (the
    spill reload: publish in reverse). ``tensors`` are the flat layout of
    :func:`slice_pool_page`, on the pool's device, dtypes and shapes equal
    to the page's; anything else raises ValueError."""
    dst = slice_pool_page(pool_half, pid)
    if len(tensors) != len(dst):
        raise ValueError(f"spill entry has {len(tensors)} arrays for a half of {len(dst)}")
    for d, t in zip(dst, tensors):
        if t.dtype != d.dtype or t.shape != d.shape:
            raise ValueError(f"spill entry array {tuple(t.shape)} {t.dtype} does not fit the pool page "
                             f"{tuple(d.shape)} {d.dtype}")
        d.copy_(t)


def half_bytes(half) -> int:
    """Device bytes of a cache half or leaf (data and scales for i8)."""
    if isinstance(half, QuantizedKV):
        return half_bytes(half.data) + half_bytes(half.scales)
    return half.numel() * half.element_size()


# ---------------------------------------------------------------------------
# Batched and verify einsums (operands as in scores_einsum / mix_einsum)
# ---------------------------------------------------------------------------


def scores_einsum_batched(qg: torch.Tensor, keys) -> torch.Tensor:
    """scores[b,k,m,s] = q[b,k,m,:] . key[b,s,k,:]: each row scores only its
    own cache row."""
    if isinstance(keys, QuantizedKV):
        raw = torch.einsum("bkmh,bskh->bkms", qg.to(torch.float32), keys.data.to(torch.float32))
        return raw * _scale_axis(keys.scales)[:, :, None, :]
    return torch.einsum("bkmh,bskh->bkms", qg.to(torch.float32), keys.to(torch.float32))


def mix_einsum_batched(weights: torch.Tensor, values, cdt: torch.dtype) -> torch.Tensor:
    """att[b,k,m,h] = sum_s w[b,k,m,s] * v[b,s,k,h], weights rounded to the
    cache dtype first (after folding in the value scale for i8)."""
    if isinstance(values, QuantizedKV):
        weights = weights * _scale_axis(values.scales)[:, :, None, :]
        values = values.data
    return torch.einsum("bkms,bskh->bkmh", weights.to(cdt).to(torch.float32), values.to(torch.float32))


def scores_einsum_verify(qg: torch.Tensor, keys) -> torch.Tensor:
    """Verify-window scores[b,t,k,m,s] = q[b,t,k,m,:] . key[b,s,k,:]."""
    if isinstance(keys, QuantizedKV):
        raw = torch.einsum("btkmh,bskh->btkms", qg.to(torch.float32), keys.data.to(torch.float32))
        return raw * _scale_axis(keys.scales)[:, None, :, None, :]
    return torch.einsum("btkmh,bskh->btkms", qg.to(torch.float32), keys.to(torch.float32))


def mix_einsum_verify(weights: torch.Tensor, values, cdt: torch.dtype) -> torch.Tensor:
    """Verify-window att[b,t,k,m,h] = sum_s w[b,t,k,m,s] * v[b,s,k,h]."""
    if isinstance(values, QuantizedKV):
        weights = weights * _scale_axis(values.scales)[:, None, :, None, :]
        values = values.data
    return torch.einsum("btkms,bskh->btkmh", weights.to(cdt).to(torch.float32), values.to(torch.float32))
