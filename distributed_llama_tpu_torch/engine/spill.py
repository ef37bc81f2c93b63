"""Host-RAM (and optional disk) spill tiers below the device page pool.

The port's copy of the JAX package's ``engine/spill.py``. Without it the
LRU evictor of the prefix cache discards pages that cost real prefill
compute; with it an evicted page's bytes land in a bounded host-RAM arena
(re-uploading host bytes is far cheaper than re-prefilling them), and the
arena can demote its own LRU overflow to an mmap'd disk file (the
reference engine's disc-backed KV buffer is the same bottom rung).

Tier contract (engine/prefix_cache.py drives it):

* **Spill** — ``PrefixCache._evict_one`` downloads the victim page's bytes
  (data AND scales, verbatim, for an int8 cache) and ``put``\\ s them here
  keyed by ``(owner replica, full token-prefix chain)``. The chain key makes
  entries exact: KV at a page's positions depends on every token before
  them, so only a request with the identical prefix may reload the bytes.
* **Reload** — an admission match that ran out of device-resident chain
  consults the arena: the owner's own entry is MOVED back to the device
  (``take``: an entry must never be resident in the arena while its pages
  are live and pinned on the device, the :meth:`PrefixCache.check`
  invariant), another replica's entry is COPIED (``peek_shared``: a chain
  spilled by replica A uploads into replica B without B prefilling it).
* **Integrity** — every entry carries a CRC of its bytes, verified on every
  read. A CRC mismatch raises :class:`SpillCorrupt`, the caller drops the
  entry and falls back to a cold prefill (the ``engine.spill`` fault
  site's ``kind=corrupt`` provokes it).

Entries are lists of numpy arrays. numpy has no bfloat16, so the port keeps
a bf16 page as its raw 16-bit words in the structured dtype
``ops.kv_cache.BF16_WORDS`` (one field named ``bf16``): the dtype tag rides
in the array itself, so the CRC runs over the raw bytes, the disk tier's
template tells a bf16 page from any other, and the scheduler restores the
tensor bit for bit.

Thread model: one arena is shared by every replica's scheduler (and the
pool's death handler), so the arena takes its own LEAF lock: it never
calls back into a scheduler or the pool. Numpy only: the device side of a
spill or a reload belongs to the scheduler (engine/batch.py); this module
stores and checks bytes.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from distributed_llama_tpu_torch import lockcheck, telemetry


class SpillCorrupt(RuntimeError):
    """A spilled entry's bytes no longer match their spill-time CRC: host
    RAM or disk corrupted them in place. The entry is already dropped when
    this raises — the caller's only correct move is a cold prefill."""


def _crc(arrays) -> int:
    c = 0
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c


def _nbytes(arrays) -> int:
    return sum(int(a.nbytes) for a in arrays)


class _Entry:
    __slots__ = ("arrays", "nbytes", "crc", "last_use")

    def __init__(self, arrays, nbytes: int, crc: int, last_use: int):
        self.arrays = arrays
        self.nbytes = nbytes
        self.crc = crc
        self.last_use = last_use


class DiskTier:
    """Fixed-slot mmap'd spill file (the reference's ``newMmapFileBuffer``
    rung). Every spilled page serializes to the same byte length (one
    page's KV across all layers/halves is shape-static per config), so
    the file is a flat slot array: a free list, a key→slot map, and the
    per-slot CRC/LRU bookkeeping live on the host; the bytes live in the
    mmap. The first ``put`` fixes the entry template (shapes/dtypes);
    capacity = ``budget_bytes // entry_bytes`` slots."""

    def __init__(self, path: str, budget_bytes: int, on_drop=None):
        self.path = path
        self.budget = int(budget_bytes)
        self.on_drop = on_drop  # called with the evicted key (LRU overflow)
        self._mm = None
        self._template: list[tuple[tuple, np.dtype]] | None = None
        self.entry_bytes = 0
        self._slots: dict[tuple, tuple[int, int, int]] = {}  # key -> (slot, crc, last_use)
        self._free: list[int] = []
        self._clock = 0
        self.dropped_total = 0

    def _open(self, arrays) -> bool:
        self._template = [(a.shape, a.dtype) for a in arrays]
        self.entry_bytes = _nbytes(arrays)
        n_slots = self.budget // max(self.entry_bytes, 1)
        if n_slots < 1:
            return False  # budget below one entry: disk tier inert
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._mm = np.memmap(
            self.path, dtype=np.uint8, mode="w+",
            shape=(n_slots * self.entry_bytes,),
        )
        self._free = list(range(n_slots))
        return True

    def put(self, key: tuple, arrays, crc: int) -> bool:
        """Write one entry; evicts the LRU slot when full. Returns False
        when the entry cannot be stored (zero-capacity budget or a
        template mismatch — heterogeneous configs never share a file)."""
        if self._mm is None and self._template is None:
            if not self._open(arrays):
                return False
        if self._mm is None:
            return False
        if [(a.shape, a.dtype) for a in arrays] != self._template:
            return False
        old = self._slots.pop(key, None)
        if old is not None:
            self._free.append(old[0])
        if not self._free:
            lru = min(self._slots, key=lambda k: self._slots[k][2])
            self._free.append(self._slots.pop(lru)[0])
            self.dropped_total += 1
            if self.on_drop is not None:
                self.on_drop(lru)
        slot = self._free.pop()
        off = slot * self.entry_bytes
        for a in arrays:
            b = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
            self._mm[off : off + b.size] = b
            off += b.size
        self._clock += 1
        self._slots[key] = (slot, crc, self._clock)
        return True

    def take(self, key: tuple, copy_only: bool = False):
        """Read (and unless ``copy_only`` remove) an entry; CRC-verified.
        Returns the array list or None; raises :class:`SpillCorrupt` on a
        CRC mismatch (the entry is dropped first)."""
        rec = self._slots.get(key)
        if rec is None:
            return None
        slot, crc, _ = rec
        off = slot * self.entry_bytes
        arrays = []
        for shape, dtype in self._template:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            raw = np.array(self._mm[off : off + n])  # copy out of the mmap
            arrays.append(raw.view(dtype).reshape(shape))
            off += n
        if _crc(arrays) != crc:
            del self._slots[key]
            self._free.append(slot)
            raise SpillCorrupt(f"disk spill entry CRC mismatch for {key[0]}")
        if not copy_only:
            del self._slots[key]
            self._free.append(slot)
        else:
            self._clock += 1
            self._slots[key] = (slot, crc, self._clock)
        return arrays

    def drop(self, key: tuple) -> None:
        rec = self._slots.pop(key, None)
        if rec is not None:
            self._free.append(rec[0])

    def keys(self):
        return list(self._slots)

    def __len__(self) -> int:
        return len(self._slots)


class HostArena:
    """Bounded host-RAM spill arena shared across a pool's replicas.

    Keys are ``(owner, chain)``: ``owner`` is the spilling replica id and
    ``chain`` the full token-prefix tuple whose last page the entry holds.
    A budget overflow demotes the LRU entry to the :class:`DiskTier` when
    one is configured, else drops it (counted — silent truncation is how
    capacity claims rot). All methods are thread-safe; the internal lock
    is a LEAF (never calls out)."""

    def __init__(
        self, budget_bytes: int, disk_path: str | None = None,
        disk_budget_bytes: int = 0,
    ):
        self.budget = int(budget_bytes)
        self.disk = (
            DiskTier(disk_path, disk_budget_bytes, on_drop=self._on_disk_drop_locked)
            if disk_path and disk_budget_bytes > 0 else None
        )
        self._lock = lockcheck.make_lock("HostArena._lock")
        self._entries: dict[tuple, _Entry] = {}
        # chain -> owners with a resident entry (host OR disk): the
        # cross-replica peek and the corrupt-chaos hook look up by chain
        self._chains: dict[tuple, set[int]] = {}
        self._clock = 0
        self.resident_bytes = 0
        self.spilled_total = 0
        self.reloaded_total = 0
        self.dropped_total = 0
        self.corrupt_total = 0
        # bound once; the registry dedupes by name, so this is the same
        # series PrefixCacheInstruments.spill_dropped exposes
        self._tel_dropped = telemetry.counter(
            "dllama_prefix_spill_dropped_total",
            "Spilled prefix pages LOST from the capacity ladder: LRU "
            "overflow past the host/disk budgets, or a CRC mismatch "
            "detected at reload (the entry is dropped, the block "
            "prefills cold)",
        )

    def _on_disk_drop_locked(self, key: tuple) -> None:
        # invoked by the disk tier's own LRU eviction, under self._lock
        # (every disk call happens there)
        self.dropped_total += 1
        self._tel_dropped.inc()
        self._unchain_locked(key)

    # ------------------------------------------------------------------
    # Write side
    # ------------------------------------------------------------------

    def put(self, owner: int, chain: tuple, arrays) -> None:
        """Spill one page's byte arrays (verbatim — the caller flattened
        data+scales for i8). Re-putting a key replaces the old entry."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        entry = _Entry(arrays, _nbytes(arrays), _crc(arrays), 0)
        with self._lock:
            key = (int(owner), tuple(chain))
            self._drop_locked(key)
            self._clock += 1
            entry.last_use = self._clock
            self._entries[key] = entry
            self._chains.setdefault(key[1], set()).add(key[0])
            self.resident_bytes += entry.nbytes
            self.spilled_total += 1
            while self.resident_bytes > self.budget and self._entries:
                # demote the LRU entry (the freshly-put one only when it
                # is alone and over-budget by itself) — to disk when a
                # tier is configured, else a counted drop
                self._demote_lru_locked(
                    keep=key if len(self._entries) > 1 else None
                )

    def _demote_lru_locked(self, keep: tuple | None) -> None:
        lru = min(
            (k for k in self._entries if k != keep),
            key=lambda k: self._entries[k].last_use,
        )
        entry = self._entries.pop(lru)
        self.resident_bytes -= entry.nbytes
        demoted = False
        if self.disk is not None:
            demoted = self.disk.put(lru, entry.arrays, entry.crc)
        if not demoted:
            self.dropped_total += 1
            self._tel_dropped.inc()
            self._unchain_locked(lru)

    def _unchain_locked(self, key: tuple) -> None:
        owners = self._chains.get(key[1])
        if owners is not None:
            owners.discard(key[0])
            if not owners:
                del self._chains[key[1]]

    def _drop_locked(self, key: tuple) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.resident_bytes -= entry.nbytes
        if self.disk is not None:
            self.disk.drop(key)
        if entry is not None or self.disk is not None:
            self._unchain_locked(key)

    # ------------------------------------------------------------------
    # Read side
    # ------------------------------------------------------------------

    def _verified_locked(self, key: tuple, remove: bool):
        entry = self._entries.get(key)
        if entry is not None:
            if _crc(entry.arrays) != entry.crc:
                self._drop_locked(key)
                self.corrupt_total += 1
                self._tel_dropped.inc()
                raise SpillCorrupt(
                    f"host spill entry CRC mismatch (owner {key[0]})"
                )
            arrays = entry.arrays
            if remove:
                self._drop_locked(key)
            else:
                self._clock += 1
                entry.last_use = self._clock
                arrays = [a.copy() for a in arrays]
            return arrays
        if self.disk is not None:
            try:
                arrays = self.disk.take(key, copy_only=not remove)
            except SpillCorrupt:
                self.corrupt_total += 1
                self._tel_dropped.inc()
                self._unchain_locked(key)
                raise
            if arrays is not None and remove:
                self._unchain_locked(key)
            return arrays
        return None

    def take(self, owner: int, chain: tuple):
        """MOVE the owner's entry back out (the same-replica reload path:
        the device copy supersedes the arena's, restoring the pinned-
        pages-never-in-arena invariant). None on miss; SpillCorrupt on a
        failed CRC (entry dropped)."""
        with self._lock:
            arrays = self._verified_locked((int(owner), tuple(chain)), remove=True)
            if arrays is not None:
                self.reloaded_total += 1
            return arrays

    def peek_shared(self, chain: tuple, exclude_owner: int):
        """COPY another replica's entry for ``chain`` (cross-replica
        sharing: the reader uploads the bytes into its own pool while the
        spiller's entry stays for the next replica). None when no other
        owner holds the chain."""
        with self._lock:
            owners = self._chains.get(tuple(chain), set())
            for owner in sorted(owners):
                if owner == exclude_owner:
                    continue
                try:
                    arrays = self._verified_locked((owner, tuple(chain)), remove=False)
                except SpillCorrupt:
                    continue  # that copy is gone; try the next owner
                if arrays is not None:
                    self.reloaded_total += 1
                    return arrays
            return None

    def has(self, owner: int, chain: tuple) -> bool:
        key = (int(owner), tuple(chain))
        with self._lock:
            return key[0] in self._chains.get(key[1], set())

    def drop(self, owner: int, chain: tuple) -> None:
        """Remove one entry without reading it (a fresh device publish of
        the chain supersedes the spilled copy)."""
        with self._lock:
            self._drop_locked((int(owner), tuple(chain)))

    def drop_owner(self, owner: int) -> None:
        """A replica died: its spilled bytes are no longer trustworthy
        (a silently corrupt replica may have spilled corrupt KV) and its
        rebuild starts with an empty cache anyway: remove every entry it
        owns, atomically with the death."""
        owner = int(owner)
        with self._lock:
            for key in [k for k in self._entries if k[0] == owner]:
                self._drop_locked(key)
            if self.disk is not None:
                for key in self.disk.keys():
                    if key[0] == owner:
                        self.disk.drop(key)
                        self._unchain_locked(key)

    def corrupt(self, chain: tuple) -> None:
        """Chaos hook (the ``engine.spill`` site's ``kind=corrupt``): flip
        one byte of every resident copy of ``chain`` IN PLACE, silent by
        construction: only the CRC verification can see it."""
        with self._lock:
            for owner in list(self._chains.get(tuple(chain), set())):
                entry = self._entries.get((owner, tuple(chain)))
                if entry is not None and entry.arrays:
                    # a put array may be a read-only view: corrupt a
                    # writable copy in the entry
                    flipped = entry.arrays[0].copy()
                    flipped.view(np.uint8).reshape(-1)[0] ^= 0xFF
                    entry.arrays[0] = flipped
                elif self.disk is not None:
                    rec = self.disk._slots.get((owner, tuple(chain)))
                    if rec is not None:
                        off = rec[0] * self.disk.entry_bytes
                        self.disk._mm[off] ^= 0xFF

    def depth(self, owner: int | None = None) -> int:
        """Resident entries (host + disk), optionally for one owner — the
        /readyz per-replica ``spill_depth`` read."""
        with self._lock:
            if owner is None:
                return sum(len(v) for v in self._chains.values())
            return sum(1 for v in self._chains.values() if int(owner) in v)
