"""Radix tree over token blocks: prompt-prefix KV reuse across requests.

The port's copy of the JAX package's ``engine/prefix_cache.py`` host logic.
A prompt is split into blocks of
``page`` positions; each tree node owns one block (its edge key is the
block's token tuple) and one page id of the device page pool
(``models.llama.init_page_pool``).

* Pages are immutable once published: the scheduler copies a row's
  completed prefill KV into fresh pool pages (the only copy). A matched row
  never copies pages back out: its attention reads the matched prefix
  through a per-row page table over the pool.
* Refcounts pin a matched chain for the lifetime of the aliasing row, so
  eviction never recycles a page a live row reads. ``refs == 0`` nodes are
  evictable, leaf-first and least recently used first.
* The pool size is the memory budget: allocation evicts only when the free
  list is dry and fails softly (a partial publish) when everything is pinned.
* Tiered capacity below the device pool (engine/spill.py): with a
  :class:`~distributed_llama_tpu_torch.engine.spill.HostArena` attached,
  eviction spills the page's bytes (data and scales verbatim for int8) to
  bounded host RAM (and optionally an mmap'd disk file) instead of
  discarding them, and a later admission match that runs out of
  device-resident chain reloads them (:meth:`PrefixCache.reload`: the
  publish machinery in reverse). Every entry is CRC-verified on reload; a
  mismatch drops it and the block prefills cold.
* Cross-replica sharing (:class:`SharedPrefixIndex`): each replica's tree
  reports its published and evicted chains to one shared host-side index,
  and the replica pool routes a request to the replica owning the longest
  matched chain. The arena is shared too: a chain spilled by replica A
  reloads into replica B's pool by copy (A's entry stays). A replica's
  death drops its chains from the index and its arena entries.

Thread model: the owning ``BatchScheduler`` calls every method under its
condition lock; the tree itself takes no lock. The shared index and the
arena have their own leaf locks (several schedulers and the replica pool
reach them); neither calls back out.

Telemetry: hits, misses, evictions, matched tokens and the copy bytes a
hit saves count into :class:`telemetry.PrefixCacheInstruments`, bound once
per cache (null instruments when telemetry is off); the pages, bytes and
pinned-pages gauges follow every match, release, publish and eviction.
The plain ``hits`` / ``misses`` / ``evictions`` attributes count the same
events with telemetry off.
"""

from __future__ import annotations

import time

from distributed_llama_tpu_torch import lockcheck, telemetry
from distributed_llama_tpu_torch.engine.spill import SpillCorrupt
from distributed_llama_tpu_torch.telemetry import flight


class SharedPrefixIndex:
    """Host-side map ``token-prefix chain -> owning replicas`` over the
    per-replica radix trees (the routing half of the shared cache tier).

    Each :class:`PrefixCache` reports node inserts (publish/reload) and
    removals (evict/unpublish) here; :meth:`match` answers "which replica
    owns the longest published chain of this prompt" for placement.
    Per-owner chains stay contiguous from the root by construction (the
    trees publish contiguous chains and evict leaf-first), and the match
    walk enforces contiguity anyway (an owner absent at block i is
    ignored at every deeper block)."""

    def __init__(self, page: int):
        self.page = int(page)
        self._lock = lockcheck.make_lock("SharedPrefixIndex._lock")
        self._owners: dict[tuple, set[int]] = {}

    def publish(self, owner: int, chain: tuple) -> None:
        with self._lock:
            self._owners.setdefault(tuple(chain), set()).add(int(owner))

    def withdraw(self, owner: int, chain: tuple) -> None:
        with self._lock:
            owners = self._owners.get(tuple(chain))
            if owners is not None:
                owners.discard(int(owner))
                if not owners:
                    del self._owners[tuple(chain)]

    def drop_owner(self, owner: int) -> None:
        """A replica died: every chain it owned leaves the index in one
        locked pass, so placement never routes to a dead replica's pages."""
        owner = int(owner)
        with self._lock:
            for chain in [c for c, o in self._owners.items() if owner in o]:
                self._owners[chain].discard(owner)
                if not self._owners[chain]:
                    del self._owners[chain]

    def match(self, tokens) -> dict[int, int]:
        """Per-replica depth of the longest contiguous owned chain of
        ``tokens`` (full blocks strictly shorter than the prompt, the
        tree-match bound): ``{replica: n_blocks}``, empty on no match."""
        page = self.page
        max_blocks = (len(tokens) - 1) // page
        # one int-conversion pass OUTSIDE the lock, keys grown
        # incrementally: the cumulative-prefix keys still hash O(depth)
        # each (flat-dict tradeoff), but nothing re-walks the prompt per
        # block while holding the lock every publish/evict also takes
        ids = [int(t) for t in tokens[: max_blocks * page]]
        depths: dict[int, int] = {}
        alive: set[int] | None = None
        key: tuple = ()
        with self._lock:
            for i in range(max_blocks):
                key = key + tuple(ids[i * page : (i + 1) * page])
                owners = self._owners.get(key)
                if not owners:
                    break
                alive = set(owners) if alive is None else alive & owners
                if not alive:
                    break
                for o in alive:
                    depths[o] = i + 1
        return depths

    def owners(self, chain: tuple) -> set[int]:
        with self._lock:
            return set(self._owners.get(tuple(chain), set()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._owners)


class PageNode:
    """One radix-tree node: a ``page``-token block bound to one pool page."""

    __slots__ = ("key", "page_id", "parent", "children", "refs", "last_use")

    def __init__(self, key, page_id: int, parent: "PageNode | None"):
        self.key = key
        self.page_id = page_id
        self.parent = parent
        self.children: dict[tuple, PageNode] = {}
        self.refs = 0
        self.last_use = 0


class PrefixCache:
    """Host-side index of the device page pool (see the module docstring)."""

    def __init__(self, n_pages: int, page: int, page_bytes: int = 0, spill=None, page_fetch=None,
                 owner_id: int = 0, shared_index=None):
        if n_pages < 1:
            raise ValueError(f"need at least one pool page, got {n_pages}")
        if page < 1:
            raise ValueError(f"page size must be positive, got {page}")
        self.page = page
        self.capacity = n_pages
        # the tier: ``spill`` is the (shared) HostArena, ``page_fetch(pid)``
        # the owning scheduler's download of one pool page's byte arrays
        # (the upload side is a reload() argument), ``shared_index`` the
        # pool-wide SharedPrefixIndex this tree reports its chains to, and
        # ``owner_id`` this replica's identity in both. All optional.
        self.spill = spill
        self.page_fetch = page_fetch
        self.owner_id = int(owner_id)
        self.shared_index = shared_index
        self.free: list[int] = list(range(n_pages))
        self.root = PageNode(None, -1, None)
        self._clock = 0
        self._pinned = 0  # refs > 0 nodes, kept at the 0 <-> 1 transitions
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # pages spilled, and the wall time of their spills (download, CRC
        # and arena put: all of it under the owning scheduler's lock)
        self.spills = 0
        self.spill_s = 0.0
        # logical KV bytes per page across all layers and halves
        # (llama.page_pool_bytes); 0 = unknown (host-only unit tests)
        self.page_bytes = int(page_bytes)
        self.tel = telemetry.PrefixCacheInstruments()
        self.tel.pages.set(0)
        self.tel.bytes.set(0)
        self.tel.pinned_pages.set(0)

    def pages_in_use(self) -> int:
        return self.capacity - len(self.free)

    def pinned_pages(self) -> int:
        """Pages whose refcount is held (O(1): a running counter)."""
        return self._pinned

    def _set_pages_gauges(self) -> None:
        used = self.pages_in_use()
        self.tel.pages.set(used)
        self.tel.bytes.set(used * self.page_bytes)

    def _ref(self, node: PageNode) -> None:
        node.refs += 1
        if node.refs == 1:
            self._pinned += 1

    def _unref(self, node: PageNode) -> None:
        node.refs -= 1
        if node.refs == 0:
            self._pinned -= 1

    def _walk(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def chain_key(node: PageNode) -> tuple:
        """The full token-prefix tuple ending at ``node``'s block: the spill
        arena's and the shared index's key (KV bytes are exact only for the
        identical whole prefix)."""
        keys = []
        while node is not None and node.key is not None:
            keys.append(node.key)
            node = node.parent
        out: list[int] = []
        for k in reversed(keys):
            out.extend(int(t) for t in k)
        return tuple(out)

    def walk(self, tokens) -> list[PageNode]:
        """Full-block matches strictly shorter than the prompt, without
        refs or clock ticks."""
        page = self.page
        chain: list[PageNode] = []
        node = self.root
        for i in range((len(tokens) - 1) // page):
            child = node.children.get(tuple(int(t) for t in tokens[i * page : (i + 1) * page]))
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def check(self, row_pages=None) -> None:
        """Structural invariants: every tree page is allocated once and
        disjoint from the free list, the pinned counter matches a walk, and
        each live row's aliased page (``row_pages``: its page table) is
        still in the tree and pinned."""
        seen: dict[int, PageNode] = {}
        for node in self._walk():
            assert 0 <= node.page_id < self.capacity, node.page_id
            assert node.page_id not in seen, f"page {node.page_id} aliased"
            assert node.refs >= 0, f"negative refcount on page {node.page_id}"
            seen[node.page_id] = node
        free = set(self.free)
        assert not (seen.keys() & free), f"tree/free overlap: {sorted(seen.keys() & free)}"
        assert len(seen) + len(free) == self.capacity, (
            f"page leak: {len(seen)} in tree + {len(free)} free != {self.capacity}")
        walked = sum(1 for n in seen.values() if n.refs > 0)
        assert self._pinned == walked, f"pinned counter drift: {self._pinned} != {walked}"
        for ids in row_pages or ():
            for pid in ids:
                assert pid not in free, f"page {pid} freed while a live row's page table references it"
                node = seen.get(pid)
                assert node is not None, f"page {pid} left the tree while a live row references it"
                assert node.refs > 0, f"page {pid} unpinned while a live row aliases it"
        if self.spill is not None:
            # only evicted pages live in the arena: a pinned page with an
            # arena entry of this owner means eviction spilled a live page
            # or a reload forgot to retire its source entry
            for node in seen.values():
                if node.refs > 0:
                    key = self.chain_key(node)
                    assert not self.spill.has(self.owner_id, key), (
                        f"pinned page {node.page_id} is simultaneously resident in the spill arena (chain of "
                        f"{len(key)} tokens)")

    def match(self, tokens) -> list[PageNode]:
        """Longest chain of full-block matches strictly shorter than the
        prompt (the last token always prefills: its logits seed the first
        sampled token). Takes one ref per matched node for the aliasing
        row's lifetime; the caller :meth:`release`\\ s the chain at row
        reset."""
        chain = self.walk(tokens)
        t = self._tick()
        for nd in chain:
            self._ref(nd)
            nd.last_use = t
        if chain:
            self.hits += 1
            self.tel.hits.inc()
            self.tel.matched_tokens.observe(len(chain) * self.page)
            # the copy design gathered every matched page into the slab row:
            # count the copy traffic the zero-copy read avoids per hit
            self.tel.copy_bytes_saved.inc(len(chain) * self.page_bytes)
        else:
            self.misses += 1
            self.tel.misses.inc()
        self.tel.pinned_pages.set(self._pinned)
        return chain

    def release(self, chain: list[PageNode]) -> None:
        for nd in chain:
            self._unref(nd)
        if chain:
            self.tel.pinned_pages.set(self._pinned)

    def publish(self, tokens, n_total: int, parent_chain: list[PageNode]) -> tuple[list[int], list[int]]:
        """Insert the full blocks of ``tokens[:n_total]`` beyond
        ``parent_chain``. Returns ``(page_ids, block_idx)`` of the newly
        allocated pages, which the scheduler then copies out of the row;
        blocks already present are refreshed, not copied. Stops early when
        nothing is evictable."""
        node = parent_chain[-1] if parent_chain else self.root
        page = self.page
        new_ids: list[int] = []
        new_blocks: list[int] = []
        t = self._tick()
        # pin the growing chain: a mid-publish eviction must never detach it
        pinned: list[PageNode] = list(parent_chain)
        for nd in pinned:
            self._ref(nd)
        try:
            for i in range(len(parent_chain), n_total // page):
                key = tuple(int(x) for x in tokens[i * page : (i + 1) * page])
                child = node.children.get(key)
                if child is None:
                    pid = self._alloc()
                    if pid is None:
                        break
                    child = PageNode(key, pid, node)
                    node.children[key] = child
                    new_ids.append(pid)
                    new_blocks.append(i)
                    self._note_insert(child)
                self._ref(child)
                pinned.append(child)
                child.last_use = t
                node = child
        finally:
            for nd in pinned:
                self._unref(nd)
        self._set_pages_gauges()
        self.tel.pinned_pages.set(self._pinned)
        return new_ids, new_blocks

    def unpublish(self, tokens, new_ids: list[int], new_blocks: list[int]) -> None:
        """Unwind a :meth:`publish` whose device copy failed: detach the
        inserted sub-chain (a contiguous tail, so detaching its first node
        drops it all) and free its pages, which were never written."""
        if not new_ids:
            return
        page = self.page
        node = self.root
        for i in range(new_blocks[0]):
            node = node.children[tuple(int(x) for x in tokens[i * page : (i + 1) * page])]
        first = new_blocks[0]
        detached = node.children.pop(tuple(int(x) for x in tokens[first * page : (first + 1) * page]))
        stack = [detached]
        while stack:
            nd = stack.pop()
            if nd.refs > 0:
                self._pinned -= 1
            if self.shared_index is not None:
                # the publish announced these chains: retract them, or
                # placement routes to pages that were never written
                self.shared_index.withdraw(self.owner_id, self.chain_key(nd))
            stack.extend(nd.children.values())
        self.free.extend(new_ids)
        self._set_pages_gauges()
        self.tel.pinned_pages.set(self._pinned)

    def _alloc(self) -> int | None:
        if self.free or self._evict_one():
            return self.free.pop()
        return None

    def _evict_one(self) -> bool:
        """Reclaim the least recently used unreferenced leaf (an interior
        page would strand the chain below it). False when every leaf is
        pinned. With a spill arena the page's bytes are downloaded and
        spilled before its id is freed."""
        victim: PageNode | None = None
        for node in self._walk():
            if node.children or node.refs > 0:
                continue
            if victim is None or node.last_use < victim.last_use:
                victim = node
        if victim is None:
            return False
        key = None
        if self.spill is not None or self.shared_index is not None:
            key = self.chain_key(victim)
        if self.spill is not None and self.page_fetch is not None:
            t0 = time.perf_counter()
            try:
                self.spill.put(self.owner_id, key, self.page_fetch(victim.page_id))
                self.spills += 1
                self.spill_s += time.perf_counter() - t0
                self.tel.spill_pages.inc()
            except Exception as e:
                # spilling is an optimization: a failed download degrades
                # to a plain eviction (the page simply vanishes)
                print(f"⚠️ page spill failed; evicting without it: {e}")
            self._set_spill_gauges()
        if self.shared_index is not None:
            self.shared_index.withdraw(self.owner_id, key)
        del victim.parent.children[victim.key]
        self.free.append(victim.page_id)
        self.evictions += 1
        self.tel.evictions.inc()
        self._set_pages_gauges()
        return True

    # ------------------------------------------------------------------
    # Spill tier (engine/spill.py): reload = publish in reverse
    # ------------------------------------------------------------------

    def _note_insert(self, node: PageNode) -> None:
        """A node entered the tree (publish or reload): announce its chain
        to the shared index and retire this owner's arena entry of it (the
        device copy supersedes it: the exclusivity check() asserts)."""
        if self.spill is None and self.shared_index is None:
            return
        key = self.chain_key(node)
        if self.spill is not None:
            self.spill.drop(self.owner_id, key)
            self._set_spill_gauges()
        if self.shared_index is not None:
            self.shared_index.publish(self.owner_id, key)

    def _set_spill_gauges(self) -> None:
        self.tel.spill_resident_pages.set(self.spill.depth())
        self.tel.spill_bytes.set(self.spill.resident_bytes)

    def spill_depth(self) -> int:
        """Arena entries owned by this replica (the /readyz read)."""
        return 0 if self.spill is None else self.spill.depth(self.owner_id)

    def spill_take(self, chain: tuple):
        """One reload read: this owner's entry MOVES out of the arena,
        another replica's is COPIED. A CRC mismatch drops the corrupt entry
        (counted, recorded in the flight recorder) and the peer lookup
        still runs; only when no intact copy survives does the read miss
        (cold prefill, never stale KV)."""
        if self.spill is None:
            return None
        arrays = None
        try:
            arrays = self.spill.take(self.owner_id, chain)
        except SpillCorrupt as e:
            flight.record(self.owner_id, "spill_crc_drop", error=str(e))
        if arrays is None:
            arrays = self.spill.peek_shared(chain, exclude_owner=self.owner_id)
        self._set_spill_gauges()
        return arrays

    def spill_corrupt(self, chain: tuple) -> None:
        """Chaos hook (``engine.spill`` ``kind=corrupt``): flip bytes of
        the resident entries for ``chain`` in place."""
        if self.spill is not None:
            self.spill.corrupt(chain)

    def reload(self, tokens, upload, pre=None) -> int:
        """Extend the device-resident chain of ``tokens`` from the spill
        arena: per missing block (from where :meth:`walk` ends, bounded like
        match at full blocks strictly shorter than the prompt) allocate a
        pool page (which may itself evict and spill), take the spilled
        bytes, run the caller's ``upload(page_id, arrays)`` and insert the
        node. ``pre(chain_key)`` is the scheduler's ``engine.spill`` fault
        hook. Any failure (arena miss, CRC drop, a dry pool, an upload
        raise, an injected fault) stops the reload cleanly: blocks already
        uploaded stay, deeper blocks prefill cold, the walk's pins are
        released. Returns the number of pages reloaded."""
        if self.spill is None:
            return 0
        page = self.page
        max_blocks = (len(tokens) - 1) // page
        nodes = self.walk(tokens)
        if len(nodes) >= max_blocks:
            return 0
        node = nodes[-1] if nodes else self.root
        # pin the growing chain like publish: a mid-reload _alloc may evict,
        # and must never detach the chain being rebuilt
        pinned: list[PageNode] = list(nodes)
        for nd in pinned:
            self._ref(nd)
        n_reloaded = 0
        try:
            for i in range(len(nodes), max_blocks):
                chain = tuple(int(t) for t in tokens[: (i + 1) * page])
                try:
                    if pre is not None:
                        pre(chain)
                    # allocate BEFORE taking the entry: spill_take moves the
                    # owner's bytes out, so an allocation failure after it
                    # would lose them. The chain being reloaded is not in
                    # the tree, so the eviction _alloc may run cannot touch it
                    pid = self._alloc()
                    if pid is None:
                        break  # everything pinned: no room to reload into
                    arrays = self.spill_take(chain)
                    if arrays is None:
                        self.free.append(pid)
                        break
                    try:
                        upload(pid, arrays)
                    except Exception:
                        self.free.append(pid)
                        # only the upload failed; the bytes are verified:
                        # restore the entry so a later match can retry
                        self.spill.put(self.owner_id, chain, arrays)
                        raise
                except Exception as e:
                    # an injected engine.spill raise or a failed upload: the
                    # remaining blocks prefill cold
                    print(f"⚠️ spill reload aborted; prefilling cold: {e}")
                    flight.record(self.owner_id, "spill_reload_abort", reloaded=n_reloaded,
                                  error=type(e).__name__)
                    break
                key = tuple(int(t) for t in tokens[i * page : (i + 1) * page])
                child = PageNode(key, pid, node)
                node.children[key] = child
                child.last_use = self._tick()
                self._note_insert(child)
                self._ref(child)
                pinned.append(child)
                node = child
                n_reloaded += 1
                self.tel.spill_reloads.inc()
        finally:
            for nd in pinned:
                self._unref(nd)
        if n_reloaded:
            self._set_pages_gauges()
            self.tel.pinned_pages.set(self._pinned)
        return n_reloaded
