"""Radix tree over token blocks: prompt-prefix KV reuse across requests.

The port's copy of the JAX package's ``engine/prefix_cache.py`` host logic
(no spill tier, no cross-replica index). A prompt is split into blocks of
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

Thread model: the owning ``BatchScheduler`` calls every method under its
condition lock; the tree itself takes no lock.

Telemetry: hits, misses, evictions, matched tokens and the copy bytes a
hit saves count into :class:`telemetry.PrefixCacheInstruments`, bound once
per cache (null instruments when telemetry is off); the pages, bytes and
pinned-pages gauges follow every match, release, publish and eviction.
The plain ``hits`` / ``misses`` / ``evictions`` attributes count the same
events with telemetry off.
"""

from __future__ import annotations

from distributed_llama_tpu_torch import telemetry


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

    def __init__(self, n_pages: int, page: int, page_bytes: int = 0):
        if n_pages < 1:
            raise ValueError(f"need at least one pool page, got {n_pages}")
        if page < 1:
            raise ValueError(f"page size must be positive, got {page}")
        self.page = page
        self.capacity = n_pages
        self.free: list[int] = list(range(n_pages))
        self.root = PageNode(None, -1, None)
        self._clock = 0
        self._pinned = 0  # refs > 0 nodes, kept at the 0 <-> 1 transitions
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # logical KV bytes per page across all layers and halves
        # (llama.page_pool_bytes); 0 = unknown (host-only unit tests)
        self.page_bytes = int(page_bytes)
        self.tel = telemetry.PrefixCacheInstruments()
        self.tel.pages.set(0)
        self.tel.bytes.set(0)
        self.tel.pinned_pages.set(0)

    def pages_in_use(self) -> int:
        return self.capacity - len(self.free)

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
        pinned."""
        victim: PageNode | None = None
        for node in self._walk():
            if node.children or node.refs > 0:
                continue
            if victim is None or node.last_use < victim.last_use:
                victim = node
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self.free.append(victim.page_id)
        self.evictions += 1
        self.tel.evictions.inc()
        self._set_pages_gauges()
        return True
