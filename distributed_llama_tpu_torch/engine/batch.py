"""Batched multi-stream decode: one weight read per step for B requests.

The port's copy of the JAX package's ``engine/batch.py`` serving core.

* :class:`BatchScheduler` owns ONE slab KV cache
  (``llama.init_batch_cache``: per-layer [2, B_max, S, K, hd] leaves) and
  coalesces every joined stream's next chunk into one batched dispatch
  (``sampling.decode_chunk_batched[_paged]``).
* :class:`BatchStream` is one slab row wearing the
  :class:`~distributed_llama_tpu_torch.engine.engine.EngineStream` serving
  surface (``prefill_device`` / ``stream_decode`` / ``rollback`` / ...), so
  the API server's lanes submit into the shared scheduler unchanged.
* Requests join and leave between chunks: a dispatch covers a power-of-two
  row bucket (:func:`decode_bucket`) with an active-row mask; an inactive
  row writes no K/V, so a retired row's cache stays intact for reuse.
* Prefill stays per request, on the row's view of the slab, through the
  ordinary single-stream forward. Long prompts dispatch in
  ``prefill_chunk``-token pieces with the scheduler lock released between
  them, so other rows' decode chunks interleave.
* With ``prefix_cache=True`` the scheduler also owns a page pool and a
  radix tree over token blocks (``engine/prefix_cache.py``). An admission
  prefill (row position 0) binds its matched prefix pages to the row as
  its page table (no bytes move); the row's attention then reads those
  positions from the pool, and only the unmatched suffix prefills into
  the slab. Completed full pages are published back (the one copy). The
  matched chain stays pinned for the row's lifetime. Every batched step of
  a pool-enabled scheduler goes through the paged attention (K2 on the
  card), rows without a hit reading matched 0.
* Per-row seeds, temperatures, top-p and top-k ride the batched step;
  coins are keyed on (seed, position), so a row's stream equals the
  single-stream decode for the same seed.
* With ``spec_draft`` k > 0 every dispatch is a speculative VERIFY step
  (``sampling.spec_verify_chunk_batched``): each joined row's previous
  token and up to k prompt-lookup drafts from its own history ride one
  weight read, the accept/reject runs on the device, and rows advance a
  variable 1..k+1 positions, applied when the step is fetched. A row whose
  request asked for no speculation rides the same step with no drafts (a
  plain decode step), so spec and plain requests share one slab. A verify
  step is never dispatched while another is being fetched: its drafts
  depend on that step's tokens.
* The slab and the pool take the engine's cache dtype, "i8" included.
* Telemetry feeds the engine's instrument bundle once per dispatch or
  fetch (``batch_decode_chunk`` / ``spec_verify_chunk`` spans time the
  host's issue, ``batch_decode_fetch`` the wait for the card), and a row
  whose request is traced (``BatchStream.trace``) gets its prefill pieces,
  prefix match and a per-row child of every shared step in its tree.
  Counters never update under a per-token loop, and nothing here
  synchronizes the device.

Left out (each in ROADMAP.md): the stall watchdog, fault sites, retries,
silent-corruption checks beyond the per-row token checks, preemption, the
host spill tier, the tensor-parallel backend and the lock witness. A plain
``threading.Condition`` guards the scheduler.

Thread model: request threads call into their own :class:`BatchStream`;
whichever thread needs tokens first dispatches the shared chunk for
everyone under the scheduler lock, then fetches outside it. The dispatch
starts the chunk's copy to the host (:class:`platform.HostFetch`), so the
fetch waits for that copy alone, not for the next chunk queued behind it.
An epoch counter per stream keeps a late fetch from delivering a previous
request's tokens to a new occupant.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from distributed_llama_tpu_torch import prng
from distributed_llama_tpu_torch.engine import integrity
from distributed_llama_tpu_torch.engine.engine import StreamStats, _prefill_bucket, _stats, next_pow2
from distributed_llama_tpu_torch.engine.prefix_cache import PrefixCache
from distributed_llama_tpu_torch.engine.speculative import PromptLookupDrafter
from distributed_llama_tpu_torch.models import llama, sampling
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.platform import HostFetch, to_device
from distributed_llama_tpu_torch.telemetry import Stopwatch


class RowQuarantined(RuntimeError):
    """A batch row was retired because its chunk came back corrupt; the
    other rows of the dispatch are unaffected."""


class NonFiniteLogits(RowQuarantined):
    """A row's decode produced non-finite logits (the device-side flag)."""


def decode_bucket(n: int, b_max: int) -> int:
    """Power-of-two row bucket covering rows 0..n-1 (capped at b_max)."""
    return min(next_pow2(n), b_max)


class BatchStream(StreamStats):
    """One slab row of a :class:`BatchScheduler`, wearing the EngineStream
    serving surface. All mutable request state lives here; the scheduler
    snapshots it per dispatch under its lock."""

    def __init__(self, scheduler: "BatchScheduler", row: int):
        super().__init__()
        self.scheduler = scheduler
        self.row = row
        self._queue: collections.deque[int] = collections.deque()
        self._joined = False
        self._epoch = 0  # bumped per join/leave: stale fetches cannot deliver
        self._first = None  # device scalar (or host int) feeding the next chunk
        self._seed32 = 0
        self._temperature = 0.0
        self._topp = 0.9
        self._topk = 0
        # per-request prefix-cache opt-out (the API body's `cache: off`)
        self.prefix_cache_enabled = True
        # the matched radix chain bound to this row: positions below
        # matched_len are read through _alias_ids (its page table)
        self._alias_chain: list = []
        self._alias_ids: list[int] = []
        self.matched_len = 0
        self._fetch_error: BaseException | None = None
        # speculative mode: the request's lookup corpus (prompt + emitted
        # tokens, extended at delivery), its drafter, and whether it drafts
        # at all (False rides the verify steps with zero drafts)
        self._history: list[int] = []
        self._drafter: PromptLookupDrafter | None = None
        self._spec_on = False
        scheduler.engine._tel.active_streams.inc()

    @property
    def cfg(self):
        return self.scheduler.engine.cfg

    @property
    def engine(self):
        return self.scheduler.engine

    def _span_args(self) -> dict:
        return {"batch_row": self.row}

    def reset(self) -> None:
        self.scheduler._leave(self)
        self.scheduler._release_row_pins(self)
        self._clear_stats()
        self._fetch_error = None
        self.prefix_cache_enabled = True
        self._history = []
        self._drafter = None
        self._spec_on = False

    def rollback(self, pos: int) -> None:
        """Rewind to ``pos``; slab slots beyond it are stale but unreachable.
        A rollback below the aliased prefix truncates the alias to ``pos``
        and unpins the pages the shortened table no longer reaches."""
        if not 0 <= pos <= self.pos:
            raise ValueError(f"cannot rollback to {pos} from {self.pos}")
        self.pos = pos
        if self.matched_len > pos:
            self.scheduler._truncate_alias(self, pos)

    def prefill(self, tokens) -> np.ndarray:
        """Prefill into this slab row; returns the last token's logits."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        with self.engine._tel.span("prefill", tokens=n, pos=self.pos, batch_row=self.row):
            logits, last = self.scheduler._prefill_row(self, tokens)
            out = logits[last].cpu().numpy()
        entry = _stats(sw.elapsed_ms(), n)
        self.stats.append(entry)
        self._note_prefill(entry)
        return out

    def prefill_device(self, tokens, temperature, topp, seed: int, topk: int = 0) -> torch.Tensor:
        """Prefill and sample the first token on the device; returns it as a
        device scalar whose copy to the host has started
        (:meth:`StreamStats._sample_first`)."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        with self.engine._tel.span("prefill_dispatch", tokens=n, pos=self.pos, batch_row=self.row):
            logits, last = self.scheduler._prefill_row(self, tokens)
            return self._sample_first(logits[last], n, sw, temperature, topp, seed, topk)

    def stream_decode(self, first_token, on_token, temperature: float = 0.0, topp: float = 0.9, seed: int = 0,
                      chunk: int | None = None, limit: int | None = None, first_prev: int | None = None,
                      spec_draft: int = 0, spec_ngram: int = 3, prompt_tokens=None, topk: int = 0) -> int:
        """EngineStream.stream_decode over the shared batched dispatch: the
        stream joins the scheduler's active set and consumes its row of
        every batched chunk (the scheduler's chunk size governs; ``chunk``
        is accepted for signature parity). Owns the early-stop rollback;
        returns the tokens consumed.

        With the scheduler in speculative mode every dispatch is a verify
        step; ``spec_draft`` 0 on the call keeps this row's drafts empty,
        ``prompt_tokens`` seeds its lookup corpus, and the scheduler's
        drafter settings govern (``spec_ngram`` is accepted for signature
        parity)."""
        sched = self.scheduler
        start_pos = self.pos
        stop = self.cfg.seq_len if limit is None else min(limit, self.cfg.seq_len)
        fused_first = first_prev is not None
        spec_mode = sched.spec_draft > 0
        prev = first_prev if fused_first else int(first_token)
        consumed = 0
        keep = True
        if spec_mode:
            # the drafter needs host token values: the fused first token
            # is fetched before the row joins
            if fused_first:
                tok = self._fetch_fused_first(first_token)
                consumed = 1
                keep = on_token(prev, tok)
                prev = tok
            self._history = [int(t) for t in (prompt_tokens if prompt_tokens is not None else [])]
            self._history.append(prev)
            self._drafter = None
            self._spec_on = bool(spec_draft and spec_draft > 0)
            first_token = prev  # host int: the next verify window's feed[0]
        sched._join(self, first_token, temperature, topp, seed, topk)
        try:
            if fused_first and not spec_mode:
                # the first token is delivered before chunk 1 is issued (the
                # JAX package issues first and fetches under the chunk's
                # compute): its copy started at prefill, so the wait is the
                # prefill's device tail, while issuing a chunk here costs the
                # host one eager forward per step and would hold it back
                tok = self._fetch_fused_first(first_token)
                consumed += 1
                keep = on_token(prev, tok)
                prev = tok
            while keep is not False:
                fed = consumed - 1 if fused_first else consumed
                if start_pos + fed >= stop:
                    break
                tok = sched.next_token(self)
                consumed += 1
                keep = on_token(prev, tok)
                prev = tok
        finally:
            sched._leave(self)
            fed = max(consumed - 1, 0) if fused_first else consumed
            self.rollback(min(start_pos + fed, self.pos))
        return consumed


class BatchScheduler:
    """Owns the [B_max] slab cache (and the page pool) and coalesces joined
    streams into one batched decode dispatch per chunk."""

    def __init__(self, engine, n_rows: int, chunk: int = 32, prefix_cache: bool = False,
                 kv_pages: int | None = None, page_size: int = 64, prefill_chunk: int = 0,
                 spec_draft: int = 0, spec_ngram: int = 3):
        if n_rows < 1:
            raise ValueError(f"need at least one batch row, got {n_rows}")
        if getattr(engine, "tp_backend", None) is not None:
            raise NotImplementedError("the batched scheduler over tensor-parallel ranks is not ported yet "
                                      "(ROADMAP.md Queue 1: the batched TP scheduler)")
        self.engine = engine
        self.b_max = n_rows
        self.chunk = int(chunk)
        self.prefill_chunk = max(0, int(prefill_chunk or 0))
        cfg = engine.cfg
        self._prefix: PrefixCache | None = None
        self._pool = None
        if prefix_cache:
            # misconfiguration disables only the prefix cache, with its reason
            page_ok = 1 <= page_size <= cfg.seq_len
            n_table = -(-cfg.seq_len // page_size) if page_ok else 0
            slab_pages = n_rows * n_table
            if kv_pages is None and page_ok:
                # the pool is the primary store of cached prefixes (rows hold
                # no copies): every row's worth plus 25%, at least one row
                kv_pages = slab_pages + max(slab_pages // 4, n_table)
            if not page_ok:
                print(f"⚠️ prefix cache disabled: page size {page_size} must be in [1, seq_len {cfg.seq_len}]")
            elif kv_pages < 1:
                print("⚠️ prefix cache disabled: --kv-pages 0")
            else:
                if kv_pages < slab_pages:
                    print(f"⚠️ --kv-pages {kv_pages} is smaller than one slab's worth ({slab_pages} pages for "
                          f"{n_rows} rows x seq_len {cfg.seq_len}): concurrent long prompts will contend for "
                          "pages (pinned-page soft failures)")
                self._prefix = PrefixCache(kv_pages, page_size,
                                           page_bytes=llama.page_pool_bytes(cfg, page_size, engine.cache_dtype))
                self._pool = llama.init_page_pool(cfg, kv_pages, page_size, engine.cache_dtype, engine.device)
                self._n_table = n_table
        self._slab = llama.init_batch_cache(cfg, n_rows, engine.cache_dtype, engine.device)
        # speculative decode: spec_draft > 0 turns every dispatch into a
        # verify step; misconfiguration disables it with its reason
        self.spec_draft = 0
        self.spec_ngram = max(1, int(spec_ngram))
        if spec_draft and int(spec_draft) > 0:
            if cfg.is_moe:
                print("⚠️ speculative decode disabled: MoE verify windows have no decode parity contract")
            else:
                self.spec_draft = int(spec_draft)
        # verify steps' row totals: rows stepped, drafted and emitted tokens
        self.spec_row_steps = 0
        self.spec_drafted = 0
        self.spec_emitted = 0
        self.spec_rows_max = 0  # the most rows (bucket x window) one verify forward ran
        self._streams: list[BatchStream] = []
        self._cond = threading.Condition()
        # one dispatched-but-unfetched chunk at a time
        self._pending = None
        self._fetching = False
        # batched forward steps dispatched (one forward of every bucket row
        # each), for launch accounting
        self.decode_forwards = 0
        # decoded tokens delivered into rows' queues, chunk tails past a
        # row's stop included: what dllama_tokens_generated_total counts
        # besides the fused first tokens
        self.tokens_delivered = 0

    def new_stream(self) -> BatchStream:
        """Hand out the next slab row as an EngineStream-like serving lane."""
        with self._cond:
            if len(self._streams) >= self.b_max:
                raise ValueError(f"all {self.b_max} batch rows are allocated")
            s = BatchStream(self, len(self._streams))
            self._streams.append(s)
            return s

    # ------------------------------------------------------------------
    # Prefill (serialized with batched chunks by the lock)
    # ------------------------------------------------------------------

    def _prefill_row(self, stream: BatchStream, tokens: np.ndarray):
        """Prefill ``tokens`` into the stream's slab row. An admission
        prefill (row position 0, prefix cache on, request not opted out)
        binds the matched chain to the row first and dispatches only the
        unmatched suffix, then publishes the completed full pages. Returns
        (device logits of the final dispatch, index of the last real row)."""
        n = tokens.shape[0]
        if n == 0:
            raise ValueError("empty token batch: at least one token required")
        if stream.pos + n > self.engine.cfg.seq_len:
            raise ValueError(f"context overflow: pos {stream.pos} + {n} > {self.engine.cfg.seq_len}")
        admission = self._prefix is not None and stream.pos == 0 and stream.prefix_cache_enabled
        chain: list = []
        suffix = tokens
        if admission:
            chain = self._match_alias(stream, tokens)
            suffix = tokens[len(chain) * self._prefix.page :]
        try:
            logits, last = self._dispatch_prefill_chunks(stream, suffix)
        except BaseException:
            if chain:  # unwind the alias bind: the row is clean for its next occupant
                self._release_row_pins(stream)
                stream.pos = 0
            raise
        if admission:
            self._publish_row(stream, tokens, chain)
        return logits, last

    def _dispatch_prefill_chunks(self, stream: BatchStream, tokens: np.ndarray):
        """Dispatch a prompt at ``stream.pos`` in ``prefill_chunk``-token
        pieces, releasing the lock between pieces so other rows' decode
        chunks interleave."""
        engine = self.engine
        n = tokens.shape[0]
        step = self.prefill_chunk if self.prefill_chunk > 0 else n
        logits, off, c = None, 0, n
        tr = stream.trace
        while off < n:
            t0 = time.perf_counter()
            if stream._fetch_error is not None:
                err, stream._fetch_error = stream._fetch_error, None
                raise err
            c = min(step, n - off)
            bucket = _prefill_bucket(c)
            if stream.pos + bucket > engine.cfg.seq_len:
                bucket = c  # exact length near the context limit
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:c] = tokens[off : off + c]
            with self._cond:
                paged = None
                if self._pool is not None:
                    # an unaliased row reads matched 0: the same bytes as the
                    # plain prefill, so one path serves hits and misses
                    table, matched = self._alias_row_arrays_locked(stream)
                    paged = (self._pool, table, matched)
                row_cache = [kvc.slab_row(leaf, stream.row) for leaf in self._slab]
                logits, _ = llama.forward_tokens(engine.cfg, engine.params, to_device(padded, engine.device),
                                                 row_cache, stream.pos, engine.q40_path, paged=paged, n_real=c)
                stream.pos += c
            off += c
            if tr is not None:
                # one child span per dispatched prompt piece: the trace shows
                # how a long prompt interleaved with other rows' decode
                tr.add_span("prefill_chunk", t0, time.perf_counter() - t0, tokens=c, off=off - c, of=n,
                            row=stream.row)
        return logits, c - 1

    # ------------------------------------------------------------------
    # Prefix cache: admission match/alias bind + publish
    # ------------------------------------------------------------------

    def _match_alias(self, stream: BatchStream, tokens: np.ndarray) -> list:
        """Bind the prompt's longest published prefix to the row: its page
        ids become the row's page table and its position moves past the
        matched tokens. No bytes move; the chain stays pinned."""
        prefix = self._prefix
        t0 = time.perf_counter()
        with self._cond:
            self._release_pins_locked(stream)  # a stale alias left by a caller that skipped reset
            chain = prefix.match(tokens)
            if stream.trace is not None:
                stream.trace.add_span("prefix_match", t0, time.perf_counter() - t0,
                                      matched_tokens=len(chain) * prefix.page, pages=len(chain))
            if chain:
                stream._alias_chain = chain
                stream._alias_ids = [nd.page_id for nd in chain]
                stream.matched_len = len(chain) * prefix.page
                stream.pos = stream.matched_len
        return chain

    def _publish_row(self, stream: BatchStream, tokens: np.ndarray, chain: list) -> None:
        """Copy the admission prefill's completed full pages beyond the
        matched chain into fresh pool pages (in place) and insert them into
        the tree. A failed copy unwinds the insert: the request itself is
        fine, publishing is an optimization."""
        prefix = self._prefix
        with self._cond:
            new_ids, new_blocks = prefix.publish(tokens, tokens.shape[0], chain)
            if not new_ids:
                return
            try:
                with self.engine._tel.span("prefix_publish", pages=len(new_ids), batch_row=stream.row):
                    for leaf, (pk, pv) in zip(self._slab, self._pool):
                        kvc.publish_row_pages(pk, leaf[0], stream.row, new_blocks, new_ids, prefix.page)
                        kvc.publish_row_pages(pv, leaf[1], stream.row, new_blocks, new_ids, prefix.page)
            except Exception as e:
                prefix.unpublish(tokens, new_ids, new_blocks)
                print(f"⚠️ prefix publish failed; pages unwound: {e}")

    def _release_pins_locked(self, stream: BatchStream) -> None:
        """Release the row's page pins and clear its table (lock held)."""
        if stream._alias_chain and self._prefix is not None:
            self._prefix.release(stream._alias_chain)
        stream._alias_chain = []
        stream._alias_ids = []
        stream.matched_len = 0

    def _release_row_pins(self, stream: BatchStream) -> None:
        if not stream._alias_chain:
            stream._alias_ids = []
            stream.matched_len = 0
            return
        with self._cond:
            self._release_pins_locked(stream)

    def _truncate_alias(self, stream: BatchStream, pos: int) -> None:
        """Shrink the row's alias to ``pos`` after a rollback below it:
        positions < pos keep reading the pool (a rollback lands on a shared
        token prefix), pages wholly at or beyond ``pos`` lose their pins."""
        with self._cond:
            if stream.matched_len <= pos:
                return
            if self._prefix is not None:
                keep = -(-pos // self._prefix.page)
                drop = stream._alias_chain[keep:]
                if drop:
                    self._prefix.release(drop)
                stream._alias_chain = stream._alias_chain[:keep]
                stream._alias_ids = stream._alias_ids[:keep]
            stream.matched_len = pos

    def _alias_arrays_locked(self, rows, live):
        """Per-dispatch page tables [len(rows), n_table] and matched lengths
        on the device. Live rows without an alias get matched 0 (slab-only
        reads). Bucket-padding rows get the largest live matched length, so
        they never pull the pool-only segment bound down; their zero tables
        read pool page 0, and their outputs are discarded."""
        tables = np.zeros((len(rows), self._n_table), np.int32)
        matched = np.zeros(len(rows), np.int32)
        live = np.array(live, bool)
        for b, s in enumerate(rows):
            if live[b] and s._alias_ids:
                tables[b, : len(s._alias_ids)] = s._alias_ids
                matched[b] = s.matched_len
        if live.any():
            matched[~live] = matched[live].max()
        dev = self.engine.device
        return to_device(tables, dev), to_device(matched, dev)

    def _row_dispatch_arrays_locked(self, rows):
        """Per-row dispatch inputs: liveness, host positions, sampling
        settings (inert defaults in non-live slots) and, with the pool on,
        the alias arrays."""
        live = [s._joined and s._fetch_error is None for s in rows]
        pos = [s.pos if ok else 0 for s, ok in zip(rows, live)]
        temps = [s._temperature if ok else 1.0 for s, ok in zip(rows, live)]
        topps = [s._topp if ok else 0.9 for s, ok in zip(rows, live)]
        topks = [s._topk if ok else 0 for s, ok in zip(rows, live)]
        seeds = [s._seed32 if ok else 0 for s, ok in zip(rows, live)]
        tables = matched = None
        if self._pool is not None:
            tables, matched = self._alias_arrays_locked(rows, live)
        return live, pos, temps, topps, topks, seeds, tables, matched

    def _alias_row_arrays_locked(self, stream: BatchStream):
        """Single-row alias arrays of a prefill: (device table, host matched)."""
        table = np.zeros(self._n_table, np.int32)
        table[: len(stream._alias_ids)] = stream._alias_ids
        return to_device(table, self.engine.device), stream.matched_len

    def check_prefix(self) -> None:
        """Tree invariants plus alias tracking: no page freed or unpinned
        while a live row's table references it."""
        with self._cond:
            if self._prefix is not None:
                self._prefix.check(row_pages=[list(s._alias_ids) for s in self._streams if s._alias_ids])

    # ------------------------------------------------------------------
    # Join/leave (between chunks)
    # ------------------------------------------------------------------

    def _join(self, stream: BatchStream, first_token, temperature, topp, seed, topk) -> None:
        with self._cond:
            stream._first = first_token
            stream._temperature = float(temperature)
            stream._topp = float(topp)
            stream._topk = int(topk)
            stream._seed32 = prng.fold_seed(seed)
            stream._queue.clear()
            stream._epoch += 1
            stream._joined = True
            stream._fetch_error = None
            self._cond.notify_all()

    def _leave(self, stream: BatchStream) -> None:
        with self._cond:
            if not stream._joined and not stream._queue:
                return
            stream._joined = False
            stream._queue.clear()
            stream._epoch += 1
            self._cond.notify_all()
        # a chunk issued ahead of the last consumed token may be left
        # unfetched: drain it when no joined stream remains
        self._drain_if_idle()

    def _drain_if_idle(self) -> None:
        pend = None
        with self._cond:
            if self._pending is not None and not self._fetching and not any(s._joined for s in self._streams):
                pend, self._pending = self._pending, None
                self._fetching = True
        if pend is not None:
            self._fetch(pend)

    # ------------------------------------------------------------------
    # The pump: dispatch under the lock, fetch outside it
    # ------------------------------------------------------------------

    def next_token(self, stream: BatchStream) -> int:
        """Next decoded token for ``stream``; whichever thread runs dry
        first dispatches and fetches the shared chunk for everyone. Raises
        the row's RowQuarantined when its chunk came back corrupt."""
        while True:
            with self._cond:
                if stream._fetch_error is not None:
                    err, stream._fetch_error = stream._fetch_error, None
                    raise err
                if stream._queue:
                    return stream._queue.popleft()
                if not stream._joined:
                    raise RuntimeError("next_token on a stream that left the batch")
                if self._pending is None:
                    # dispatch even while another thread is mid-fetch: the next
                    # chunk's compute then overlaps that fetch (at most one
                    # chunk runs ahead: the single pending slot bounds it)
                    self._dispatch_locked()
                if self._pending is not None and not self._fetching:
                    pend, self._pending = self._pending, None
                    self._fetching = True
                else:
                    self._cond.wait(timeout=0.1)  # another thread is mid-fetch
                    continue
            self._fetch(pend)

    def _dispatch_locked(self) -> None:
        """Build and dispatch one batched chunk from the joined streams
        (lock held). Bucket rows that are not joined ride along inactive:
        they write nothing and their outputs are discarded. In speculative
        mode the chunk is one verify step (:meth:`_dispatch_spec_locked`)."""
        if self.spec_draft > 0:
            self._dispatch_spec_locked()
            return
        engine = self.engine
        joined = [s for s in self._streams if s._joined and s._fetch_error is None]
        if not joined:
            return
        bucket = decode_bucket(max(s.row for s in joined) + 1, self.b_max)
        rows = self._streams[:bucket]
        live, pos, temps, topps, topks, seeds, tables, matched = self._row_dispatch_arrays_locked(rows)
        dev = engine.device
        first = torch.stack([
            s._first.reshape(()).to(torch.int64) if ok and isinstance(s._first, torch.Tensor)
            else to_device(int(s._first) if ok else 0, dev, torch.int64)
            for s, ok in zip(rows, live)
        ])
        settings = dict(
            temperature=to_device(temps, dev, torch.float32), topp=to_device(topps, dev, torch.float32),
            topk=to_device(topks, dev, torch.int64), seeds=to_device(seeds, dev, torch.int64),
            path=engine.q40_path,
            may_partition=sampling.may_partition_rows(temps, topps, topks, engine.cfg.vocab_size),
        )
        sw = Stopwatch()
        tel = engine._tel
        with tel.span("batch_decode_chunk", bucket=bucket, active=len(joined), steps=self.chunk):
            if self._pool is not None:
                out, self._slab = sampling.decode_chunk_batched_paged(
                    engine.cfg, engine.params, first, self._slab, pos, live, self._pool, self.chunk,
                    tables=tables, matched=matched, **settings)
            else:
                out, self._slab = sampling.decode_chunk_batched(
                    engine.cfg, engine.params, first, self._slab, pos, live, self.chunk, **settings)
            fetch = HostFetch(out)
        self.decode_forwards += self.chunk
        for s in joined:
            # the next chunk starts from this chunk's last token, on the device
            s._first = out[self.chunk - 1, s.row]
            s.pos += self.chunk
        if tel.enabled:
            tel.batch_occupancy.set(len(joined) / bucket)
        self._pending = ("chunk", fetch, [(s, s._epoch) for s in joined], sw, None, bucket)

    def _dispatch_spec_locked(self) -> None:
        """Build and dispatch one speculative verify step (lock held): each
        joined row's window is its previous token and up to ``spec_draft``
        prompt-lookup drafts from its own history, all rows in one
        ``sampling.spec_verify_chunk_batched`` step. Positions advance at
        delivery (the advance is data-dependent), so no verify step is
        dispatched while another is being fetched."""
        if self._fetching:
            return
        engine = self.engine
        joined = [s for s in self._streams if s._joined and s._fetch_error is None]
        if not joined:
            return
        bucket = decode_bucket(max(s.row for s in joined) + 1, self.b_max)
        rows = self._streams[:bucket]
        T, S = self.spec_draft + 1, engine.cfg.seq_len
        live, pos, temps, topps, topks, seeds, tables, matched = self._row_dispatch_arrays_locked(rows)
        feed = np.zeros((bucket, T), np.int64)
        lens = np.zeros(bucket, np.int64)
        for s, ok in zip(rows, live):
            if not ok:
                continue
            feed[s.row, :] = int(s._first)  # padding positions write stale, unreachable K/V
            # accepted positions stay inside the cache: never draft past seq_len
            budget = max(0, min(self.spec_draft, S - s.pos - 1))
            if budget > 0 and s._spec_on:
                if s._drafter is None:
                    s._drafter = PromptLookupDrafter(self.spec_draft, max_ngram=self.spec_ngram)
                d = s._drafter.draft(s._history, limit=budget)
                feed[s.row, 1 : 1 + len(d)] = d
                lens[s.row] = len(d)
        dev = engine.device
        sw = Stopwatch()
        tel = engine._tel
        with tel.span("spec_verify_chunk", bucket=bucket, active=len(joined), window=T):
            out, self._slab = sampling.spec_verify_chunk_batched(
                engine.cfg, engine.params, to_device(feed, dev), self._slab, pos, live, to_device(lens, dev),
                to_device(temps, dev, torch.float32), to_device(topps, dev, torch.float32),
                to_device(topks, dev, torch.int64), to_device(seeds, dev, torch.int64),
                paged=None if self._pool is None else (self._pool, tables, matched), path=engine.q40_path,
                sampled=any(t > 0.0 for t, ok in zip(temps, live) if ok))
            fetch = HostFetch(out)
        self.decode_forwards += 1
        self.spec_rows_max = max(self.spec_rows_max, bucket * T)
        if tel.enabled:
            tel.batch_occupancy.set(len(joined) / bucket)
            tel.spec_draft_tokens.inc(int(lens.sum()))
        self._pending = ("spec", fetch, [(s, s._epoch) for s in joined], sw, lens, bucket)

    def _fetch(self, pend) -> None:
        """Wait for a dispatched chunk's host copy (no lock held) and deliver
        each joined row's column to its queue. A row whose tokens are out of
        vocab or whose logits were non-finite is retired alone."""
        mode, fetch, snapshot, sw, lens, bucket = pend
        tel = self.engine._tel
        with tel.span("batch_decode_fetch", bucket=bucket):
            host = fetch.wait()
        if mode == "spec":
            self._deliver_spec(host, snapshot, sw, lens, bucket)
            self._drain_if_idle()
            return
        toks, _, finite = integrity.split_chunk_outputs(host, self.chunk)
        per_token_ms = sw.elapsed_ms() / self.chunk
        entry = _stats(per_token_ms)
        cfg = self.engine.cfg
        delivered = 0
        with self._cond:
            # deliver and release fetch ownership in one block, so the next
            # pending chunk is taken only after this one's tokens are queued
            self._fetching = False
            for s, epoch in snapshot:
                if not (s._joined and s._epoch == epoch):
                    continue
                col = toks[:, s.row]
                if not finite[s.row]:
                    s._fetch_error = NonFiniteLogits("batch row retired: decode produced non-finite logits")
                elif not ((col >= 0) & (col < cfg.vocab_size)).all():
                    s._fetch_error = RowQuarantined("batch row retired: chunk produced out-of-vocab tokens")
                if s._fetch_error is not None:
                    self._release_pins_locked(s)
                    tel.rows_quarantined.inc()
                    continue
                s._queue.extend(int(t) for t in col)
                s.stats.extend([entry] * self.chunk)
                delivered += 1
                if s.trace is not None:
                    # a per-row child of the shared dispatch, spanning
                    # dispatch to this delivery
                    s.trace.add_span("batch_decode_chunk_row", sw._t0, sw.elapsed_s(), row=s.row,
                                     chunk=self.chunk, bucket=bucket, co_batched=len(snapshot))
                if tel.enabled:
                    tel.kv_occupancy.set(min(s.pos / cfg.seq_len, 1.0))
            self.tokens_delivered += self.chunk * delivered
            self._cond.notify_all()
        if tel.enabled and delivered:
            tel.tokens_generated.inc(self.chunk * delivered)
            tel.device_sampled_tokens.inc(self.chunk * delivered)
            tel.decode_latency.observe(per_token_ms / 1000.0)
        self._drain_if_idle()

    def _deliver_spec(self, out: np.ndarray, snapshot, sw, lens, bucket: int) -> None:
        """Deliver one fetched verify step: row b's ``out[b]`` is [n_emit,
        tokens...]. Each row advances by its n_emit, extends its history and
        queues the emitted tokens; a row whose n_emit falls outside 1..(its
        own drafts + 1) or whose tokens are out of vocab is retired alone."""
        cfg = self.engine.cfg
        tel = self.engine._tel
        step_ms = sw.elapsed_ms()
        delivered_rows = delivered_tokens = 0
        with self._cond:
            self._fetching = False
            for s, epoch in snapshot:
                if not (s._joined and s._epoch == epoch):
                    continue
                n_emit = int(out[s.row, 0])
                col = out[s.row, 1 : 1 + n_emit]
                # the row's own draft budget bounds n_emit: a value past it
                # would advance the position beyond the dispatch's seq_len clamp
                if not 1 <= n_emit <= int(lens[s.row]) + 1 or not ((col >= 0) & (col < cfg.vocab_size)).all():
                    s._fetch_error = RowQuarantined("batch row retired: verify step produced corrupt tokens")
                    self._release_pins_locked(s)
                    tel.rows_quarantined.inc()
                    continue
                toks = [int(t) for t in col]
                s.pos += n_emit
                s._first = toks[-1]  # host int: the next window's feed[0]
                s._history.extend(toks)
                s._queue.extend(toks)
                s.stats.append(_stats(step_ms, n_emit))
                self.spec_row_steps += 1
                self.spec_drafted += int(lens[s.row])
                self.spec_emitted += n_emit
                delivered_rows += 1
                delivered_tokens += n_emit
                if s.trace is not None:
                    s.trace.add_span("spec_verify_row", sw._t0, sw.elapsed_s(), row=s.row,
                                     drafted=int(lens[s.row]), emitted=n_emit, bucket=bucket)
                if tel.enabled:
                    tel.kv_occupancy.set(min(s.pos / cfg.seq_len, 1.0))
                    tel.spec_accepted_tokens.inc(n_emit - 1)
                    if int(lens[s.row]) > 0:
                        tel.spec_acceptance.observe((n_emit - 1) / int(lens[s.row]))
                    tel.spec_step_advance.observe(n_emit)
            self.tokens_delivered += delivered_tokens
            self._cond.notify_all()
        if tel.enabled and delivered_tokens:
            tel.tokens_generated.inc(delivered_tokens)
            tel.device_sampled_tokens.inc(delivered_tokens)
            tel.decode_latency.observe(step_ms * delivered_rows / delivered_tokens / 1000.0)
