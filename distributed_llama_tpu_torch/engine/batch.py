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

* Fault containment, as in the JAX package. The ``batch.dispatch`` site
  fires before any launch and is retried with backoff
  (:mod:`distributed_llama_tpu_torch.retry`); a launch that raises is not
  retried: it retires every row of the dispatch with a typed
  :class:`faults.RowQuarantined`. A fetch retries its wait on the same
  :class:`platform.HostFetch` (the chunk is never dispatched again). A row
  whose chunk comes back corrupt (non-finite logits, out-of-vocab tokens,
  the ``batch.row`` site), or that the ``engine.paged_attn``,
  ``engine.fused_step`` or ``engine.spec_verify`` site targets, is retired
  alone with its page pins released; its co-batched rows are delivered
  bit-identically.
* The stall watchdog (``stall_timeout_s`` > 0): a thread that, when a
  chunk fetch has been in flight past the timeout, retires that fetch
  generation (its late completion delivers nothing), drops the pending
  chunk and fails every joined row with :class:`faults.StallTimeout`.
  With the watchdog on, a fetch waits on a helper thread while the
  request thread waits on the scheduler lock, so a hung wait holds no
  request: every joined row ends typed within the timeout.
* Per-row deadlines (``BatchStream.deadline``, a ``time.monotonic``
  instant) are checked between chunks and between prefill pieces.
* Priority preemption: :meth:`BatchScheduler.preempt_below` evicts the
  lowest-priority row with :class:`faults.RowPreempted` (the server
  requeues and replays it); the ``engine.preempt`` site turns the eviction
  into a quarantine. The ``engine.sdc`` site corrupts the weights (or the
  next chunk's tokens) into finite wrong values.

* The host spill tier (engine/spill.py): with a ``spill_arena`` (the
  server builds one and shares it across its replicas) an evicted pool
  page's bytes are downloaded and spilled instead of vanishing, and an admission match first reloads spilled
  pages of its prefix (its own or a peer replica's), so the match binds
  them like pages that were never evicted. On the card the download runs
  on a side stream that waits only for the event recorded when the page
  was written, gathers the page's every layer into one buffer and copies
  it into pinned host memory, so a spill never waits for decode chunks
  queued on the main stream; the reload's upload goes through pinned
  staging. The ``engine.spill`` site aborts or corrupts a reload, which
  then prefills cold.
* Replica loss: in a replica pool (server/replicas.py) this scheduler is
  one replica. ``replica_id`` scopes the ``replica.*`` sites (a rule's
  ``row=`` selects the replica), ``health_hook(event, value)`` feeds the
  pool's health walk ("roundtrip" per chunk fetch, "stall" and "lost"),
  and ``lost_on_stall`` turns a watchdog stall into a whole-replica loss.
  :meth:`BatchScheduler.mark_lost` (a ``replica.crash`` fire at a chunk or
  prefill-piece dispatch, a stall under ``lost_on_stall``, or the pool)
  retires every in-flight request with a typed :class:`faults.ReplicaLost`
  that the server replays on a surviving replica (a
  :class:`faults.ReplicaCorrupt` when an integrity check found the loss).

* Tensor parallelism: over an engine with a ``tp_backend``
  (parallel/tensor_parallel.py) the slab and the pool are per-rank lists
  of the same leaves cut to ``K/tp`` kv heads, and the prefill, the
  publish and the batched chunks go through the backend, every rank on its
  own heads; tables, positions and sampler settings are shared. Two modes
  stay single-device, as in the JAX package: speculative decode and the
  host spill tier are disabled with a warning. A backend may raise the
  row bucket floor (``decode_bucket_floor``).

The scheduler's condition is a ``lockcheck`` construction site
(``DLT_LOCK_CHECK``).

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
import weakref

import numpy as np
import torch

from distributed_llama_tpu_torch import lockcheck, prng, retry
from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.engine.engine import StreamStats, _prefill_bucket, _stats, next_pow2
from distributed_llama_tpu_torch.engine.prefix_cache import PrefixCache
from distributed_llama_tpu_torch.engine.speculative import PromptLookupDrafter
from distributed_llama_tpu_torch.models import llama, sampling
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.platform import HostFetch, to_device
from distributed_llama_tpu_torch.telemetry import Stopwatch, flight


# a fetch whose generation the watchdog retired while it waited
_RETIRED = object()


def _watchdog_loop(ref, cond: threading.Condition, interval: float) -> None:
    """The stall watchdog thread of the scheduler ``ref`` points to: a tick
    every ``interval`` seconds (a wait on its lock, so close() ends the
    thread at once) until the scheduler closes or is freed."""
    while True:
        with cond:
            cond.wait(timeout=interval)
        sched = ref()
        if sched is None or sched._shutdown:
            return
        sched._watchdog_check()
        del sched


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
        # per-chunk device logit fingerprints of this request, in delivery
        # order (reset at join); the verify path does not feed it
        self._chunk_fps: list[int] = []
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
        self.deadline = None
        self.tenant = None
        self.priority = None
        self.prefix_cache_enabled = True
        self._history = []
        self._drafter = None
        self._spec_on = False

    def run_fingerprint(self, n_tokens: int | None = None) -> int:
        """FNV-1a fold of this request's chunk fingerprints. ``n_tokens``
        folds only the chunks that produced the first ``n_tokens`` decoded
        tokens (the fused first token carries none), so the value does not
        depend on how many chunks ran ahead; ``None`` folds every delivered
        chunk."""
        fps = self._chunk_fps
        if n_tokens is not None:
            fps = fps[: -(-max(0, n_tokens) // self.scheduler.chunk)]
        out = integrity.FP_BASIS
        for fp in fps:
            out = integrity.fold_run_fingerprint(out, fp)
        return out

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

    def __init__(self, engine, n_rows: int, chunk: int = 32, retries: int = 2, retry_backoff_s: float = 0.05,
                 stall_timeout_s: float | None = None, prefix_cache: bool = False, kv_pages: int | None = None,
                 page_size: int = 64, prefill_chunk: int = 0, spec_draft: int = 0, spec_ngram: int = 3,
                 replica_id: int = 0, spill_arena=None, shared_index=None):
        tp = getattr(engine, "tp_backend", None)
        if tp is not None and not hasattr(tp, "batched_decode_chunk"):
            raise ValueError("batched decode is supported on the single-chip and tp backends only (sp/ep keep "
                             "single-stream dispatches)")
        if n_rows < 1:
            raise ValueError(f"need at least one batch row, got {n_rows}")
        self.engine = engine
        self.b_max = n_rows
        self.chunk = int(chunk)
        self.prefill_chunk = max(0, 0 if prefill_chunk is None else int(prefill_chunk))
        # replica-loss fault domain (server/replicas.py): the replica id
        # scopes the replica.* sites; health_hook(event, value) feeds the
        # pool's health walk and takes only locks ranked above this one;
        # lost_on_stall turns a watchdog stall into a whole-replica loss
        self.replica_id = int(replica_id)
        self.health_hook = None
        self.lost_on_stall = False
        self._lost = False
        self.lost_cause: str | None = None
        cfg = engine.cfg
        # the spill tier's device side: the event recorded when each pool
        # page was last written, and the side stream its download runs on
        self._page_events: dict = {}
        self._copy_stream = None
        # spilled-page downloads and reloaded-page uploads, with their wall
        # time (host clock, ending in the copy's wait for a download)
        self.spill_downloads = 0
        self.spill_download_s = 0.0
        self.spill_uploads = 0
        self.spill_upload_s = 0.0
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
                # the host spill tier: the arena the server shares across
                # its replicas (None: an evicted page vanishes)
                arena = spill_arena
                if arena is not None and tp is not None:
                    print("⚠️ host-RAM spill disabled: the sharded tp page pool has no download/upload programs "
                          "yet (single-chip backend only)")
                    arena = None
                self._prefix = PrefixCache(kv_pages, page_size,
                                           page_bytes=llama.page_pool_bytes(cfg, page_size, engine.cache_dtype),
                                           spill=arena, page_fetch=self._download_page if arena is not None else None,
                                           owner_id=replica_id, shared_index=shared_index)
                if tp is None:
                    self._pool = llama.init_page_pool(cfg, kv_pages, page_size, engine.cache_dtype, engine.device)
                else:  # per-rank [P, page, K/tp, hd] halves
                    self._pool = tp.init_page_pool(kv_pages, page_size, engine.cache_dtype)
                self._n_table = n_table
                if arena is not None and engine.device.type == "cuda":
                    self._copy_stream = torch.cuda.Stream(engine.device)
        if tp is None:
            self._slab = llama.init_batch_cache(cfg, n_rows, engine.cache_dtype, engine.device)
        else:  # per-rank [B, S, K/tp, hd] slabs
            self._slab = tp.init_batch_cache(n_rows, engine.cache_dtype)
        # the fewest rows a chunk covers, as the backend asks (1: the buckets)
        self._bucket_floor = min(n_rows, max(1, int(getattr(tp, "decode_bucket_floor", 1)))) if tp else 1
        # speculative decode: spec_draft > 0 turns every dispatch into a
        # verify step; misconfiguration disables it with its reason
        self.spec_draft = 0
        self.spec_ngram = max(1, int(spec_ngram))
        if spec_draft and int(spec_draft) > 0:
            if tp is not None:
                print("⚠️ speculative decode disabled: the batched verify forward is single-chip only for now "
                      "(the tp verify needs the sharded multi-token program)")
            elif cfg.is_moe:
                print("⚠️ speculative decode disabled: MoE verify windows have no decode parity contract")
            else:
                self.spec_draft = int(spec_draft)
        # verify steps' row totals: rows stepped, drafted and emitted tokens
        self.spec_row_steps = 0
        self.spec_drafted = 0
        self.spec_emitted = 0
        self.spec_rows_max = 0  # the most rows (bucket x window) one verify forward ran
        self._streams: list[BatchStream] = []
        self._cond = lockcheck.make_condition("BatchScheduler._cond")
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
        # bounded retry with backoff for the dispatch site and the fetch
        # wait (base * 2**attempt), and the bind-once fault plan
        self.retries = max(0, int(retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self._retry_policy = retry.BackoffPolicy(attempts=self.retries + 1, base_s=self.retry_backoff_s)
        self._faults = faults.active_plan()
        # engine.sdc message=logits: chunks whose tokens are still to shift
        self._sdc_logits_pending = 0
        # plain counts, readable with telemetry off (the registry's
        # dllama_preemptions_total, dllama_batch_retries_total,
        # dllama_rows_quarantined_total and dllama_watchdog_stalls_total
        # mirror them): clean preemptions, retried dispatch/fetch attempts,
        # retired rows and declared stalls
        self.preempted_total = 0
        self.retries_total = 0
        self.quarantined_total = 0
        self.stalls_total = 0
        # fetch generation: bumped when a thread takes the pending chunk; the
        # watchdog retires a stalled generation, and its late completion
        # delivers nothing
        self._fetch_gen = 0
        self._fetch_started: float | None = None
        self._shutdown = False
        self.stall_timeout_s = stall_timeout_s
        self._watchdog: threading.Thread | None = None
        if stall_timeout_s is not None and stall_timeout_s > 0:
            # the thread holds the scheduler weakly: a scheduler nobody
            # closes is still freed with its slab and pool, and the thread
            # then ends
            self._watchdog = threading.Thread(
                target=_watchdog_loop, args=(weakref.ref(self), self._cond, max(min(stall_timeout_s / 4.0, 1.0),
                                                                               0.005)),
                name="dllama-batch-watchdog", daemon=True)
            self._watchdog.start()

    def close(self) -> None:
        """Stop the watchdog thread and free the slab and the pool: a closed
        scheduler serves nothing more (a thread stuck in a hung fetch may
        hold the scheduler itself for long after)."""
        with self._cond:
            self._shutdown = True
            self._slab = self._pool = None
            self._cond.notify_all()
        if self._watchdog is not None and self._watchdog is not threading.current_thread():
            self._watchdog.join(timeout=5.0)

    # ------------------------------------------------------------------
    # Replica loss: the whole-scheduler failure domain
    # ------------------------------------------------------------------

    def mark_lost(self, cause: str, corrupt: bool = False) -> None:
        """Declare this replica dead (the pool's and the tests' entry
        point). Idempotent. ``corrupt=True`` marks a loss an integrity check
        found (a canary or shadow mismatch): its victims get
        :class:`faults.ReplicaCorrupt`, which the server replays only while
        nothing has streamed (deltas a silently corrupt replica sent may be
        wrong themselves)."""
        with self._cond:
            self._mark_lost_locked(cause, corrupt=corrupt)

    def _mark_lost_locked(self, cause: str, corrupt: bool = False) -> None:
        """The one death path (lock held): every stream gets ReplicaLost
        (ReplicaCorrupt when ``corrupt``; a request mid-prefill raises it at
        its next piece, a decoding one at its next ``next_token``), page
        pins release, the pending chunk is dropped, a fetch in flight is
        retired (it delivers nothing), the watchdog stands down and the
        health hook reports the loss (it takes only locks ranked above this
        one)."""
        if self._lost:
            return
        self._lost = True
        self.lost_cause = cause
        victims = sum(1 for s in self._streams if s._joined)
        flight.record(self.replica_id, "replica_lost", cause=cause, corrupt=bool(corrupt), victims=victims,
                      victim_trace_ids=[s.trace.request_id for s in self._streams if s.trace is not None])
        err_cls = faults.ReplicaCorrupt if corrupt else faults.ReplicaLost
        for s in self._streams:
            s._fetch_error = err_cls(f"replica {self.replica_id} lost: {cause}")
            self._release_pins_locked(s)
        self._pending = None
        self._fetching = False
        self._fetch_started = None
        self._shutdown = True  # a dead replica's watchdog has no duties
        self._cond.notify_all()
        hook = self.health_hook
        if hook is not None:
            hook("lost", float(victims))

    def _lost_error(self) -> faults.ReplicaLost:
        return faults.ReplicaLost(f"replica {self.replica_id} lost: {self.lost_cause}")

    def _watchdog_check(self) -> None:
        """One watchdog tick: fail a hung chunk fetch cleanly. Joined rows
        get a typed StallTimeout, the fetch generation is retired so a late
        completion delivers nothing, the pending chunk is dropped, and the
        scheduler serves new requests at once. Never waits on the fetch
        itself."""
        tel = self.engine._tel
        with self._cond:
            stalled = (self._fetching and self._fetch_started is not None
                       and time.monotonic() - self._fetch_started > self.stall_timeout_s)
            if not stalled:
                return
            self._fetching = False
            self._fetch_started = None
            # the chunk queued behind the hung one: every row that wanted
            # it is being retired, and the last _leave's idle drain would
            # otherwise fetch it on a request thread
            self._pending = None
            self.stalls_total += 1
            tel.watchdog_stalls.inc()
            flight.record(self.replica_id, "watchdog_stall", timeout_s=self.stall_timeout_s,
                          lost_on_stall=self.lost_on_stall)
            if self.lost_on_stall:
                # a supervised replica: the stall is a replica loss, its
                # victims replay on a surviving replica; the "stall" event
                # walks the pool's health through suspect before "lost"
                hook = self.health_hook
                if hook is not None:
                    hook("stall", self.stall_timeout_s)
                self._mark_lost_locked(f"chunk fetch exceeded the {self.stall_timeout_s:.1f}s stall timeout")
                return
            # unsupervised: rows die with StallTimeout and no replica-death
            # dump follows, so snapshot the evidence here
            flight.RECORDER.dump(self.replica_id, "watchdog_stall", timeout_s=self.stall_timeout_s)
            for s in self._streams:
                if s._joined and s._fetch_error is None:
                    s._fetch_error = faults.StallTimeout(
                        f"batched chunk fetch exceeded the {self.stall_timeout_s:.1f}s stall timeout")
                    self._release_pins_locked(s)
            self._cond.notify_all()

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
        if self._lost:
            # placed on this replica just before it died: fail typed before
            # touching the slab (the server requeues it onto a survivor)
            raise self._lost_error()
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
                # a preemption (or quarantine) that landed between pieces:
                # the piece boundaries are the prefill's yield points
                err, stream._fetch_error = stream._fetch_error, None
                raise err
            if stream.deadline is not None and time.monotonic() >= stream.deadline:
                raise faults.DeadlineExceeded(
                    f"deadline expired mid-prefill (row {stream.row}, {off}/{n} prompt tokens dispatched)")
            c = min(step, n - off)
            bucket = _prefill_bucket(c)
            if stream.pos + bucket > engine.cfg.seq_len:
                bucket = c  # exact length near the context limit
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:c] = tokens[off : off + c]
            with self._cond:
                try:
                    # whole-replica crash site: a prefill piece is a round
                    # trip too, so a crash mid-prompt fails over like one
                    # mid-decode
                    self._faults.fire("replica.crash", row=self.replica_id)
                except Exception as e:
                    self._mark_lost_locked(f"injected crash at prefill: {e}")
                if self._lost:
                    err = stream._fetch_error or self._lost_error()
                    stream._fetch_error = None
                    raise err
                paged = None
                if self._pool is not None:
                    # an unaliased row reads matched 0: the same bytes as the
                    # plain prefill, so one path serves hits and misses
                    table, matched = self._alias_row_arrays_locked(stream)
                    paged = (self._pool, table, matched)
                toks = to_device(padded, engine.device)
                if engine.tp_backend is not None:
                    logits, self._slab = engine.tp_backend.slab_forward(
                        engine.params, toks, self._slab, stream.row, stream.pos, c, engine.q40_path, paged=paged)
                else:
                    row_cache = [kvc.slab_row(leaf, stream.row) for leaf in self._slab]
                    logits, _ = llama.forward_tokens(engine.cfg, engine.params, toks, row_cache, stream.pos,
                                                     engine.q40_path, paged=paged, n_real=c)
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

    def _download_page(self, pid: int) -> list[np.ndarray]:
        """Host arrays of pool page ``pid`` across every layer and half, in
        the spill entry's flat layout (per layer: k's then v's arrays of
        :func:`kvc.slice_pool_page`): the PrefixCache eviction hook.

        On the card the page's slices are gathered into one buffer on a side
        stream that waits only for the event recorded when the page was
        written, then copied with one non-blocking copy into pinned host
        memory, and this thread waits for that copy alone: a spill never
        waits for decode chunks queued on the main stream. The wait ends
        before the page id is freed, so a later write of the id (issued
        after this returns) cannot overtake the read."""
        t0 = time.perf_counter()
        views = [t for pk, pv in self._pool for half in (pk, pv) for t in kvc.slice_pool_page(half, pid)]
        if self._copy_stream is None:
            arrays = [kvc.to_host_array(t.cpu().clone()) for t in views]
        else:
            stream = self._copy_stream
            with torch.cuda.stream(stream):
                ready = self._page_events.get(pid)
                if ready is not None:
                    stream.wait_event(ready)
                flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in views])
                host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(flat, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
            # the arrays are views of the pinned buffer (the arena keeps it)
            raw, arrays, off = host.numpy(), [], 0
            for t in views:
                n = t.numel() * t.element_size()
                arrays.append(raw[off : off + n].view(kvc.host_dtype(t.dtype)).reshape(tuple(t.shape)))
                off += n
        self.spill_downloads += 1
        self.spill_download_s += time.perf_counter() - t0
        return arrays

    def _mark_page_written_locked(self, page_ids) -> None:
        """Record the event a later download of these pages waits for (on
        the card, with the spill tier on)."""
        if self._copy_stream is not None:
            ev = torch.cuda.Event()
            ev.record()
            for pid in page_ids:
                self._page_events[int(pid)] = ev

    def _upload_page_locked(self, pid: int, arrays: list) -> None:
        """Write a spilled page's host arrays into pool page ``pid`` across
        every layer, in place (the reload: the publish in reverse), the
        entry regrouped per layer and half. An entry whose layout, dtypes or
        shapes do not fit the pool raises ValueError (an entry from another
        configuration: the reload aborts, the page goes back to the free
        list unread, and the prompt prefills cold). On the card the bytes go
        through one pinned staging buffer and one non-blocking copy."""
        halves = [half for pk, pv in self._pool for half in (pk, pv)]
        counts = [kvc.pool_page_arrays_per_half(h) for h in halves]
        if len(arrays) != sum(counts):
            raise ValueError(f"spill entry layout mismatch: {len(arrays)} arrays, expected {sum(counts)}")
        if self.engine.device.type == "cuda":
            flat = [np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in arrays]
            staging = torch.empty(sum(f.size for f in flat), dtype=torch.uint8, pin_memory=True)
            raw, off = staging.numpy(), 0
            for f in flat:
                raw[off : off + f.size] = f
                off += f.size
            dev_buf = staging.to(self.engine.device, non_blocking=True)
            tensors, off = [], 0
            for a, f in zip(arrays, flat):
                tensors.append(dev_buf[off : off + f.size].view(kvc.torch_dtype(a.dtype)).reshape(a.shape))
                off += f.size
        else:
            tensors = [kvc.from_host_array(a) for a in arrays]
        i = 0
        for h, c in zip(halves, counts):
            kvc.upload_pool_page(h, pid, tensors[i : i + c])
            i += c
        self._mark_page_written_locked([pid])

    def _reload_spilled_locked(self, tokens: np.ndarray) -> int:
        """Pull spilled pages of this prompt's prefix back into the pool
        before the radix match (lock held), so the match binds them like
        pages that were never evicted. The ``engine.spill`` site fires per
        candidate block (``row=`` selects the replica): a raise aborts the
        reload (uploaded blocks stay, deeper blocks prefill cold), and
        ``kind=corrupt`` flips the arena's bytes in place so the CRC must
        catch them."""
        prefix = self._prefix

        def pre(chain_key):
            rule = self._faults.fires("engine.spill", row=self.replica_id)
            if rule is None:
                return
            if rule.kind == "corrupt":
                prefix.spill_corrupt(chain_key)
            else:
                raise faults.InjectedFault(rule.message or "injected fault at engine.spill")

        def upload(pid, arrays):
            t0 = time.perf_counter()
            with self.engine._tel.span("prefix_spill_reload", page=int(pid)):
                # the closure runs synchronously inside prefix.reload, still
                # under _reload_spilled_locked's cond; the AST cannot see
                # through the callback boundary
                self._upload_page_locked(pid, arrays)  # dllama: noqa[LCK-001]
            self.spill_uploads += 1
            self.spill_upload_s += time.perf_counter() - t0

        return prefix.reload(tokens, upload, pre=pre)

    def _match_alias(self, stream: BatchStream, tokens: np.ndarray) -> list:
        """Bind the prompt's longest published prefix to the row: its page
        ids become the row's page table and its position moves past the
        matched tokens. No bytes move; the chain stays pinned. With a spill
        arena, pages of this prefix that were evicted to host RAM (by this
        replica or a peer) are re-uploaded first."""
        prefix = self._prefix
        t0 = time.perf_counter()
        reloaded = 0
        with self._cond:
            self._release_pins_locked(stream)  # a stale alias left by a caller that skipped reset
            if prefix.spill is not None and not self._lost:
                # a dead replica must not re-announce chains to the shared
                # index after the pool dropped its ownership
                reloaded = self._reload_spilled_locked(tokens)
            chain = prefix.match(tokens)
            if stream.trace is not None:
                stream.trace.add_span("prefix_match", t0, time.perf_counter() - t0,
                                      matched_tokens=len(chain) * prefix.page, pages=len(chain),
                                      reloaded_pages=reloaded)
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
            if self._lost:
                # the replica died after the last suffix piece: a publish now
                # would re-announce chains after the pool dropped them
                return
            new_ids, new_blocks = prefix.publish(tokens, tokens.shape[0], chain)
            if not new_ids:
                return
            try:
                with self.engine._tel.span("prefix_publish", pages=len(new_ids), batch_row=stream.row):
                    tp = self.engine.tp_backend
                    if tp is not None:  # each rank moves its own kv-head slice
                        self._pool = tp.publish_pages(self._slab, self._pool, new_ids, new_blocks, stream.row)
                    else:
                        for leaf, (pk, pv) in zip(self._slab, self._pool):
                            kvc.publish_row_pages(pk, leaf[0], stream.row, new_blocks, new_ids, prefix.page)
                            kvc.publish_row_pages(pv, leaf[1], stream.row, new_blocks, new_ids, prefix.page)
                    self._mark_page_written_locked(new_ids)
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
    # Row-targeted fault sites (fired while a batched chunk is built)
    # ------------------------------------------------------------------

    def _retire_locked(self, s: BatchStream, err: BaseException) -> None:
        """Retire one row with a typed error and release its page pins."""
        s._fetch_error = err
        self._release_pins_locked(s)
        self.quarantined_total += 1
        self.engine._tel.rows_quarantined.inc()
        flight.record(self.replica_id, "rows_quarantined", rows=[s.row], error=type(err).__name__)

    def _fire_row_site_locked(self, fire, joined: list, what: str) -> list:
        """``fire(row)`` per joined row, a site's fire: a row-targeted raise
        retires only that row (pins released), and the rows still
        serviceable return."""
        for s in joined:
            try:
                fire(s.row)
            except Exception as e:
                err = faults.RowQuarantined(f"batch row retired: {what} failed for this row")
                err.__cause__ = e
                self._retire_locked(s, err)
        return [s for s in joined if s._fetch_error is None]

    def _fire_sites_locked(self, joined: list) -> list:
        """The ``engine.paged_attn`` site (a pool-enabled scheduler's chunks
        only) and the ``engine.fused_step`` site, per joined row."""
        # each site is named at its fire() call, where FLT-001 reads it
        if self._pool is not None:
            joined = self._fire_row_site_locked(lambda row: self._faults.fire("engine.paged_attn", row=row), joined,
                                                "paged-attention dispatch")
        return self._fire_row_site_locked(lambda row: self._faults.fire("engine.fused_step", row=row), joined,
                                          "fused superstep dispatch")

    def _fire_sdc_locked(self) -> None:
        """The ``engine.sdc`` site, per batched dispatch (``row=`` is the
        replica id): ``message=weights`` (the default) corrupts one
        weight slice in place, ``message=logits`` shifts the next fetched
        chunk's tokens in-vocab. Nothing raises and nothing quarantines."""
        rule = self._faults.fires("engine.sdc", row=self.replica_id)
        if rule is None or rule.kind != "corrupt":
            return
        if (rule.message or "weights") == "logits":
            self._sdc_logits_pending += 1
            return
        engine = self.engine
        engine.params, desc = integrity.corrupt_params(engine.params, seed=getattr(self._faults, "seed", 0),
                                                       copy=getattr(engine, "shares_params", False))
        print(f"🧬 engine.sdc injected on replica {self.replica_id}: corrupted {desc}")

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
            stream._chunk_fps = []
            if not isinstance(stream._fetch_error, (faults.RowPreempted, faults.ReplicaLost)):
                # a preemption or replica loss that landed between this
                # request's prefill and its join survives it: the first
                # next_token raises it
                stream._fetch_error = None
            self._cond.notify_all()

    def _leave(self, stream: BatchStream) -> None:
        with self._cond:
            self._leave_locked(stream)
        # a chunk issued ahead of the last consumed token may be left
        # unfetched: drain it when no joined stream remains
        self._drain_if_idle()

    def _leave_locked(self, stream: BatchStream) -> None:
        if not stream._joined and not stream._queue:
            return
        stream._joined = False
        stream._queue.clear()
        stream._epoch += 1
        self._cond.notify_all()

    def _begin_fetch_locked(self) -> int:
        """Mark a fetch in flight (lock held); returns its generation."""
        self._fetching = True
        self._fetch_gen += 1
        self._fetch_started = time.monotonic()
        return self._fetch_gen

    def _drain_if_idle(self) -> None:
        pend = gen = None
        with self._cond:
            if self._pending is not None and not self._fetching and not any(s._joined for s in self._streams):
                pend, self._pending = self._pending, None
                gen = self._begin_fetch_locked()
        if pend is not None:
            self._fetch(pend, gen)

    # ------------------------------------------------------------------
    # Priority preemption
    # ------------------------------------------------------------------

    def min_preemptible_priority(self) -> int | None:
        """Lowest priority among this scheduler's evictable rows (None when
        nothing is evictable): the replica pool ranks replicas by it, so a
        preemption evicts the globally lowest-priority row."""
        with self._cond:
            prios = [s.priority for s in self._streams if s.priority is not None and s._fetch_error is None]
            return min(prios) if prios else None

    def preempt_below(self, priority: int) -> bool:
        """Evict the lowest-priority row whose priority is strictly below
        ``priority`` (ties: the least-progressed row). Returns True when a
        row was cleanly evicted with :class:`faults.RowPreempted`; the
        ``engine.preempt`` site turns the eviction into a quarantine.

        Page pins are NOT released here: the victim may be mid-admission,
        and dropping its page table while its last suffix piece is still
        dispatching would make that piece attend over slab positions that
        were never written, then publish that KV. The pins fall through
        the victim's own unwind (the prefill's raise, or its lane's next
        reset or rollback)."""
        engine = self.engine
        with self._cond:
            victims = [s for s in self._streams
                       if s.priority is not None and s.priority < priority and s._fetch_error is None]
            if not victims:
                return False
            victim = min(victims, key=lambda s: (s.priority, s.pos))
            injected: Exception | None = None
            try:
                self._faults.fire("engine.preempt", row=victim.row)
            except Exception as e:
                injected = e
            if injected is None:
                err: BaseException = faults.RowPreempted(
                    f"row {victim.row} (tenant {victim.tenant!r}, priority {victim.priority}) preempted by a "
                    f"priority-{priority} arrival; requeued through fair admission")
                self.preempted_total += 1
                engine._tel.preemptions.inc()
            else:
                err = faults.RowQuarantined("batch row retired: preemptive eviction failed for this row")
                err.__cause__ = injected
                self.quarantined_total += 1
                engine._tel.rows_quarantined.inc()
            victim._fetch_error = err
            self._cond.notify_all()
            return injected is None

    def retract_preemption(self, stream: BatchStream) -> None:
        """Drop an unconsumed preemption at request end (the victim finished
        before its next_token could raise it), so it cannot requeue the
        row's next request."""
        with self._cond:
            if isinstance(stream._fetch_error, faults.RowPreempted):
                stream._fetch_error = None

    # ------------------------------------------------------------------
    # The pump: dispatch under the lock, fetch outside it
    # ------------------------------------------------------------------

    def next_token(self, stream: BatchStream) -> int:
        """Next decoded token for ``stream``; whichever thread runs dry
        first dispatches and fetches the shared chunk for everyone. Raises
        the row's typed failure (RowQuarantined, StallTimeout,
        RowPreempted) once its row was retired, and DeadlineExceeded once
        the request's deadline passed: the row then leaves the batch
        between chunks without touching its co-batched rows."""
        while True:
            with self._cond:
                # a retired row leaves the batch as its error is raised,
                # under this lock: no dispatch between the raise and the
                # caller's leave may serve it again
                if stream._fetch_error is not None:
                    err, stream._fetch_error = stream._fetch_error, None
                    self._leave_locked(stream)
                    raise err
                if stream.deadline is not None and time.monotonic() >= stream.deadline:
                    self._leave_locked(stream)
                    raise faults.DeadlineExceeded(
                        f"request deadline expired mid-decode (row {stream.row}); the row leaves the batch")
                if stream._queue:
                    return stream._queue.popleft()
                if not stream._joined:
                    raise RuntimeError("next_token on a stream that left the batch")
                if self._pending is None:
                    # dispatch even while another thread is mid-fetch: the next
                    # chunk's compute then overlaps that fetch (at most one
                    # chunk runs ahead: the single pending slot bounds it)
                    self._dispatch_locked()
                    if stream._fetch_error is not None:
                        continue  # the dispatch retired this row
                if self._pending is not None and not self._fetching:
                    pend, self._pending = self._pending, None
                    gen = self._begin_fetch_locked()
                else:
                    self._cond.wait(timeout=0.1)  # another thread is mid-fetch
                    continue
            self._fetch(pend, gen)

    def _run_dispatch_locked(self, joined: list, dispatch_fn, fail_msg: str):
        """The dispatch frame of the chunk and verify paths (lock held): the
        ``engine.sdc`` site, then the ``batch.dispatch`` site under the
        bounded retry-with-backoff loop, then the launch. The site fires
        before any launch, so only it is retried; a raise from the site
        past its retries, or from the launch itself (a kernel that failed
        to launch, a CUDA error), retires every joined row with a typed
        ``fail_msg`` quarantine and the scheduler serves on. Returns
        ``dispatch_fn``'s result, or None after retiring the rows."""
        tel = self.engine._tel

        def on_retry(attempt, e):
            # retry.retry_call runs on_retry synchronously on this thread,
            # inside this frame, which holds self._cond (the fetch path's
            # on_retry takes it for the same field); the AST cannot see
            # through the callback boundary
            self.retries_total += 1  # dllama: noqa[LCK-004]
            tel.dispatch_retries.inc()

        try:
            # whole-replica crash site: not transient, so no retry and no
            # per-row quarantine; every in-flight request fails over
            self._faults.fire("replica.crash", row=self.replica_id)
        except Exception as e:
            self._mark_lost_locked(f"injected crash at dispatch: {e}")
            return None
        self._fire_sdc_locked()
        try:
            # transient failures (an injected dispatch raise) retry on the
            # shared backoff policy (retry.py). Briefly blocking joins is
            # the cost of a coherent active set: the bounded retries x
            # backoff sleep inside retry_call is the one sanctioned block
            # under this lock.
            retry.retry_call(  # dllama: noqa[LCK-002]
                lambda: self._faults.fire("batch.dispatch"), self._retry_policy, on_retry=on_retry)
            return dispatch_fn()
        except Exception as error:
            self.quarantined_total += len(joined)
            tel.rows_quarantined.inc(len(joined))
            for s in joined:
                err = faults.RowQuarantined(fail_msg)
                err.__cause__ = error
                s._fetch_error = err
                self._release_pins_locked(s)
            self._cond.notify_all()
            return None

    def _dispatchable_locked(self) -> list:
        """The joined rows a dispatch serves: a row already retired (its
        typed error set, not yet raised in its thread) is not dispatched
        again, so a second failed dispatch cannot quarantine it twice."""
        return [s for s in self._streams if s._joined and s._fetch_error is None]

    def _dispatch_locked(self) -> None:
        """Build and dispatch one batched chunk from the joined streams
        (lock held). Bucket rows that are not joined ride along inactive:
        they write nothing and their outputs are discarded. In speculative
        mode the chunk is one verify step (:meth:`_dispatch_spec_locked`)."""
        if self._lost:
            return  # every stream already carries its ReplicaLost
        if self.spec_draft > 0:
            self._dispatch_spec_locked()
            return
        engine = self.engine
        joined = self._dispatchable_locked()
        if not joined:
            return
        joined = self._fire_sites_locked(joined)
        if not joined:
            self._cond.notify_all()
            return
        bucket = decode_bucket(max(max(s.row for s in joined) + 1, self._bucket_floor), self.b_max)
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

        def dispatch():
            with tel.span("batch_decode_chunk", bucket=bucket, active=len(joined), steps=self.chunk):
                tp = engine.tp_backend
                if tp is not None and self._pool is not None:
                    out, self._slab = tp.batched_decode_chunk_paged(
                        engine.params, first, self._slab, self._pool, pos, live, self.chunk, settings["temperature"],
                        settings["topp"], settings["topk"], settings["seeds"], tables, matched, engine.q40_path,
                        settings["may_partition"])
                elif tp is not None:
                    out, self._slab = tp.batched_decode_chunk(
                        engine.params, first, self._slab, pos, live, self.chunk, settings["temperature"],
                        settings["topp"], settings["topk"], settings["seeds"], engine.q40_path,
                        settings["may_partition"])
                elif self._pool is not None:
                    out, self._slab = sampling.decode_chunk_batched_paged(
                        engine.cfg, engine.params, first, self._slab, pos, live, self._pool, self.chunk,
                        tables=tables, matched=matched, **settings)
                else:
                    out, self._slab = sampling.decode_chunk_batched(
                        engine.cfg, engine.params, first, self._slab, pos, live, self.chunk, **settings)
                return out, HostFetch(out)

        res = self._run_dispatch_locked(
            joined, dispatch, f"batched chunk dispatch failed after {self.retries + 1} attempts; this row's "
            "request was retired")
        if res is None:
            return
        out, fetch = res
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
        joined = self._dispatchable_locked()
        if not joined:
            return
        joined = self._fire_sites_locked(joined)
        if not joined:
            self._cond.notify_all()
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

        def dispatch():
            with tel.span("spec_verify_chunk", bucket=bucket, active=len(joined), window=T):
                out, self._slab = sampling.spec_verify_chunk_batched(
                    engine.cfg, engine.params, to_device(feed, dev), self._slab, pos, live, to_device(lens, dev),
                    to_device(temps, dev, torch.float32), to_device(topps, dev, torch.float32),
                    to_device(topks, dev, torch.int64), to_device(seeds, dev, torch.int64),
                    paged=None if self._pool is None else (self._pool, tables, matched), path=engine.q40_path,
                    sampled=any(t > 0.0 for t, ok in zip(temps, live) if ok))
                return HostFetch(out)

        fetch = self._run_dispatch_locked(
            joined, dispatch, f"batched verify dispatch failed after {self.retries + 1} attempts; this row's "
            "request was retired")
        if fetch is None:
            return
        self.decode_forwards += 1
        self.spec_rows_max = max(self.spec_rows_max, bucket * T)
        if tel.enabled:
            tel.batch_occupancy.set(len(joined) / bucket)
            tel.spec_draft_tokens.inc(int(lens.sum()))
        self._pending = ("spec", fetch, [(s, s._epoch) for s in joined], sw, lens, bucket)

    def _wait_fetch(self, fn, gen: int):
        """``fn()`` (the fetch's wait with its retries). Without the
        watchdog it runs on this thread. With it, it runs on a helper
        thread while this thread waits on the scheduler lock, so a hung
        wait holds no request thread: once the watchdog retires ``gen``
        this returns :data:`_RETIRED` at once (the helper's late result is
        dropped)."""
        if self._watchdog is None:
            return fn()
        box: list = []

        def run():
            try:
                result = (True, fn())
            except Exception as e:
                result = (False, e)
            except BaseException as e:
                # an interpreter exit in the wait: the waiter raises it, and
                # this thread ends with it too, so it is not lost when the
                # watchdog already retired the waiter
                with self._cond:
                    box.append((False, e))
                    self._cond.notify_all()
                raise
            with self._cond:
                box.append(result)
                self._cond.notify_all()

        threading.Thread(target=run, name="dllama-batch-fetch", daemon=True).start()
        with self._cond:
            while not box:
                if not (self._fetching and self._fetch_gen == gen):
                    return _RETIRED
                self._cond.wait(timeout=0.1)
        ok, value = box[0]
        if ok:
            return value
        raise value

    def _fetch(self, pend, gen: int) -> None:
        """Wait for a dispatched chunk's host copy (no lock held) and deliver
        each joined row's column to its queue. A failed wait is retried on
        the same copy (``batch.fetch`` fires per attempt); when attempts run
        out every row of the chunk is retired. A row whose logits were
        non-finite or whose tokens are out of vocab (or that the
        ``batch.row`` site corrupts) is retired alone. The epoch check keeps
        a late fetch from feeding a row's next occupant; the generation
        check keeps a fetch the watchdog retired from delivering at all."""
        mode, fetch, snapshot, sw, lens, bucket = pend
        tel = self.engine._tel

        def attempt_once():
            self._faults.fire("batch.fetch")
            # replica chaos: `slow` (kind=delay) stretches this round trip
            # past the pool's suspect threshold, `hang` sleeps into the
            # stall watchdog
            self._faults.fire("replica.slow", row=self.replica_id)
            self._faults.fire("replica.hang", row=self.replica_id)
            with tel.span("batch_decode_fetch", bucket=bucket):
                return fetch.wait()

        def on_retry(attempt, e):
            with self._cond:
                self.retries_total += 1
            tel.fetch_retries.inc()

        host = error = None
        try:
            host = self._wait_fetch(lambda: retry.retry_call(attempt_once, self._retry_policy, on_retry=on_retry),
                                    gen)
        except Exception as e:
            error = e
        except BaseException:
            # an interrupt mid-fetch: give up fetch ownership, then propagate
            with self._cond:
                if self._fetching and self._fetch_gen == gen:
                    self._fetching = False
                    self._fetch_started = None
                self._cond.notify_all()
            raise
        with self._cond:
            # claim the completion: the watchdog declares stalls under this
            # lock, so exactly one side settles the rows. _fetching stays
            # true until delivery, so the pending chunk behind this one is
            # delivered strictly after it
            owned = host is not _RETIRED and self._fetching and self._fetch_gen == gen
            if owned:
                self._fetch_started = None
            else:
                self._cond.notify_all()
        if not owned:
            return  # the watchdog (or a replica loss) retired this fetch: its rows hold typed errors
        hook = self.health_hook
        if hook is not None and error is None:
            # the dispatch-to-fetch round trip: the pool's health walk turns
            # the replica suspect past its threshold and back on a fast one
            hook("roundtrip", sw.elapsed_s())
        if mode == "spec":
            self._deliver_spec(host, snapshot, sw, lens, bucket, error)
            self._drain_if_idle()
            return
        cfg = self.engine.cfg
        bad: dict[int, BaseException] = {}
        toks = fps = None
        if host is not None:
            toks, fps, finite = integrity.split_chunk_outputs(host, self.chunk)
            with self._cond:
                if self._sdc_logits_pending > 0:
                    # engine.sdc message=logits: every column shifted in-vocab,
                    # invisible to the checks below
                    self._sdc_logits_pending -= 1
                    toks = (toks + 1) % cfg.vocab_size
            rule = self._faults.fires("batch.row", rows=[s.row for s, _ in snapshot])
            if rule is not None and rule.row is not None and 0 <= rule.row < toks.shape[1]:
                toks = toks.copy()
                toks[:, rule.row] = -1  # rejected by the check below
            for s, _ in snapshot:
                if not finite[s.row]:
                    bad[s.row] = faults.NonFiniteLogits(
                        "batch row retired: decode produced non-finite logits for this row (caught by the "
                        "device-side finiteness flag before a sampled token could launder it in-vocab)")
                elif not ((toks[:, s.row] >= 0) & (toks[:, s.row] < cfg.vocab_size)).all():
                    bad[s.row] = faults.RowQuarantined(
                        "batch row retired: chunk produced corrupt tokens (NaN-logits class failure)")
        per_token_ms = sw.elapsed_ms() / self.chunk
        entry = _stats(per_token_ms)
        delivered = 0
        with self._cond:
            # deliver and release fetch ownership in one block, so the next
            # pending chunk is taken only after this one's tokens are queued
            self._fetching = False
            if self._lost:  # the replica died after the claim: its rows hold ReplicaLost
                self._cond.notify_all()
                return
            for s, epoch in snapshot:
                if not (s._joined and s._epoch == epoch):
                    continue
                if toks is None or s.row in bad:
                    err = bad.get(s.row) or faults.RowQuarantined(
                        f"batch row retired: chunk fetch failed after {self.retries + 1} attempts")
                    err.__cause__ = error
                    self._retire_locked(s, err)
                    continue
                s._queue.extend(int(t) for t in toks[:, s.row])
                s._chunk_fps.append(int(fps[s.row]))
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

    def _deliver_spec(self, out, snapshot, sw, lens, bucket: int, error) -> None:
        """Deliver one fetched verify step: row b's ``out[b]`` is [n_emit,
        tokens...]. Each row advances by its n_emit, extends its history and
        queues the emitted tokens. A row the ``engine.spec_verify`` site
        targets, or whose n_emit falls outside 1..(its own drafts + 1) or
        whose tokens are out of vocab, is retired alone; a failed fetch
        retires every row."""
        cfg = self.engine.cfg
        tel = self.engine._tel
        step_ms = sw.elapsed_ms()
        emits: dict[int, list[int]] = {}
        causes: dict[int, BaseException | None] = {}
        if out is not None:
            for s, _ in snapshot:
                try:
                    self._faults.fire("engine.spec_verify", row=s.row)
                except Exception as e:
                    causes[s.row] = e
                    continue
                n_emit = int(out[s.row, 0])
                col = out[s.row, 1 : 1 + n_emit]
                # the row's own draft budget bounds n_emit: a value past it
                # would advance the position beyond the dispatch's seq_len clamp
                if not 1 <= n_emit <= int(lens[s.row]) + 1 or not ((col >= 0) & (col < cfg.vocab_size)).all():
                    causes[s.row] = None
                    continue
                emits[s.row] = [int(t) for t in col]
        delivered_rows = delivered_tokens = 0
        with self._cond:
            self._fetching = False
            if self._lost:  # the replica died after the claim: its rows hold ReplicaLost
                self._cond.notify_all()
                return
            for s, epoch in snapshot:
                if not (s._joined and s._epoch == epoch):
                    continue
                if s.row not in emits:
                    err = faults.RowQuarantined(
                        "batch row retired: verify " + (f"fetch failed after {self.retries + 1} attempts"
                                                        if out is None else "step failed or produced corrupt tokens"))
                    err.__cause__ = error if out is None else causes.get(s.row)
                    self._retire_locked(s, err)
                    continue
                toks = emits[s.row]
                n_emit = len(toks)
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
