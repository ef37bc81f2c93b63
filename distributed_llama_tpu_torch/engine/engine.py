"""KV-cached inference engine on one device: prefill + chunked device decode.

:class:`InferenceEngine` owns the config and the weights; the mutable decode
state (KV cache, position, stats) lives in :class:`EngineStream`, and the
engine delegates the single-stream surface to a default stream. Decode runs
in chunks: each chunk is ``chunk`` forward+sample steps issued back to back
with the sampled token fed to the next step on the device, and the next
chunk is issued before the previous chunk's tokens are fetched. Each
chunk's tokens start their copy to the host when the chunk is issued
(:class:`platform.HostFetch`), and the fetch waits for that copy alone, so
chunk k's tokens reach the host while chunk k+1 still runs.

Every stats entry covers the host time of its dispatch plus fetch. On a
single device there is no transfer share (``transfer_ms`` is 0); under a
parallel backend (tensor, sequence or expert parallelism:
:mod:`parallel.tensor_parallel`, :mod:`parallel.context_parallel`,
:mod:`parallel.expert_parallel`) it is the measured per-token time of the
backend's collective sequence, paid once per dispatch the entry covers
(the sequence-parallel chunked prefill issues several), and re-measured at
a quiescent point every ``TRANSFER_REFRESH_TOKENS`` tokens.

Telemetry: each engine binds one :class:`telemetry.EngineInstruments`
bundle at construction (null instruments unless telemetry was enabled
first). Counters and histograms update once per dispatch or fetch, never
per token. The dispatch spans (``prefill_dispatch``, ``device_sample``,
``decode_chunk_dispatch``) time the host's issue of eager launches; the
fetch spans (``first_token_fetch``, ``decode_chunk_fetch``) time the wait
for the card. No span synchronizes the device.

Faults: each engine binds the active :mod:`engine.faults` plan at
construction; the single-stream surface fires ``engine.forward`` (every
forward), ``engine.decode_dispatch`` (every decode chunk),
``engine.fetch`` (every chunk fetch) and ``engine.spec_verify`` (every
verify step), each before its launch or wait.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_llama_tpu_torch import prng, telemetry
from distributed_llama_tpu_torch.engine import faults
from distributed_llama_tpu_torch.engine import weights as weights_lib
from distributed_llama_tpu_torch.models import llama, sampling
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops.q40 import PATHS
from distributed_llama_tpu_torch.platform import HostFetch, resolve_device, to_device
from distributed_llama_tpu_torch.telemetry import Stopwatch


def next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _prefill_bucket(n: int) -> int:
    """Prompt lengths pad to power-of-two buckets (floor 8), as in the JAX
    package, so both take the same attention branch for a prompt."""
    return max(8, next_pow2(n))


@dataclasses.dataclass
class TokenStats:
    """Per-step timing (G/I/T). A batched prefill is one entry covering
    ``n_tokens`` positions; decode entries have ``n_tokens == 1``."""

    generation_ms: float
    inference_ms: float
    transfer_ms: float
    n_tokens: int = 1


def _stats(ms: float, n_tokens: int = 1) -> TokenStats:
    return TokenStats(ms, ms, 0.0, n_tokens=n_tokens)


class StreamStats:
    """What a serving lane (:class:`EngineStream`, or a batch row) keeps
    besides its cache: per-step stats, and the device-sampled first token
    of its last ``prefill_device`` with the host copy started for it."""

    # the occupying request's TraceContext (the server sets it per request;
    # None = untraced): the batch scheduler adds the row's spans to it
    trace = None
    # the occupying request's deadline (a time.monotonic instant, or None),
    # tenant and priority, set by the server per request: the server checks
    # the deadline per token, the batch scheduler between chunks, and a
    # batch row with a priority is a preemption candidate
    deadline: float | None = None
    tenant: str | None = None
    priority: int | None = None

    def __init__(self):
        self.pos = 0
        self.stats: list[TokenStats] = []
        # the prefill_device entry awaiting its compute-drain time
        self._pending_prefill_entry: TokenStats | None = None
        # (device token, its host copy) of the last prefill_device
        self._first_fetch: tuple[torch.Tensor, HostFetch] | None = None

    def _clear_stats(self) -> None:
        self.pos = 0
        self.stats.clear()
        self._pending_prefill_entry = None
        self._first_fetch = None

    def _sample_first(self, last_logits: torch.Tensor, n: int, sw: Stopwatch, temperature, topp, seed: int,
                      topk: int) -> torch.Tensor:
        """Sample the first generated token on the device from the prompt's
        last logits (its coin keyed on the last prompt token's position,
        pos - 1), start its copy to the host, and record the prefill's
        stats entry, which gains the drain time when the token is fetched.
        The n prompt tokens count here; the prefill latency is observed at
        the fetch, once the entry holds the drain time."""
        tel = self.engine._tel
        with tel.span("device_sample", pos=self.pos - 1, **self._span_args()):
            token = sampling.sample_token(last_logits, prng.fold_seed(seed), self.pos - 1, float(temperature),
                                          float(topp), int(topk))
        if tel.enabled:
            tel.prompt_tokens.inc(n)
        entry = self._entry(sw.elapsed_ms(), n)
        self.stats.append(entry)
        self._pending_prefill_entry = entry
        self._first_fetch = (token, HostFetch(token))
        return token

    def _entry(self, ms: float, n_tokens: int = 1) -> TokenStats:
        """The stats entry of ``ms`` of host time covering ``n_tokens``."""
        return _stats(ms, n_tokens)

    def fetch_first_token(self, first_token) -> int:
        """Fetch a ``prefill_device`` token without starting a decode."""
        return self._fetch_fused_first(first_token)

    def _fetch_fused_first(self, first_token) -> int:
        """Fetch the device-sampled first token. The fetch drains the
        prefill, so its time joins the prefill's stats entry; the token
        counts as generated here (it belongs to no decode chunk)."""
        sw = Stopwatch()
        tel = self.engine._tel
        with tel.span("first_token_fetch", **self._span_args()):
            if self._first_fetch is not None and self._first_fetch[0] is first_token:
                tok = int(self._first_fetch[1].wait())
                self._first_fetch = None
            elif isinstance(first_token, torch.Tensor):
                tok = int(first_token.item())
            else:
                tok = int(first_token)
        entry = self._pending_prefill_entry
        if entry is not None:
            drained = sw.elapsed_ms()
            entry.generation_ms += drained
            entry.inference_ms += drained
            self._pending_prefill_entry = None
            if tel.enabled:
                tel.prefill_latency.observe(entry.generation_ms / 1000.0)
                tel.tokens_generated.inc(1)
                tel.device_sampled_tokens.inc(1)
                tel.kv_occupancy.set(self.pos / self.engine.cfg.seq_len)
        return tok

    def _span_args(self) -> dict:
        """Extra span arguments naming this lane (a batch row's index)."""
        return {}

    def _note_prefill(self, entry: TokenStats) -> None:
        tel = self.engine._tel
        if tel.enabled:
            tel.prompt_tokens.inc(entry.n_tokens)
            tel.prefill_latency.observe(entry.generation_ms / 1000.0)
            tel.kv_occupancy.set(self.pos / self.engine.cfg.seq_len)

    def _note_decode(self, n_tokens: int, per_token_ms: float, device_sampled: bool = False) -> None:
        tel = self.engine._tel
        if tel.enabled:
            tel.tokens_generated.inc(n_tokens)
            tel.decode_latency.observe(per_token_ms / 1000.0)
            tel.kv_occupancy.set(self.pos / self.engine.cfg.seq_len)
            if device_sampled:
                # the host Sampler counts its own fallback tokens: the two
                # counters partition decode
                tel.device_sampled_tokens.inc(n_tokens)

    def avg_stats(self) -> TokenStats:
        """Per-token averages, prefill entries weighted by their token count."""
        if not self.stats:
            return TokenStats(0.0, 0.0, 0.0)
        n = sum(s.n_tokens for s in self.stats)
        return TokenStats(
            sum(s.generation_ms for s in self.stats) / n,
            sum(s.inference_ms for s in self.stats) / n,
            sum(s.transfer_ms for s in self.stats) / n,
            n_tokens=n,
        )

    def total_tokens(self) -> int:
        return sum(s.n_tokens for s in self.stats)


class EngineStream(StreamStats):
    """One generation stream: its own KV cache, position and stats over the
    engine's weights."""

    def __init__(self, engine: "InferenceEngine", cache):
        super().__init__()
        self.engine = engine
        self.cache = cache
        # forward passes issued (a prefill is one, a decode chunk n_steps)
        self.forwards = 0
        engine._tel.active_streams.inc()

    @property
    def cfg(self) -> LlamaConfig:
        return self.engine.cfg

    def _entry(self, ms: float, n_tokens: int = 1) -> TokenStats:
        # a multi-token entry covers the prefill this thread just issued,
        # which paid the transfer once per forward it dispatched
        n_dispatches = self.engine.last_dispatches() if n_tokens > 1 else 1
        return self.engine.split_stats(ms, n_tokens, n_dispatches)

    def reset(self) -> None:
        self._clear_stats()

    def rollback(self, pos: int) -> None:
        """Rewind to ``pos``; cache slots beyond it are stale but
        unreachable (attention masks s <= pos, and each slot is written
        before the position pointer crosses it)."""
        if not 0 <= pos <= self.pos:
            raise ValueError(f"cannot rollback to {pos} from {self.pos}")
        self.pos = pos

    def _forward_device(self, tokens: np.ndarray) -> torch.Tensor:
        """Issue one forward; returns device logits [T_padded, vocab] and
        advances pos by the real token count."""
        engine = self.engine
        engine._faults.fire("engine.forward")
        n = tokens.shape[0]
        if n == 0:
            raise ValueError("empty token batch: at least one token required")
        if self.pos + n > engine.cfg.seq_len:
            raise ValueError(f"context overflow: pos {self.pos} + {n} > {engine.cfg.seq_len}")
        padded = tokens
        # a backend that pads or chunks prompts itself (sequence parallelism)
        # takes them at their exact length
        if n > 1 and not getattr(engine.tp_backend, "prefers_exact_mid_prefill", False):
            bucket = _prefill_bucket(n)
            if self.pos + bucket > engine.cfg.seq_len:
                bucket = n  # exact length near the context limit
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:n] = tokens
        toks = to_device(np.asarray(padded, np.int64), engine.device)
        logits, self.cache = engine.forward_fn(toks, self.cache, self.pos, n_real=n)
        self.pos += n
        self.forwards += 1
        return logits

    def forward(self, tokens) -> np.ndarray:
        """f32 logits [T, vocab] of tokens run at the current position."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        with self.engine._tel.span("forward", tokens=n, pos=self.pos):
            logits = self._forward_device(tokens)[:n].cpu().numpy()
        entry = self._entry(sw.elapsed_ms(), n)
        self.stats.append(entry)
        if n > 1:
            self._note_prefill(entry)
        else:
            self._note_decode(1, entry.generation_ms)
        return logits

    def prefill(self, tokens) -> np.ndarray:
        """Process a prompt in one batched step; returns last-token logits."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        with self.engine._tel.span("prefill", tokens=n, pos=self.pos):
            logits = self._forward_device(tokens)[n - 1].cpu().numpy()
        entry = self._entry(sw.elapsed_ms(), n)
        self.stats.append(entry)
        self._note_prefill(entry)
        return logits

    def prefill_device(self, tokens, temperature, topp, seed: int, topk: int = 0) -> torch.Tensor:
        """Prefill and sample the first generated token on the device;
        returns it as a device scalar whose copy to the host has started
        (:meth:`StreamStats._sample_first`)."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        with self.engine._tel.span("prefill_dispatch", tokens=n, pos=self.pos):
            logits = self._forward_device(tokens)
            return self._sample_first(logits[n - 1], n, sw, temperature, topp, seed, topk)

    def decode_step(self, token: int) -> np.ndarray:
        """One autoregressive step; returns f32 logits [vocab]."""
        return self.forward([token])[0]

    def generate_on_device(self, first_token, n_steps: int, temperature: float = 0.0, topp: float = 0.9,
                           seed: int = 0, topk: int = 0) -> np.ndarray:
        """Generate ``n_steps`` tokens in one dispatch with no host round
        trip between them (under tensor parallelism through the backend's
        ``decode_loop``); ``tokens[i]`` is sampled after consuming position
        ``pos + i``. Returns int64 [n_steps] on the host."""
        engine = self.engine
        if self.pos + n_steps > engine.cfg.seq_len:
            raise ValueError(f"context overflow: pos {self.pos} + {n_steps}")
        sw = Stopwatch()
        if engine.tp_backend is not None:
            tokens, self.cache = engine.tp_backend.decode_loop(
                engine.params, first_token, self.cache, self.pos, n_steps, float(temperature), float(topp),
                seed=seed, topk=topk, path=engine.q40_path)
        else:
            tokens, self.cache = sampling.decode_scan(
                engine.cfg, engine.params, first_token, self.cache, self.pos, prng.fold_seed(seed), n_steps,
                float(temperature), float(topp), topk, engine.q40_path)
        tokens = tokens.cpu().numpy()
        per_token_ms = sw.elapsed_ms() / n_steps
        self.stats.extend([self._entry(per_token_ms)] * n_steps)
        self.pos += n_steps
        self.forwards += n_steps
        self._note_decode(n_steps, per_token_ms, device_sampled=True)
        return tokens

    def _dispatch_chunk(self, first_token, n_steps: int, temperature, topp, topk, seed32: int):
        """Issue one decode chunk without fetching; returns the device token
        tensor and advances pos by n_steps."""
        engine = self.engine
        engine._faults.fire("engine.decode_dispatch")
        with engine._tel.span("decode_chunk_dispatch", pos=self.pos, steps=n_steps):
            tokens, self.cache = engine.decode_chunk_fn(
                first_token, self.cache, self.pos, n_steps, float(temperature), float(topp), int(topk), seed32)
        self.pos += n_steps
        self.forwards += n_steps
        return tokens

    def decode_chunk(self, first_token: int, n_steps: int, temperature, topp, seed=0, topk=0) -> np.ndarray:
        """Decode ``n_steps`` tokens in one chunk; returns them on the host."""
        sw = Stopwatch()
        tokens = self._dispatch_chunk(
            first_token, n_steps, temperature, topp, topk, prng.fold_seed(seed)
        ).cpu().numpy()
        per_token_ms = sw.elapsed_ms() / n_steps
        self.stats.extend([self._entry(per_token_ms)] * n_steps)
        self._note_decode(n_steps, per_token_ms, device_sampled=True)
        return tokens

    def generate_chunks(self, first_token, temperature: float = 0.0, topp: float = 0.9,
                        seed: int = 0, chunk: int = 32, limit: int | None = None,
                        emit_first: bool = False, topk: int = 0):
        """Generator of device-decoded tokens, ``chunk`` per dispatch.
        ``first_token`` is consumed first, not yielded (a host int, or a
        :meth:`prefill_device` scalar: with ``emit_first`` that unseen token
        is fetched and yielded before chunk 1 is issued, since issuing a
        chunk is host work that would hold it back). Chunk k+1 is issued
        off chunk k's device-resident last token before chunk k is fetched.
        ``limit`` stops issuing once pos reaches it (the last chunk may
        overshoot: callers that stop early must ``rollback``)."""
        engine = self.engine
        seed32 = prng.fold_seed(seed)
        stop = engine.cfg.seq_len if limit is None else min(limit, engine.cfg.seq_len)
        if emit_first:
            yield self._fetch_fused_first(first_token)
        if self.pos >= stop:
            return
        if isinstance(first_token, (int, np.integer)):
            first_token = int(first_token)
        k = min(chunk, engine.cfg.seq_len - self.pos)
        pending = self._dispatch_chunk(first_token, k, temperature, topp, topk, seed32)
        fetch, pending_n = HostFetch(pending), k
        while True:
            sw = Stopwatch()
            if self.pos < stop:
                k = min(chunk, engine.cfg.seq_len - self.pos)
                nxt = self._dispatch_chunk(pending[-1], k, temperature, topp, topk, seed32)
                nxt_fetch = HostFetch(nxt)
            else:
                nxt, k = None, 0
            engine._faults.fire("engine.fetch")
            with engine._tel.span("decode_chunk_fetch", tokens=pending_n):
                toks = fetch.wait()
            per_token_ms = sw.elapsed_ms() / pending_n
            self.stats.extend([self._entry(per_token_ms)] * pending_n)
            self._note_decode(pending_n, per_token_ms, device_sampled=True)
            for t in toks.tolist():
                yield int(t)
            if nxt is None:
                return
            pending, fetch, pending_n = nxt, nxt_fetch, k

    def stream_decode(self, first_token, on_token, temperature: float = 0.0, topp: float = 0.9,
                      seed: int = 0, chunk: int = 32, limit: int | None = None,
                      first_prev: int | None = None, spec_draft: int = 0, spec_ngram: int = 3,
                      prompt_tokens=None, topk: int = 0) -> int:
        """Drive the chunked decode with host-side stop handling.
        ``on_token(prev, token) -> bool`` is called per decoded token (False
        stops). With ``first_prev`` set, ``first_token`` is an unseen
        :meth:`prefill_device` scalar that is also passed to ``on_token``.
        On exit the position is rewound to just after the last decoded
        token's feed. Returns the number of decoded tokens.

        ``spec_draft`` > 0 routes through self-speculative decoding
        (:meth:`_stream_decode_spec`): prompt-lookup drafts over
        ``prompt_tokens`` and the emitted output are verified up to
        ``spec_draft`` at a time in one weight read per step. Greedy output
        is the same either way. Single-device engines only: under tensor
        parallelism it is ignored with a one-time warning, as in the JAX
        package; so it is for MoE models, whose verify windows would take the
        all-experts path, which has no decode parity contract (the batch
        scheduler's gate too)."""
        if spec_draft and spec_draft > 0:
            if self.engine.tp_backend is None and not self.engine.cfg.is_moe:
                return self._stream_decode_spec(first_token, on_token, temperature, topp, seed, spec_draft,
                                                spec_ngram, limit, first_prev, prompt_tokens, topk)
            if not self.engine._spec_fallback_warned:
                self.engine._spec_fallback_warned = True
                reason = ("single-chip backend only for now" if self.engine.tp_backend is not None
                          else "MoE verify windows have no decode parity contract")
                print(f"⚠️ --spec-draft ignored: {reason}; plain chunked decode")
        start_pos = self.pos
        consumed = 0
        fused_first = first_prev is not None
        prev = first_prev if fused_first else int(first_token)
        try:
            for t in self.generate_chunks(first_token, temperature, topp, seed=seed, chunk=chunk,
                                          limit=limit, emit_first=fused_first, topk=topk):
                consumed += 1
                keep_going = on_token(prev, t)
                prev = t
                fed = consumed - 1 if fused_first else consumed
                if keep_going is False:
                    break
                if limit is not None and start_pos + fed >= limit:
                    break
        finally:
            fed = max(consumed - 1, 0) if fused_first else consumed
            self.rollback(min(start_pos + fed, self.pos))
        # the stream is drained here: the quiescent point where a due
        # re-measurement of the transfer share cannot time queued compute
        self.engine.refresh_transfer()
        return consumed

    def _stream_decode_spec(self, first_token, on_token, temperature: float, topp: float, seed: int,
                            spec_draft: int, spec_ngram: int, limit: int | None, first_prev: int | None,
                            prompt_tokens, topk: int = 0) -> int:
        """Self-speculative decode: per step the host drafts up to
        ``spec_draft`` tokens by prompt lookup over the prompt and the
        output so far, one verify forward scores draft and bonus positions
        in a single weight read, and the on-device accept/reject keeps the
        longest valid prefix: 1..k+1 tokens per weight read. Each step is
        issued and fetched before the next, by design: the next drafts
        depend on this step's tokens. The [T+1] result comes back through
        :class:`HostFetch`."""
        from distributed_llama_tpu_torch.engine.speculative import PromptLookupDrafter

        engine = self.engine
        tel = engine._tel
        seed32 = prng.fold_seed(seed)
        stop = engine.cfg.seq_len if limit is None else min(limit, engine.cfg.seq_len)
        drafter = PromptLookupDrafter(spec_draft, max_ngram=spec_ngram)
        # the lookup corpus: the prompt (without the first decoded token,
        # appended below) and everything emitted
        history = [int(t) for t in (prompt_tokens if prompt_tokens is not None else [])]
        start_pos = self.pos
        fused = first_prev is not None
        consumed = 0
        keep = True
        try:
            if fused:
                # the drafter needs the first token's host value before it
                # can propose anything: this fetch is the step boundary
                prev = self._fetch_fused_first(first_token)
                consumed = 1
                history.append(prev)
                keep = on_token(first_prev, prev)
            else:
                prev = int(first_token)
                history.append(prev)
            while keep is not False:
                fed = consumed - 1 if fused else consumed
                if start_pos + fed >= stop:
                    break
                # the window never writes past seq_len: it shrinks at the tail
                T = min(spec_draft + 1, engine.cfg.seq_len - self.pos)
                if T < 1:
                    break
                draft = drafter.draft(history, limit=T - 1)
                feed = np.full(T, prev, np.int64)  # padding positions write stale K/V
                feed[1 : 1 + len(draft)] = draft
                engine._faults.fire("engine.spec_verify")
                sw = Stopwatch()
                with tel.span("spec_verify", pos=self.pos, window=T, drafted=len(draft)):
                    out_dev, self.cache = sampling.spec_verify_step(
                        engine.cfg, engine.params, to_device(feed, engine.device), self.cache, self.pos,
                        len(draft), float(temperature), float(topp), int(topk), seed32, engine.q40_path)
                    out = HostFetch(out_dev).wait()  # [T+1]: n_emit, tokens...
                self.forwards += 1
                n_emit = max(1, min(int(out[0]), T))
                toks = [int(t) for t in out[1 : 1 + n_emit]]
                self.pos += n_emit
                step_ms = sw.elapsed_ms()
                self.stats.append(self._entry(step_ms, n_emit))
                if tel.enabled:
                    tel.tokens_generated.inc(n_emit)
                    tel.device_sampled_tokens.inc(n_emit)
                    tel.decode_latency.observe(step_ms / n_emit / 1000.0)
                    tel.kv_occupancy.set(self.pos / engine.cfg.seq_len)
                    tel.spec_draft_tokens.inc(len(draft))
                    tel.spec_accepted_tokens.inc(n_emit - 1)
                    if draft:
                        tel.spec_acceptance.observe((n_emit - 1) / len(draft))
                    tel.spec_step_advance.observe(n_emit)
                for t in toks:
                    consumed += 1
                    history.append(t)
                    keep = on_token(prev, t)
                    prev = t
                    fed = consumed - 1 if fused else consumed
                    if keep is False or start_pos + fed >= stop:
                        break
        finally:
            # positions past the last consumed token (a rejected draft, or
            # tokens emitted past an early stop) are stale: rewind to it
            fed = max(consumed - 1, 0) if fused else consumed
            self.rollback(min(start_pos + fed, self.pos))
        return consumed


class InferenceEngine:
    """One model instance. ``dtype`` is "q40" (4-bit weights through the
    CUDA kernels), torch.bfloat16 or torch.float32; ``cache_dtype`` is the
    KV cache's (default bf16 for q40, else the weights' dtype; "i8" stores
    int8 rows with per-(slot, head) scales); ``q40_path`` picks the int8
    kernel ("int8", the default) or the bf16 dequant kernel ("f32").
    ``device`` defaults to the card and raises without one; pass "cpu" to
    run the kernels' plain versions. ``tp`` > 1 runs that many
    tensor-parallel ranks, all on ``device``, summed by the ``allreduce``
    arm ("psum", "ring_xla" or "ring": K4 and K5); a list of several
    devices raises NotImplementedError. A MoE model runs at any ``tp``,
    each rank holding a hidden slice of every expert.
    ``moe_capacity_factor`` > 0 opts a MoE model's Q40 prefill into
    capacity-bucketed experts (lossy: overflow rows drop).

    ``sp`` > 1 cuts the KV cache's sequence over that many
    sequence-parallel ranks (:mod:`parallel.context_parallel`: the
    ring-attention prefill of a long prompt, the chunked prefill of the
    rest), ``ep`` > 1 gives each of that many expert-parallel ranks whole
    experts of a MoE model (:mod:`parallel.expert_parallel`); each composes
    with ``tp`` on the same card, the two not with each other (ValueError).
    Both are single-stream backends: the batch scheduler refuses them.

    ``hosts`` (a :class:`parallel.hosts.HostGroup` of several processes):
    worker mode. The ``tp`` ranks (``tp x sp``, ``tp x ep``) spread over
    the group's processes in the JAX mesh's order
    (:func:`parallel.hosts.rank_placement`), this one running its host's
    run of them on its own card; the backend is built before the weights,
    as in the JAX engine, and only this process's ranks' shards (and under
    ``ep`` its ep ranks' experts) are read (:attr:`bytes_read` counts the
    file bytes the load read, :func:`engine.weights.read_share` states
    them)."""

    TRANSFER_REFRESH_TOKENS = 512
    # True for a pod slice's engine, whose params object other engines read
    # too: an injected weight corruption then corrupts a copy of its own
    shares_params = False

    def __init__(self, model_path: str, dtype="q40", max_seq_len: int | None = None,
                 device="cuda", q40_path: str = "int8", cache_dtype=None, tp: int = 1,
                 allreduce: str = "psum", moe_capacity_factor: float = 0.0, sp: int = 1, ep: int = 1,
                 hosts=None):
        from distributed_llama_tpu_torch.formats.model_file import ModelFileReader
        from distributed_llama_tpu_torch.models.config import config_from_spec

        if q40_path not in PATHS:
            raise ValueError(f"unknown q40 path {q40_path!r}; expected one of {PATHS}")
        if ep > 1 and sp > 1:
            raise ValueError("--ep and --sp do not compose (pick one FFN/context strategy)")
        from distributed_llama_tpu_torch.ops.collectives import spans_hosts

        hosts = hosts if spans_hosts(hosts) else None
        self.q40_path = q40_path
        # the instrument bundle and the fault plan, bound once: null
        # instruments unless telemetry was enabled before this engine was
        # built, the no-op plan unless a fault plan was installed first
        self._tel = telemetry.EngineInstruments()
        self._faults = faults.active_plan()
        reader = ModelFileReader(model_path)
        self.spec = reader.spec.clamp_seq_len(max_seq_len)
        self.cfg = config_from_spec(self.spec, moe_capacity_factor=moe_capacity_factor)
        from distributed_llama_tpu_torch.parallel import tensor_parallel

        if isinstance(device, (list, tuple)):  # one device per rank: several cards raise
            device = tensor_parallel.rank_devices(tp, devices=device)[0]
        self.device = resolve_device(device, None if hosts is None else hosts.host_id)
        self.tp, self.sp, self.ep = tp, sp, ep
        # the parallel backend, or None on one rank: expert parallelism
        # (optionally over tp), sequence parallelism (likewise), or tensor
        # parallelism alone; all share the tp backend's params layout
        self.tp_backend = None
        quantized = dtype == weights_lib.QUANTIZED_DTYPE
        if ep > 1:
            from distributed_llama_tpu_torch.parallel import expert_parallel

            self.tp_backend = expert_parallel.ExpertParallelForward(
                self.cfg, ep, tp=tp, device=self.device, quantized=quantized, allreduce=allreduce, hosts=hosts)
        elif sp > 1:
            from distributed_llama_tpu_torch.parallel import context_parallel

            self.tp_backend = context_parallel.SequenceParallelForward(
                self.cfg, sp, tp=tp, device=self.device, quantized=quantized, allreduce=allreduce, hosts=hosts)
        elif tp > 1:
            self.tp_backend = tensor_parallel.TensorParallelForward(
                self.cfg, tp, device=self.device, quantized=quantized, allreduce=allreduce, hosts=hosts)
        elif hosts is not None:
            raise ValueError(f"worker mode needs --tp (times --sp or --ep) a multiple of --num-hosts "
                             f"{hosts.num_hosts}, got {tp}")
        if cache_dtype is None:
            # q40 is a weights-only format; its KV cache is bf16
            cache_dtype = torch.bfloat16 if dtype == weights_lib.QUANTIZED_DTYPE else dtype
        self.cache_dtype = cache_dtype
        self.params = weights_lib.load_params(
            reader, self.cfg, dtype=dtype, device=self.device, tp=tp, ep=ep,
            ranks=None if hosts is None else self.tp_backend.ranks,
            experts=None if hosts is None or ep == 1 else self.tp_backend.local_experts)
        self.bytes_read = reader.bytes_read
        reader.close()
        self._init_runtime()

    @classmethod
    def from_backend(cls, cfg: LlamaConfig, backend, params, cache_dtype=torch.bfloat16, spec=None,
                     q40_path: str = "int8") -> "InferenceEngine":
        """An engine over a pre-built tensor-parallel backend and its
        already-placed per-rank params: the one-process pod's slice engines
        (:mod:`parallel.pod`) share the backend and the params object, while
        each keeps its own caches, streams and stats. A slice rebuild goes
        through here too, so weights are never reloaded."""
        self = cls.__new__(cls)
        if q40_path not in PATHS:
            raise ValueError(f"unknown q40 path {q40_path!r}; expected one of {PATHS}")
        self.q40_path = q40_path
        self._tel = telemetry.EngineInstruments()
        self._faults = faults.active_plan()
        self.spec = spec
        self.cfg = cfg
        self.device = backend.devices[0]
        self.tp, self.sp, self.ep = backend.tp, 1, 1
        self.tp_backend = backend
        self.cache_dtype = cache_dtype
        self.params = params
        self.shares_params = True
        self._init_runtime()
        return self

    def _init_runtime(self) -> None:
        """Per-engine mutable state, shared by the loading constructor and
        :meth:`from_backend`."""
        self._default: EngineStream | None = None
        self._spec_fallback_warned = False
        self._transfer_ms = 0.0
        self._tokens = 0  # tokens covered by stats entries, the re-measurement cadence
        self._transfer_measured_at = 0
        # the load-time weight checksum, computed at its first read
        self._weights_checksum: str | None = None
        if self.tp_backend is not None:
            self._measure_transfer()
            # the serving shape on /metrics: ranks along each named axis
            tel = telemetry.MeshInstruments()
            if tel.enabled:
                for axis, size in self.tp_backend.mesh_shape.items():
                    tel.mesh_devices.labels(axis=axis).set(size)

    def _measure_transfer(self) -> None:
        """Run the backend's transfer probe. A failed probe (a flaky
        interconnect, an injected ``tp.transfer`` fault) keeps the last
        estimate (0 before the first) instead of failing the request that
        triggered it; the next cadence retries. In worker mode it raises:
        the probe's collectives span the processes, and a failure passed
        over (an IPC open, an event, a launch) would leave the hosts'
        collectives unpaired."""
        if self.tp_backend.hosts is not None:
            self._transfer_ms = self.tp_backend.measure_transfer_ms()
            return
        try:
            self._transfer_ms = self.tp_backend.measure_transfer_ms()
        except Exception:
            pass

    def weights_checksum(self) -> str:
        """The loaded weights' integrity checksum, cached after the first
        computation (:func:`integrity.params_checksum`: one pass over every
        leaf). Call it right after construction to record the healthy
        value; a later ``params_checksum(self.params)`` is the verify side.
        Under tensor parallelism it covers every rank's params."""
        if self._weights_checksum is None:
            from distributed_llama_tpu_torch.engine import integrity

            self._weights_checksum = integrity.params_checksum(self.params)
        return self._weights_checksum

    def forward_fn(self, tokens: torch.Tensor, cache, pos: int, n_real: int | None = None):
        """One forward of ``tokens`` from ``pos`` over this engine's params:
        (logits f32 [T, vocab], cache). ``n_real``: the real rows of a
        bucket-padded prompt (the capacity-bucketed MoE prefill's pad
        mask)."""
        if self.tp_backend is not None:
            return self.tp_backend.forward(self.params, tokens, cache, pos, self.q40_path, n_real=n_real)
        return llama.forward_tokens(self.cfg, self.params, tokens, cache, pos, self.q40_path, n_real=n_real)

    def decode_chunk_fn(self, first_token, cache, pos: int, n_steps: int, temperature: float, topp: float,
                        topk: int, seed32: int):
        """One decode chunk of ``n_steps`` steps: (tokens [n_steps] on the
        device, cache)."""
        if self.tp_backend is not None:
            return self.tp_backend.decode_chunk(self.params, first_token, cache, pos, n_steps, temperature,
                                                topp, topk, seed32, self.q40_path)
        return sampling.decode_chunk(self.cfg, self.params, first_token, cache, pos, n_steps, temperature, topp,
                                     topk, seed32, self.q40_path)

    def last_dispatches(self) -> int:
        """How many forwards the latest forward call issued on this thread
        (the sequence-parallel chunked prefill issues several; every other
        path one)."""
        return getattr(self.tp_backend, "last_forward_dispatches", 1) or 1

    def split_stats(self, ms: float, n_tokens: int = 1, n_dispatches: int = 1) -> TokenStats:
        """A stats entry with its transfer share: the measured collective
        time of one token's forward (an upper bound) once per dispatch the
        entry covers, clamped to the entry's time."""
        self._tokens += n_tokens
        transfer = min(self._transfer_ms * n_dispatches, ms)
        return TokenStats(ms, ms - transfer, transfer, n_tokens=n_tokens)

    def refresh_transfer(self) -> None:
        """Re-measure the transfer share when ``TRANSFER_REFRESH_TOKENS``
        tokens have passed since the last measurement (callers are at a
        quiescent point: nothing of theirs is queued on the device)."""
        if self.tp_backend is None or self._tokens - self._transfer_measured_at < self.TRANSFER_REFRESH_TOKENS:
            return
        self._measure_transfer()
        self._transfer_measured_at = self._tokens

    def _new_cache(self):
        if self.tp_backend is not None:
            return self.tp_backend.init_cache(self.cache_dtype)
        return llama.init_cache(self.cfg, self.cache_dtype, self.device)

    def new_stream(self) -> EngineStream:
        return EngineStream(self, self._new_cache())

    @property
    def default_stream(self) -> EngineStream:
        if self._default is None:
            self._default = self.new_stream()
        return self._default

    @property
    def pos(self) -> int:
        return self.default_stream.pos

    @property
    def stats(self) -> list[TokenStats]:
        return self.default_stream.stats

    def reset(self) -> None:
        self.default_stream.reset()

    def rollback(self, pos: int) -> None:
        self.default_stream.rollback(pos)

    def forward(self, tokens) -> np.ndarray:
        return self.default_stream.forward(tokens)

    def prefill(self, tokens) -> np.ndarray:
        return self.default_stream.prefill(tokens)

    def prefill_device(self, tokens, temperature, topp, seed: int, topk: int = 0):
        return self.default_stream.prefill_device(tokens, temperature, topp, seed, topk)

    def decode_step(self, token: int) -> np.ndarray:
        return self.default_stream.decode_step(token)

    def fetch_first_token(self, first_token) -> int:
        return self.default_stream.fetch_first_token(first_token)

    def generate_on_device(self, *args, **kwargs) -> np.ndarray:
        return self.default_stream.generate_on_device(*args, **kwargs)

    def decode_chunk(self, *args, **kwargs):
        return self.default_stream.decode_chunk(*args, **kwargs)

    def generate_chunks(self, *args, **kwargs):
        return self.default_stream.generate_chunks(*args, **kwargs)

    def stream_decode(self, *args, **kwargs) -> int:
        return self.default_stream.stream_decode(*args, **kwargs)

    def avg_stats(self) -> TokenStats:
        return self.default_stream.avg_stats()

    def total_tokens(self) -> int:
        return self.default_stream.total_tokens()
