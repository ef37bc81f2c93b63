"""KV-cached inference engine on one device: prefill + chunked device decode.

:class:`InferenceEngine` owns the config and the weights; the mutable decode
state (KV cache, position, stats) lives in :class:`EngineStream`, and the
engine delegates the single-stream surface to a default stream. Decode runs
in chunks: each chunk is ``chunk`` forward+sample steps issued back to back
with the sampled token fed to the next step on the device, and the next
chunk is issued before the previous chunk's tokens are fetched.

Every stats entry covers the host time of its dispatch plus fetch; on a
single device there is no transfer share (``transfer_ms`` is 0).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from distributed_llama_tpu_torch import prng
from distributed_llama_tpu_torch.engine import weights as weights_lib
from distributed_llama_tpu_torch.models import llama, sampling
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops.q40 import PATHS
from distributed_llama_tpu_torch.platform import resolve_device


def next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _prefill_bucket(n: int) -> int:
    """Prompt lengths pad to power-of-two buckets (floor 8), as in the JAX
    package, so both take the same attention branch for a prompt."""
    return max(8, next_pow2(n))


class Stopwatch:
    def __init__(self):
        self._start = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._start) * 1000.0


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


class EngineStream:
    """One generation stream: its own KV cache, position and stats over the
    engine's weights."""

    def __init__(self, engine: "InferenceEngine", cache):
        self.engine = engine
        self.cache = cache
        self.pos = 0
        self.stats: list[TokenStats] = []
        # forward passes issued (a prefill is one, a decode chunk n_steps)
        self.forwards = 0
        # the prefill_device entry awaiting its compute-drain time
        self._pending_prefill_entry: TokenStats | None = None

    @property
    def cfg(self) -> LlamaConfig:
        return self.engine.cfg

    def reset(self) -> None:
        self.pos = 0
        self.stats.clear()
        self._pending_prefill_entry = None

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
        n = tokens.shape[0]
        if n == 0:
            raise ValueError("empty token batch: at least one token required")
        if self.pos + n > engine.cfg.seq_len:
            raise ValueError(f"context overflow: pos {self.pos} + {n} > {engine.cfg.seq_len}")
        padded = tokens
        if n > 1:
            bucket = _prefill_bucket(n)
            if self.pos + bucket > engine.cfg.seq_len:
                bucket = n  # exact length near the context limit
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:n] = tokens
        toks = torch.from_numpy(np.asarray(padded, np.int64)).to(engine.device)
        logits, self.cache = llama.forward_tokens(
            engine.cfg, engine.params, toks, self.cache, self.pos, engine.q40_path
        )
        self.pos += n
        self.forwards += 1
        return logits

    def forward(self, tokens) -> np.ndarray:
        """f32 logits [T, vocab] of tokens run at the current position."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        logits = self._forward_device(tokens)[:n].cpu().numpy()
        self.stats.append(_stats(sw.elapsed_ms(), n))
        return logits

    def prefill(self, tokens) -> np.ndarray:
        """Process a prompt in one batched step; returns last-token logits."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        logits = self._forward_device(tokens)[n - 1].cpu().numpy()
        self.stats.append(_stats(sw.elapsed_ms(), n))
        return logits

    def prefill_device(self, tokens, temperature, topp, seed: int, topk: int = 0) -> torch.Tensor:
        """Prefill and sample the first generated token on the device;
        returns it as a device scalar, not fetched. Its coin is keyed on the
        last prompt token's position. The stats entry gains the prefill's
        drain time when the token is fetched."""
        tokens = np.asarray(tokens, dtype=np.int64)
        n = tokens.shape[0]
        sw = Stopwatch()
        logits = self._forward_device(tokens)
        token = sampling.sample_token(
            logits[n - 1], prng.fold_seed(seed), self.pos - 1, float(temperature),
            float(topp), int(topk),
        )
        entry = _stats(sw.elapsed_ms(), n)
        self.stats.append(entry)
        self._pending_prefill_entry = entry
        return token

    def decode_step(self, token: int) -> np.ndarray:
        """One autoregressive step; returns f32 logits [vocab]."""
        return self.forward([token])[0]

    def _dispatch_chunk(self, first_token, n_steps: int, temperature, topp, topk, seed32: int):
        """Issue one decode chunk without fetching; returns the device token
        tensor and advances pos by n_steps."""
        engine = self.engine
        tokens, self.cache = sampling.decode_chunk(
            engine.cfg, engine.params, first_token, self.cache, self.pos, n_steps,
            float(temperature), float(topp), int(topk), seed32, engine.q40_path,
        )
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
        self.stats.extend([_stats(per_token_ms)] * n_steps)
        return tokens

    def generate_chunks(self, first_token, temperature: float = 0.0, topp: float = 0.9,
                        seed: int = 0, chunk: int = 32, limit: int | None = None,
                        emit_first: bool = False, topk: int = 0):
        """Generator of device-decoded tokens, ``chunk`` per dispatch.
        ``first_token`` is consumed first, not yielded (a host int, or a
        :meth:`prefill_device` scalar: with ``emit_first`` that unseen token
        is fetched and yielded after chunk 1 is issued). Chunk k+1 is issued
        off chunk k's device-resident last token before chunk k is fetched.
        ``limit`` stops issuing once pos reaches it (the last chunk may
        overshoot: callers that stop early must ``rollback``)."""
        engine = self.engine
        seed32 = prng.fold_seed(seed)
        stop = engine.cfg.seq_len if limit is None else min(limit, engine.cfg.seq_len)
        if self.pos >= stop:
            if emit_first:
                yield self._fetch_fused_first(first_token)
            return
        if isinstance(first_token, (int, np.integer)):
            first_token = int(first_token)
        k = min(chunk, engine.cfg.seq_len - self.pos)
        pending = self._dispatch_chunk(first_token, k, temperature, topp, topk, seed32)
        pending_n = k
        if emit_first:
            yield self._fetch_fused_first(first_token)
        while True:
            sw = Stopwatch()
            if self.pos < stop:
                k = min(chunk, engine.cfg.seq_len - self.pos)
                nxt = self._dispatch_chunk(pending[-1], k, temperature, topp, topk, seed32)
            else:
                nxt, k = None, 0
            toks = pending.cpu().numpy()
            per_token_ms = sw.elapsed_ms() / pending_n
            self.stats.extend([_stats(per_token_ms)] * pending_n)
            for t in toks.tolist():
                yield int(t)
            if nxt is None:
                return
            pending, pending_n = nxt, k

    def fetch_first_token(self, first_token) -> int:
        """Fetch a :meth:`prefill_device` token without starting a decode."""
        return self._fetch_fused_first(first_token)

    def _fetch_fused_first(self, first_token) -> int:
        sw = Stopwatch()
        tok = int(first_token.item()) if isinstance(first_token, torch.Tensor) else int(first_token)
        entry = self._pending_prefill_entry
        if entry is not None:
            drained = sw.elapsed_ms()
            entry.generation_ms += drained
            entry.inference_ms += drained
            self._pending_prefill_entry = None
        return tok

    def stream_decode(self, first_token, on_token, temperature: float = 0.0, topp: float = 0.9,
                      seed: int = 0, chunk: int = 32, limit: int | None = None,
                      first_prev: int | None = None, topk: int = 0) -> int:
        """Drive the chunked decode with host-side stop handling.
        ``on_token(prev, token) -> bool`` is called per decoded token (False
        stops). With ``first_prev`` set, ``first_token`` is an unseen
        :meth:`prefill_device` scalar that is also passed to ``on_token``.
        On exit the position is rewound to just after the last decoded
        token's feed. Returns the number of decoded tokens."""
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
        return consumed

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


class InferenceEngine:
    """One model instance on one device. ``dtype`` is "q40" (4-bit weights
    through the CUDA kernels), torch.bfloat16 or torch.float32 (the KV cache
    takes bf16 for q40, else the weights' dtype);
    ``q40_path`` picks the int8 kernel ("int8", the default) or the bf16
    dequant kernel ("f32"). ``device`` defaults to the card and raises
    without one; pass "cpu" to run the kernels' plain versions."""

    def __init__(self, model_path: str, dtype="q40", max_seq_len: int | None = None,
                 device="cuda", q40_path: str = "int8"):
        from distributed_llama_tpu_torch.formats.model_file import ModelFileReader
        from distributed_llama_tpu_torch.models.config import config_from_spec

        self.device = resolve_device(device)
        if q40_path not in PATHS:
            raise ValueError(f"unknown q40 path {q40_path!r}; expected one of {PATHS}")
        self.q40_path = q40_path
        reader = ModelFileReader(model_path)
        self.spec = reader.spec.clamp_seq_len(max_seq_len)
        self.cfg = config_from_spec(self.spec)
        # q40 is a weights-only format; its KV cache is bf16
        self.cache_dtype = torch.bfloat16 if dtype == weights_lib.QUANTIZED_DTYPE else dtype
        self.params = weights_lib.load_params(reader, self.cfg, dtype=dtype, device=self.device)
        reader.close()
        self._default: EngineStream | None = None

    def _new_cache(self):
        return llama.init_cache(self.cfg, self.cache_dtype, self.device)

    def new_stream(self) -> EngineStream:
        return EngineStream(self, self._new_cache())

    @property
    def default_stream(self) -> EngineStream:
        if self._default is None:
            self._default = EngineStream(self, self._new_cache())
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
