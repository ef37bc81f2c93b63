"""Prompt-lookup drafting for self-speculative decoding (host side); the
port's copy of the JAX package's ``engine/speculative.py``.

Speculative decoding (Leviathan et al., ICML 2023) turns the one-token-per-
weight-read decode step into k tokens per read: a cheap drafter proposes k
tokens, one verify forward scores all of them plus a bonus position in a
single weight read, and an accept/reject pass keeps the longest valid
prefix. Prompt-lookup decoding (Saxena, 2023) supplies the drafts with no
draft model: the request's own prompt + emitted output is the corpus, and
the most recent earlier occurrence of the current n-gram tail predicts the
continuation. On repetitive or structured output acceptance is high; on
novel text it falls to zero and the step is plain decode plus a k-token
verify overhead, which is why ``--spec-draft`` defaults off.

The drafter is host-side and stateful per request: matching is a few
microseconds of numpy against a <= seq_len token history, while the verify
forward (``models.llama.forward_verify_batched`` / ``forward_tokens``) and
the accept/reject (``models.sampling.spec_accept_rows``) run on the device.
"""

from __future__ import annotations

import numpy as np

# widest n-gram tried first: longer context keys make rarer but more
# accurate predictions; the ladder falls through to shorter n-grams like
# the reference prompt-lookup implementation
DEFAULT_MAX_NGRAM = 3

# most-recent candidate windows scanned per n-gram width: bounds a draft()
# call on pathological histories (a common token recurring hundreds of
# times with no matching continuation) — the batched scheduler drafts
# under its cond lock, so an unbounded scan would stall every co-batched
# lane's join/leave for the duration
MAX_SCAN_STARTS = 64


class PromptLookupDrafter:
    """Draft up to ``k`` continuation tokens by n-gram lookup over the
    request's own token history (prompt + emitted output).

    For ``n`` from ``max_ngram`` down to 1, the final ``n`` history tokens
    are searched for their most recent EARLIER occurrence; on a match the
    tokens that followed it are proposed. The most recent match wins (the
    continuation closest to the current context), and the draft never
    includes the match window itself, so a drafted token is always a
    genuine prediction.
    """

    def __init__(self, k: int, max_ngram: int = DEFAULT_MAX_NGRAM):
        if k < 1:
            raise ValueError(f"draft length must be >= 1, got {k}")
        if max_ngram < 1:
            raise ValueError(f"max n-gram must be >= 1, got {max_ngram}")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        # incremental mirror of the caller's history list (the serving
        # loops APPEND-ONLY to one list per request): re-converting the
        # whole list per step would be O(history) of lock-held host work in
        # the batched scheduler — the mirror copies only the new suffix
        self._src: list | None = None
        self._buf: np.ndarray | None = None
        self._len = 0
        # lifetime tokens proposed by this drafter (one drafter per
        # request): how much of the stream rode on speculation
        self.drafted_total = 0

    def _as_array(self, history) -> np.ndarray:
        if isinstance(history, np.ndarray):
            return np.ascontiguousarray(history, dtype=np.int64)
        n = len(history)
        if self._src is not history or n < self._len:
            # a new (or rewound) history list: rebuild the mirror. Holding
            # the reference keeps the identity check sound; the contract is
            # append-only mutation between rebuilds.
            self._src = history
            self._buf = np.asarray(history, dtype=np.int64)
            self._len = n
            return self._buf
        if n > self._len:
            if self._buf.shape[0] < n:
                grown = np.empty(max(n, 2 * self._buf.shape[0] + 8), np.int64)
                grown[: self._len] = self._buf[: self._len]
                self._buf = grown
            self._buf[self._len : n] = history[self._len :]
            self._len = n
        return self._buf[:n]

    def draft(self, history: list[int] | np.ndarray, limit: int | None = None) -> list[int]:
        """Up to ``min(k, limit)`` proposed continuation tokens of
        ``history`` (possibly none — no n-gram of the tail recurs)."""
        out = self._draft(history, limit)
        self.drafted_total += len(out)
        return out

    def _draft(self, history, limit: int | None) -> list[int]:
        budget = self.k if limit is None else min(self.k, int(limit))
        h = self._as_array(history)
        n_hist = h.shape[0]
        if budget < 1 or n_hist < 2:
            return []
        for n in range(min(self.max_ngram, n_hist - 1), 0, -1):
            tail = h[n_hist - n :]
            # candidate start positions of an EARLIER occurrence: windows
            # [j, j+n) strictly before the tail window itself
            starts = np.flatnonzero(h[: n_hist - n] == tail[0])
            if starts.size == 0:
                continue
            best: np.ndarray | None = None
            for j in reversed(starts[-MAX_SCAN_STARTS:].tolist()):  # most recent first
                # a window overlapping the tail is a valid periodic match —
                # it only has to START before the tail window does
                if np.array_equal(h[j : j + n], tail):
                    cont = h[j + n : j + n + budget]
                    if cont.size >= budget:
                        return [int(t) for t in cont]
                    # a match near the history end yields a short
                    # continuation; keep it but prefer an older match that
                    # can fill the whole budget (periodic histories always
                    # have one)
                    if best is None or cont.size > best.size:
                        best = cont
            if best is not None and best.size:
                return [int(t) for t in best]
        return []
