"""Tensor parallelism: ``tp`` ranks in lockstep, all on one card.

The layout is the JAX package's (and the reference's slicing): q/k/v and
gate/up are output-sharded, wo and down input-sharded, each rank runs
``n_heads/tp`` attention heads over its ``n_kv_heads/tp`` cache heads, and
wcls is vocab-sharded when the vocab divides. The two all-reduces per layer
(after wo and after down) go through :mod:`ops.collectives`, whose ``ring``
arm is the hand-written K4 (and K5, the int8 matmul fused into it). A MoE
layer (Mixtral, Grok-1) replicates its router and gives every rank a hidden
slice of every expert; the routing is computed once per layer from the
byte-identical residual, each rank runs the chosen experts on its slice,
and the partial expert sums are all-reduced once (K4 under ``ring``: no
expert matmul is fused into the ring).

Where the JAX package maps one shard to one chip of a mesh, the port keeps
each rank as its own set of allocations (weight shards, KV cache,
activations) on the one card that ``device`` names; the replicated leaves
(embedding, norms, rope table) are one tensor that every rank reads. Ranks
on several cards need peer access or events between devices, which no
machine this port runs on yet offers to test, so asking for them raises.
"""

from __future__ import annotations

import time

import torch

from distributed_llama_tpu_torch import prng
from distributed_llama_tpu_torch.models import llama, sampling
from distributed_llama_tpu_torch.models.config import LlamaConfig
from distributed_llama_tpu_torch.ops import collectives
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.parallel import sharding
from distributed_llama_tpu_torch.platform import resolve_device
from distributed_llama_tpu_torch.quants import QK


def validate_tp(cfg: LlamaConfig, tp: int, quantized: bool = False) -> None:
    """The sharding-divisibility constraint: tp a power of two dividing the
    heads, kv heads and hidden dim (a MoE model's expert hidden dim too);
    for q40 the input-dim shards must land on quant-block boundaries (dim
    and hidden_dim divisible by tp*32)."""
    if tp < 1 or tp & (tp - 1):
        raise ValueError(f"tp must be a power of two, got {tp}")
    for name, value in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads), ("hidden_dim", cfg.hidden_dim)):
        if value % tp:
            raise ValueError(f"tp={tp} must divide {name}={value}")
    if quantized:
        for name, value in (("dim", cfg.dim), ("hidden_dim", cfg.hidden_dim)):
            if value % (tp * QK):
                raise ValueError(f"q40 tp={tp} needs {name}={value} divisible by {tp * QK}")


def rank_devices(tp: int, device="cuda", devices=None) -> list[torch.device]:
    """The device of every rank: ``tp`` times ``device``, or ``devices``
    when they all name one device; ranks on several devices raise
    NotImplementedError."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len({str(d) for d in devices}) > 1:
            raise NotImplementedError(collectives.SEVERAL_CARDS)
        if len(devices) != tp:
            raise ValueError(f"{len(devices)} devices for tp={tp}")
        device = devices[0]
    return [resolve_device(device)] * tp


class TensorParallelForward:
    """The tensor-parallel backend of :class:`engine.InferenceEngine`:
    forward, decode chunks, per-rank caches and the transfer probe. Params
    and caches are per-rank lists (``engine.weights.load_params(tp=...)``,
    :meth:`init_cache`)."""

    def __init__(self, cfg: LlamaConfig, tp: int, device="cuda", quantized: bool = False,
                 allreduce: str = "psum", devices=None):
        validate_tp(cfg, tp, quantized=quantized)
        if allreduce not in collectives.IMPLS:
            raise ValueError(f"unknown all-reduce {allreduce!r}; expected one of {collectives.IMPLS}")
        self.cfg = cfg
        self.tp = tp
        self.quantized = quantized
        self.allreduce = allreduce
        self.devices = rank_devices(tp, device, devices)
        self.shard_vocab = cfg.vocab_size % tp == 0

    def forward(self, params: list, tokens: torch.Tensor, caches: list, pos: int, path: str = "int8",
                n_real: int | None = None):
        """Logits f32 [T, vocab] (the all-gathered logits every rank holds)
        of T tokens from ``pos``; the per-rank caches are written in place.
        ``n_real``: the real rows of a bucket-padded prompt (the
        capacity-bucketed MoE prefill's pad mask)."""
        return llama.forward_tokens_tp(self.cfg, params, tokens, caches, pos, path, self.allreduce, n_real=n_real)

    def decode_chunk(self, params: list, first_token, caches: list, pos: int, n_steps: int, temperature: float,
                     topp: float, topk: int, seed32: int, path: str = "int8"):
        """``n_steps`` forward -> sample steps under TP, sampled on counter
        coins keyed (seed, position) from the replicated logits. Returns
        (tokens [n_steps] on the device, caches)."""
        return sampling.decode_chunk(self.cfg, params, first_token, caches, pos, n_steps, temperature, topp, topk,
                                     seed32, path, forward=lambda t, c, p: self.forward(params, t, c, p, path))

    def decode_loop(self, params: list, first_token, caches: list, pos: int, n_steps: int, temperature: float,
                    topp: float, seed: int = 0, topk: int = 0, path: str = "int8"):
        """:meth:`decode_chunk` with the request seed folded here."""
        return self.decode_chunk(params, first_token, caches, pos, n_steps, temperature, topp, topk,
                                 prng.fold_seed(seed), path)

    def init_cache(self, dtype=torch.bfloat16) -> list:
        """Per-rank, per-layer fused [2, S, K/tp, hd] cache leaves (int8
        with scales for "i8"), each rank's on its device."""
        cfg = self.cfg
        leaf = [2, cfg.seq_len, cfg.n_kv_heads, cfg.head_size]
        leaf[sharding.CACHE_KV_HEAD_AXIS] //= self.tp
        return [[kvc.init_fused(tuple(leaf[1:]), dtype, dev) for _ in range(cfg.n_layers)] for dev in self.devices]

    def _sync(self) -> None:
        if self.devices[0].type == "cuda":
            torch.cuda.synchronize(self.devices[0])

    def transfer_probe(self, n_tokens: int = 32):
        """(fn, args) replaying one decode step's collective sequence per
        token, ``n_tokens`` times: two all-reduces of a [1, dim] f32
        activation per layer through the same seam and arm as the forward,
        and the vocab all-gather when wcls is sharded."""
        cfg, tp = self.cfg, self.tp
        xs = [torch.ones((1, cfg.dim), dtype=torch.float32, device=d) for d in self.devices]
        lgs = [torch.ones((1, cfg.vocab_size // tp), dtype=torch.float32, device=d) for d in self.devices]
        inv = 1.0 / tp  # keeps the replayed sums finite

        def fn(xs, lgs):
            for _ in range(n_tokens):
                for _ in range(2 * cfg.n_layers):
                    xs = [x * inv for x in collectives.all_reduce(xs, self.allreduce)]
                if self.shard_vocab:
                    torch.cat([lg.to(self.devices[0]) for lg in lgs], dim=-1)
            return xs

        return fn, (xs, lgs)

    def measure_transfer_ms(self, n_tokens: int = 32) -> float:
        """Per-token collective time, replayed back to back between two
        synchronizes after one warm-up replay (an upper bound of what the
        forward spends in them). A failing probe raises."""
        fn, args = self.transfer_probe(n_tokens)
        fn(*args)
        self._sync()
        start = time.perf_counter()
        fn(*args)
        self._sync()
        return (time.perf_counter() - start) * 1e3 / n_tokens

    def transfer_bytes_per_token(self) -> int:
        """Payload bytes of the probed sequence per token: two [1, dim] f32
        all-reduces per layer, plus the vocab all-gather when sharded."""
        n = 2 * self.cfg.n_layers * self.cfg.dim * 4
        if self.shard_vocab:
            n += self.cfg.vocab_size * 4
        return n
