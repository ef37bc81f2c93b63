"""The port's CLI: ``inference`` and ``generate`` modes on one GPU.

  python -m distributed_llama_tpu_torch.apps.cli generate --model m.m \\
      --tokenizer t.t --prompt "hello" --steps 64 --dtype q40 [--tp 2 --allreduce ring]

The prompt is prefilled in one batched forward; with ``--decode device``
(the default) the first token is sampled on the device and the decode runs
in chunks with sampling on the device; ``--decode host`` samples each token
on the host from fetched logits (the counter-mode sampler replays the
device stream token for token). ``--device cpu`` runs on the CPU with the
kernels' plain PyTorch versions; the default is the card. ``--tp N`` runs
N tensor-parallel ranks on that one device, their two all-reduces per layer
summed by the ``--allreduce`` arm. Mixtral and Grok-1 files run at ``--tp
1``; ``--moe-capacity F`` opts their Q40 prefill into capacity-bucketed
experts. ``--telemetry`` (or ``DLLAMA_TELEMETRY=1``) enables the metrics
registry and span tracer before the engine is built, and writes the run's
Chrome trace to ``--trace-out``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from distributed_llama_tpu_torch import telemetry
from distributed_llama_tpu_torch.engine.engine import InferenceEngine
from distributed_llama_tpu_torch.engine.weights import QUANTIZED_DTYPE
from distributed_llama_tpu_torch.formats.model_file import ArchType
from distributed_llama_tpu_torch.ops.collectives import IMPLS
from distributed_llama_tpu_torch.telemetry import Stopwatch
from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer, is_safe_piece

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "q40": QUANTIZED_DTYPE}
_CACHE_DTYPES = {"auto": None, "bf16": torch.bfloat16, "f32": torch.float32, "i8": "i8"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama-torch")
    p.add_argument("mode", choices=["inference", "generate"])
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--topk", type=int, default=0, help="top-k filter (0 = off)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--dtype", choices=list(_DTYPES), default="q40",
                   help="weight dtype on the device (q40 = packed 4-bit through the CUDA kernels)")
    p.add_argument("--q40-path", choices=["int8", "f32"], default="int8",
                   help="Q40 kernel: int8 (Q80 activations, int8 block dots) or f32 "
                   "(bf16 dequantize-in-registers)")
    p.add_argument("--chat-template", default=None, choices=[None, "llama2", "llama3", "zephyr", "chatml"],
                   help="chat template of the API server (default: sniffed from the tokenizer)")
    p.add_argument("--decode", choices=["device", "host"], default="device")
    p.add_argument("--decode-chunk", type=int, default=32, help="tokens per device decode chunk")
    p.add_argument("--spec-draft", type=int, default=0,
                   help="self-speculative decoding: up to K prompt-lookup draft tokens (n-gram matches over "
                   "the request's own prompt and output) verified per step in one weight read; greedy output "
                   "equals plain decode. 0 (default) = off; --decode device only")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="widest n-gram the prompt-lookup drafter matches (falls through to shorter ones)")
    p.add_argument("--cache-dtype", choices=list(_CACHE_DTYPES), default="auto",
                   help="KV cache dtype (auto = bf16, or f32 with --dtype f32); i8 stores int8 rows with "
                   "per-(slot, head) scales: half the cache memory of bf16")
    p.add_argument("--moe-capacity", type=float, default=0.0,
                   help="MoE prefill capacity factor: per-expert buckets hold ceil(F*T*k/E) rows and overflow rows "
                   "DROP (lossy). 0 (default) = exact: every expert computes every prompt row. Applies to the q40 "
                   "experts at prompts of >= 32 tokens")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (a power of two), all on --device")
    p.add_argument("--allreduce", choices=list(IMPLS), default="psum",
                   help="all-reduce of the tensor-parallel ranks: psum (the plain sum in rank order), ring_xla "
                   "(the plain ring schedule) or ring (the hand-written ring kernel, fused with the int8 "
                   "matmul for wo/down at T <= 8)")
    p.add_argument("--telemetry", action="store_true", default=False,
                   help="enable the telemetry subsystem: metrics registry (served at GET /metrics by the API "
                   "server) + span tracer (Chrome trace JSON written to --trace-out after a generate/inference "
                   "run). DLLAMA_TELEMETRY=1 in the environment enables it too; off by default — disabled "
                   "instruments are no-ops on the decode hot path")
    p.add_argument("--trace-out", default="dllama-trace.json", metavar="PATH",
                   help="where a --telemetry generate/inference run writes its Chrome trace-event JSON (open in "
                   "chrome://tracing or ui.perfetto.dev)")
    return p


def make_engine(args):
    engine = InferenceEngine(
        args.model, dtype=_DTYPES[args.dtype], max_seq_len=args.max_seq_len,
        device=args.device, q40_path=args.q40_path,
        cache_dtype=_CACHE_DTYPES[getattr(args, "cache_dtype", "auto")],
        tp=getattr(args, "tp", 1), allreduce=getattr(args, "allreduce", "psum"),
        moe_capacity_factor=getattr(args, "moe_capacity", 0.0) or 0.0,
    )
    tokenizer = Tokenizer.from_file(args.tokenizer, engine.cfg.vocab_size)
    # wall-clock as entropy for a default sampling seed, never a duration
    seed = args.seed if args.seed is not None else int(time.time())
    sampler = Sampler(
        vocab_size=engine.cfg.vocab_size, temperature=args.temperature, topp=args.topp,
        topk=args.topk, seed=seed,
    )
    return engine, tokenizer, sampler


def _print(s: str) -> None:
    sys.stdout.write(s)
    sys.stdout.flush()


def generate(args, benchmark: bool, built=None) -> dict:
    """The generate/inference loop. ``built`` is a ``make_engine(args)``
    triple to reuse (its engine continues from its current position and
    takes ``args.q40_path``).
    Returns the generated token ids and the timing summary."""
    if args.prompt is None:
        raise SystemExit("Prompt is required")
    engine, tokenizer, sampler = built if built is not None else make_engine(args)
    engine.q40_path = args.q40_path  # a reused engine runs this call's kernel path
    # Grok-1 prompts start without BOS, as in the JAX package's CLI
    prompt_tokens = tokenizer.encode(args.prompt, add_bos=engine.cfg.arch != ArchType.GROK1)
    n_prompt = len(prompt_tokens)
    if n_prompt < 1:
        raise SystemExit("Expected at least 1 prompt token")

    total_sw = Stopwatch()
    if args.decode == "device":
        first_dev = engine.prefill_device(
            prompt_tokens, args.temperature, args.topp, seed=sampler.seed, topk=args.topk
        )
        logits = None
    else:
        logits = engine.prefill(prompt_tokens)
    p_entry = engine.stats[-1]
    p_printed = False
    if benchmark and args.decode != "device":
        _print(f"🔷 P {p_entry.generation_ms:5.0f} ms ({n_prompt} prompt tokens) ")
        p_printed = True
    _print(tokenizer.decode(prompt_tokens))
    if benchmark:
        _print("\n")

    def print_p_line() -> None:
        nonlocal p_printed
        if benchmark and not p_printed:
            _print(f"🔷 P {p_entry.generation_ms:5.0f} ms ({n_prompt} prompt tokens)\n")
            p_printed = True

    out: list[int] = []

    def emit(prev: int, tok: int) -> None:
        print_p_line()
        stats = engine.stats[-1]
        if benchmark:
            _print(f"🔶 G {stats.generation_ms:4.0f} ms I {stats.inference_ms:4.0f} ms "
                   f"T {stats.transfer_ms:4.0f} ms ")
        piece = tokenizer.decode_piece(prev, tok)
        if is_safe_piece(piece):
            _print(piece.decode("utf-8", errors="replace"))
        if benchmark:
            _print("\n")
        out.append(tok)

    if args.decode == "device":
        def on_token(prev: int, t: int) -> bool:
            if t == tokenizer.bos_id:
                return False  # BOS delimits sequences
            emit(prev, t)
            return True

        engine.stream_decode(
            first_dev, on_token, args.temperature, args.topp, seed=sampler.seed,
            chunk=args.decode_chunk, limit=args.steps, first_prev=prompt_tokens[-1],
            spec_draft=getattr(args, "spec_draft", 0), spec_ngram=getattr(args, "spec_ngram", 3),
            prompt_tokens=prompt_tokens, topk=args.topk,
        )
        print_p_line()
    else:
        token = prompt_tokens[-1]
        next_token = sampler.sample(logits, pos=engine.pos - 1)
        if next_token != tokenizer.bos_id:
            emit(token, next_token)
            token = next_token
            while engine.pos < args.steps:
                logits = engine.decode_step(token)
                next_token = sampler.sample(logits, pos=engine.pos - 1)
                if next_token == tokenizer.bos_id:
                    break
                emit(token, next_token)
                token = next_token

    avg = engine.avg_stats()
    total_ms = total_sw.elapsed_ms()
    n = max(1, engine.total_tokens())
    _print("\n")
    _print(f"Generated tokens:    {len(out)}\n")
    _print(f"Avg tokens / second: {1000.0 * n / max(total_ms, 1e-9):.2f}\n")
    _print(f"Avg generation time: {avg.generation_ms:.2f} ms\n")
    _print(f"Avg inference time:  {avg.inference_ms:.2f} ms\n")
    _print(f"Avg transfer time:   {avg.transfer_ms:.2f} ms\n")
    return {
        "prompt_tokens": prompt_tokens,
        "tokens": out,
        "prefill_ms": p_entry.generation_ms,
        "total_ms": total_ms,
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # before the engine is built: instruments bind at construction
    if args.telemetry:
        telemetry.enable()
    out = generate(args, benchmark=args.mode == "inference")
    if telemetry.is_enabled():
        path = telemetry.export_chrome_trace(args.trace_out)
        _print(f"📊 telemetry: Chrome trace written to {path}\n")
    return out


if __name__ == "__main__":
    main()
