"""The port's CLI: ``inference`` and ``generate`` modes on one GPU.

  python -m distributed_llama_tpu_torch.apps.cli generate --model m.m \\
      --tokenizer t.t --prompt "hello" --steps 64 --dtype q40

The prompt is prefilled in one batched forward; with ``--decode device``
(the default) the first token is sampled on the device and the decode runs
in chunks with sampling on the device; ``--decode host`` samples each token
on the host from fetched logits (the counter-mode sampler replays the
device stream token for token). ``--device cpu`` runs on the CPU with the
kernels' plain PyTorch versions; the default is the card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from distributed_llama_tpu_torch.engine.engine import InferenceEngine, Stopwatch
from distributed_llama_tpu_torch.engine.weights import QUANTIZED_DTYPE
from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer, is_safe_piece

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "q40": QUANTIZED_DTYPE}


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
    p.add_argument("--decode", choices=["device", "host"], default="device")
    p.add_argument("--decode-chunk", type=int, default=32, help="tokens per device decode chunk")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def make_engine(args):
    engine = InferenceEngine(
        args.model, dtype=_DTYPES[args.dtype], max_seq_len=args.max_seq_len,
        device=args.device, q40_path=args.q40_path,
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
    prompt_tokens = tokenizer.encode(args.prompt, add_bos=True)
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
            chunk=args.decode_chunk, limit=args.steps, first_prev=prompt_tokens[-1], topk=args.topk,
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
    return generate(args, benchmark=args.mode == "inference")


if __name__ == "__main__":
    main()
