"""The port's CLI: ``inference``, ``generate`` and ``chat`` modes on one GPU.

  python -m distributed_llama_tpu_torch.apps.cli generate --model m.m \\
      --tokenizer t.t --prompt "hello" --steps 64 --dtype q40 [--tp 2 --allreduce ring]
  python -m distributed_llama_tpu_torch.apps.cli chat --model m.m --tokenizer t.t

The prompt is prefilled in one batched forward; with ``--decode device``
(the default) the first token is sampled on the device and the decode runs
in chunks with sampling on the device; ``--decode host`` samples each token
on the host from fetched logits (the counter-mode sampler replays the
device stream token for token). ``--device cpu`` runs on the CPU with the
kernels' plain PyTorch versions; the default is the card. ``--tp N`` runs
N tensor-parallel ranks on that one device, their two all-reduces per layer
summed by the ``--allreduce`` arm; Mixtral and Grok-1 files run under it
too, each rank holding a hidden slice of every expert. ``--sp N`` cuts the
KV cache's sequence over N ranks (a long prompt prefills in one
ring-attention pass, the rest in 32-token chunks), ``--ep N`` gives each of
N ranks whole experts of a MoE model; each composes with ``--tp`` on the
one device, not with each other. ``--pod DATAxMODEL``
builds a one-process pod (:mod:`parallel.pod`) and runs one slice of it:
``MODEL`` ranks over the one params tree the pod's slices share (the API
server serves every slice); it does not compose with ``--tp``.
``--moe-capacity F``
opts a MoE model's Q40 prefill into capacity-bucketed experts.
``--telemetry`` (or ``DLLAMA_TELEMETRY=1``) enables the metrics registry
and span tracer before the engine is built, and writes the run's Chrome
trace to ``--trace-out``.

``chat`` is the multi-turn REPL: a system prompt, then user turns read with
``input()``, each rendered by the tokenizer's chat template and fed against
the live KV cache (only the new turn's tokens; BOS only at position 0),
the sampler re-keyed per turn, the reply streamed until the chat EOS token
or a stop string, and ``(end of context)`` when the cache is full. The end
of its input ends the session.

``worker`` is ``generate`` over several processes: every process runs the
same command with ``--coordinator host:port --num-hosts H --host-id h``
(host 0 serves the rendezvous), forms the group (:mod:`parallel.hosts`),
holds 1/H of the ranks (``--tp``, or ``--tp`` x ``--sp`` / ``--ep`` in the
JAX mesh's order), reads only their shards of the `.m` file (under
``--ep`` only its ranks' experts), and prints the same tokens; host 0's
sampling seed is every host's. It writes no Chrome trace. ``--nthreads``,
``--buffer-float-type`` and ``--weights-float-type`` are accepted for
parity with the reference's command line and do nothing; a
``--kv-cache-storage`` other than ``ram`` is refused.
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
from distributed_llama_tpu_torch.tokenizer import (
    ChatItem,
    ChatTemplate,
    ChatTemplateType,
    EosDetector,
    EosDetectorResult,
    Sampler,
    Tokenizer,
    chat_stops,
    is_safe_piece,
)

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "q40": QUANTIZED_DTYPE}
_CACHE_DTYPES = {"auto": None, "bf16": torch.bfloat16, "f32": torch.float32, "i8": "i8"}
MODES = ("inference", "generate", "chat", "worker")
NO_COORDINATOR = ("worker mode needs --coordinator host:port, --num-hosts and --host-id "
                  "(every host runs the same program; start the root with the same flags "
                  "and --host-id 0)")
NO_PROMPT = ("worker mode requires the SAME --prompt (and --steps/--tp/--seed) "
             "as every other host: all hosts execute one SPMD program")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama-torch")
    p.add_argument("mode", choices=MODES)
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
                   help="chat template of chat mode and the API server (default: sniffed from the tokenizer)")
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
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel shards: KV cache sharded over the sequence, ring-attention prefill "
                   "(long-context mode; composes with --tp on a 2-D tp x sp mesh)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel shards (MoE models): each shard owns n_experts/ep whole experts; prefill "
                   "routes tokens with all_to_all dispatch/combine, decode runs local experts + psum (composes "
                   "with --tp on a 2-D tp x ep mesh)")
    p.add_argument("--pod", type=str, default=None, metavar="DATAxMODEL",
                   help="one-process pod serving (e.g. 2x2): DATA replica slices, each MODEL tensor-parallel ranks, "
                   "all over ONE shared weights tree on --device (no per-replica weight copies). The API server runs "
                   "one supervised replica per slice (a slice failure is a replica loss with failover replay, and "
                   "its rebuild never reloads weights); the CLI modes run one slice. Does not compose with --tp")
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
    # accepted for parity with the reference's command line
    p.add_argument("--nthreads", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--buffer-float-type", default=None, help=argparse.SUPPRESS)
    p.add_argument("--weights-float-type", default=None, help=argparse.SUPPRESS)
    p.add_argument("--kv-cache-storage", default=None, help=argparse.SUPPRESS)
    # worker mode: the process group of several hosts (parallel.hosts)
    p.add_argument("--coordinator", default=None, help="host:port of the worker-mode rendezvous (host 0 serves it)")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    return p


def _check_kv_storage(args) -> None:
    """The reference can keep its KV cache in disc-backed buffers; the port
    keeps it in the card's memory, so any storage but ``ram`` is refused."""
    storage = getattr(args, "kv_cache_storage", None)
    if storage not in (None, "ram"):
        raise SystemExit(
            f"--kv-cache-storage {storage} is not supported (the KV cache lives in the card's memory); "
            "use --cache-dtype i8 for 2x cache-memory headroom and/or --max-seq-len to bound it"
        )


def _default_seed(args) -> int:
    # wall-clock as entropy for a default sampling seed, never a duration
    return args.seed if args.seed is not None else int(time.time())  # dllama: noqa[CLK-001]


def _make_sampler(args, vocab_size: int) -> Sampler:
    return Sampler(vocab_size=vocab_size, temperature=args.temperature, topp=args.topp, topk=args.topk,
                   seed=_default_seed(args))


def make_pod_group(args):
    """Build the one-process pod from the flags: ONE model load for every
    slice, plus the tokenizer and sampler ``make_engine`` returns. The
    group is the serving layer's engine factory (slice engines share its
    params; a replica rebuild never reloads the file)."""
    from distributed_llama_tpu_torch.parallel.pod import PodGroup, parse_pod

    _check_kv_storage(args)
    if getattr(args, "tp", 1) > 1 or getattr(args, "sp", 1) > 1 or getattr(args, "ep", 1) > 1:
        raise SystemExit("--pod owns the whole rank layout; it does not compose with --tp/--sp/--ep (the pod's MODEL "
                         "extent IS the tensor-parallel degree)")
    data, model = parse_pod(args.pod)
    group = PodGroup.build(
        args.model, data, model, dtype=_DTYPES[args.dtype], max_seq_len=args.max_seq_len,
        cache_dtype=_CACHE_DTYPES[getattr(args, "cache_dtype", "auto")], device=args.device,
        q40_path=args.q40_path, allreduce=getattr(args, "allreduce", "psum"),
        moe_capacity_factor=getattr(args, "moe_capacity", 0.0) or 0.0,
    )
    tokenizer = Tokenizer.from_file(args.tokenizer, group.cfg.vocab_size)
    return group, tokenizer, _make_sampler(args, group.cfg.vocab_size)


def make_engine(args, hosts=None):
    """(engine, tokenizer, sampler) from the flags; ``hosts``: worker mode's
    process group, over which the engine spreads its ``--tp`` ranks."""
    if getattr(args, "pod", None):
        # one slice of a freshly built pod (generate/inference/chat); the
        # server keeps the group itself, for replica rebuilds
        group, tokenizer, sampler = make_pod_group(args)
        return group.slice_engine(), tokenizer, sampler
    _check_kv_storage(args)
    engine = InferenceEngine(
        args.model, dtype=_DTYPES[args.dtype], max_seq_len=args.max_seq_len,
        device=args.device, q40_path=args.q40_path,
        cache_dtype=_CACHE_DTYPES[getattr(args, "cache_dtype", "auto")],
        tp=getattr(args, "tp", 1), allreduce=getattr(args, "allreduce", "psum"),
        moe_capacity_factor=getattr(args, "moe_capacity", 0.0) or 0.0,
        sp=getattr(args, "sp", 1), ep=getattr(args, "ep", 1), hosts=hosts,
    )
    tokenizer = Tokenizer.from_file(args.tokenizer, engine.cfg.vocab_size)
    return engine, tokenizer, _make_sampler(args, engine.cfg.vocab_size)


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


def chat(args, built=None) -> dict:
    """The multi-turn REPL on ``input()``. ``built`` is a
    ``make_engine(args)`` triple to reuse (its engine continues from its
    current position). Returns the session: each turn's fed prompt tokens,
    its reply tokens (after an EOS or a stop string the last one is never
    fed), its wall time from the user's line to the reply's end and how it
    ended (``"eos"`` or ``"context"``)."""
    engine, tokenizer, sampler = built if built is not None else make_engine(args)
    engine.q40_path = args.q40_path
    stops = chat_stops(tokenizer)
    template = ChatTemplate(args.chat_template or ChatTemplateType.UNKNOWN, tokenizer.chat_template, stops[0])
    max_stop = max(len(s) for s in stops)
    turns: list[dict] = []
    try:
        items: list[ChatItem] = []
        sys_prompt = input("💻 System prompt (optional): ")
        if sys_prompt:
            items.append(ChatItem("system", sys_prompt))

        seq_len = engine.cfg.seq_len
        while engine.pos < seq_len:
            user = ""
            while not user:
                user = input("\n👱 User\n> ")
            turn_sw = Stopwatch()
            items.append(ChatItem("user", user))
            prompt = template.generate(items, append_generation_prompt=True)
            items = []  # only the new turn is fed, against the live KV cache
            tokens = tokenizer.encode(prompt, add_bos=engine.pos == 0)
            tokens = tokens[: seq_len - engine.pos]
            turn_seed = sampler.seed + engine.pos  # another stream each turn
            sampler.set_seed(turn_seed)  # the counter coins re-key with it
            if args.decode == "device":
                first_dev = engine.prefill_device(tokens, args.temperature, args.topp, seed=turn_seed,
                                                  topk=args.topk)
            else:
                logits = engine.prefill(tokens)
            _print("\n🤖 Assistant\n")
            reply: list[int] = []
            detector = EosDetector({tokenizer.chat_eos_id}, stops, padding_left=max_stop, padding_right=max_stop)

            def feed(prev: int, token: int) -> int:
                reply.append(token)
                piece = tokenizer.decode_piece(prev, token)
                res = detector.append(token, piece if is_safe_piece(piece) else b"")
                if res in (EosDetectorResult.NOT_EOS, EosDetectorResult.EOS):
                    delta = detector.get_delta()
                    if delta:
                        _print(delta.decode("utf-8", errors="replace"))
                    detector.clear()
                return res

            res = EosDetectorResult.NOT_EOS
            if args.decode == "device":
                def on_token(prev: int, t: int) -> bool:
                    nonlocal res
                    res = feed(prev, t)
                    return res != EosDetectorResult.EOS

                engine.stream_decode(
                    first_dev, on_token, args.temperature, args.topp, seed=turn_seed,
                    chunk=args.decode_chunk, limit=seq_len, first_prev=tokens[-1],
                    spec_draft=getattr(args, "spec_draft", 0), spec_ngram=getattr(args, "spec_ngram", 3),
                    prompt_tokens=tokens, topk=args.topk,
                )
            else:
                prev = tokens[-1]
                token = sampler.sample(logits, pos=engine.pos - 1)
                res = feed(prev, token)
                while res != EosDetectorResult.EOS and engine.pos < seq_len:
                    logits = engine.decode_step(token)
                    prev = token
                    token = sampler.sample(logits, pos=engine.pos - 1)
                    res = feed(prev, token)
            if res != EosDetectorResult.EOS:
                # the context-limit exit: flush the text held back as a
                # possible stop-string prefix
                tail = detector.flush_delta()
                if tail:
                    _print(tail.decode("utf-8", errors="replace"))
            turns.append({"prompt_tokens": tokens, "tokens": reply, "ms": turn_sw.elapsed_ms(),
                          "end": "eos" if res == EosDetectorResult.EOS else "context"})
        _print("\n(end of context)\n")
    except EOFError:
        pass  # the input ended: the session ends with it
    return {"turns": turns, "pos": engine.pos}


def worker(args) -> dict:
    """Worker mode: join the group of ``--num-hosts`` processes at
    ``--coordinator`` as ``--host-id`` and run ``generate`` with this
    process's share of the ranks (``--tp``, with ``--sp`` or ``--ep``).
    Every host runs the same flags;
    without ``--seed`` host 0's wall-clock seed is broadcast, so sampled
    streams agree across hosts. Returns ``generate``'s result with
    ``bytes_read``, the `.m` bytes this process read, ``forwards``, the
    forwards its stream ran, and ``seed``, the sampling seed every host
    used."""
    if args.coordinator is None:
        raise SystemExit(NO_COORDINATOR)
    from distributed_llama_tpu_torch.parallel.hosts import HostGroup, rank_placement

    # the rank count a multiple of --num-hosts, before any rendezvous
    rank_placement(args.tp, args.sp * args.ep, args.num_hosts, args.host_id)
    with HostGroup(args.coordinator, args.num_hosts, args.host_id) as group:
        # after joining, a missing prompt is a contract violation: a
        # defaulted one would diverge from the other hosts' program
        if args.prompt is None:
            raise SystemExit(NO_PROMPT)
        args.seed = group.broadcast_ints([_default_seed(args)])[0]
        built = make_engine(args, hosts=group)
        out = generate(args, benchmark=False, built=built)
        out.update(bytes_read=built[0].bytes_read, forwards=built[0].default_stream.forwards, seed=args.seed)
        return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # before the engine is built: instruments bind at construction
    if args.telemetry:
        telemetry.enable()
    if args.mode == "chat":
        return chat(args)
    if args.mode == "worker":
        return worker(args)  # no Chrome trace, as in the JAX CLI
    out = generate(args, benchmark=args.mode == "inference")
    if telemetry.is_enabled():
        path = telemetry.export_chrome_trace(args.trace_out)
        _print(f"📊 telemetry: Chrome trace written to {path}\n")
    return out


if __name__ == "__main__":
    main()
