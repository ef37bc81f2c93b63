"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. identify the card (nvidia-smi name and power limit, torch's device name);
2. build the port's CUDA kernels from ``distributed_llama_tpu_torch/csrc``
   with nvcc, one process per source, started together;
3. hold each kernel against its plain PyTorch version at the five
   Llama-2-7B matmul shapes (qkv 4096->12288, wo 4096->4096, gate_up
   4096->22016, down 11008->4096, wcls 4096->32000) at T=1 and T=64, and
   time kernel, plain version and the library yardstick (dequantize +
   torch.matmul in bf16) against the bound (the logical output columns'
   bytes over 3.35 TB/s, or their operations over the tensor-core peak);
4. check the port's forward on the card against the same engine on the CPU
   on a small synthetic model;
5. write a Q40 `.m` file at full Llama-2-7B width (random blocks from a
   seed) and a tokenizer padded to vocab 32000, and drive the port's CLI
   ``generate``/``inference`` entry with ``--dtype q40 --decode device``:
   greedy twice, sampled twice, and once on the f32 (dequant) kernel path;
   assert identical streams for identical seeds, tokens in range, and
   4 * n_layers + 1 kernel launches per forward.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
N_LAYERS = 32  # Llama-2-7B's depth; the smoke runs all of it
SEQ_LEN = 1024  # --max-seq-len of the driven runs
# the 7B main path's matmuls: name -> (n, d, launches per decoded token)
SHAPES = {
    "qkv": (4096, 12288, N_LAYERS),
    "wo": (4096, 4096, N_LAYERS),
    "gate_up": (4096, 22016, N_LAYERS),
    "down": (11008, 4096, N_LAYERS),
    "wcls": (4096, 32000, 1),
}
# kernel vs plain version: K1's block sums are exact integers in both, K3's
# bf16 products are exact in f32 in both; only f32 summation order differs
TOL_REL = {"q40_int8": 1e-5, "q40_dequant": 1e-4}
KERNEL_INFO = {
    "q40_int8": ("distributed_llama_tpu_torch/csrc/q40_int8.cu",
                 "distributed_llama_tpu/ops/q40.py:725 (_make_q40_int8_kernel)"),
    "q40_dequant": ("distributed_llama_tpu_torch/csrc/q40_dequant.cu",
                    "distributed_llama_tpu/ops/q40.py:493 (_make_q40_kernel)"),
}
OUT_FILE = ROOT / "build" / "chip_smoke.json"  # the full results


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> float:
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device milliseconds per ``fn(i)``: ``reps`` calls (i = 0..reps-1)
    captured in one CUDA graph, so the host's launch overhead is not in the
    number; the graph is replayed three times between CUDA events, after
    ``warmup`` eager calls, and the median replay is divided by ``reps``."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def kernel_checks(q40) -> dict:
    """Phase 3: every kernel against its plain version at the 7B shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, (n, d, per_token) in SHAPES.items():
        n_pad, d_pad = q40._n_padded(n), q40._d_padded(d)
        w_bytes = n_pad // 2 * d_pad + n_pad // 32 * d_pad * 4
        # enough weight copies to exceed the 50 MB L2 cache: each timed
        # launch reads its weights cold, as a decode step does
        copies = max(2, math.ceil(256e6 / w_bytes))
        qs = [torch.randint(0, 256, (n_pad // 2, d_pad), dtype=torch.uint8, device=dev, generator=g)
              for _ in range(copies)]
        scales = [torch.rand((n_pad // 32, d_pad), device=dev, generator=g) / (4.6 * math.sqrt(n))
                  for _ in range(copies)]
        for T in (1, 64):
            x = torch.randn((T, n_pad), device=dev, generator=g)
            xq, sx = q40.quantize_q80(x)
            xb = x.to(torch.bfloat16)
            w_bf16 = q40.dequantize_tpu(q40.QuantizedMatrix(qs[0], scales[0])).to(torch.bfloat16)
            for name in ("q40_int8", "q40_dequant"):
                if name == "q40_int8":
                    run = lambda i: q40.q40_int8(xq, sx, qs[i % copies], scales[i % copies])
                    plain = lambda i: q40.q40_int8_plain(xq, sx, qs[0], scales[0])
                    x_bytes, ops_rate = xq.numel() + sx.numel() * 4, INT8_OPS_PER_S
                else:
                    run = lambda i: q40.q40_dequant(xb, qs[i % copies], scales[i % copies])
                    plain = lambda i: q40.q40_dequant_plain(xb, qs[0], scales[0])
                    x_bytes, ops_rate = xb.numel() * 2, BF16_OPS_PER_S
                got = run(0)
                want = plain(0)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                check(math.isfinite(err) and err <= TOL_REL[name] * scale,
                      f"{name} {shape} T={T}: max abs err {err} > {TOL_REL[name]} x {scale}")
                ms = cuda_ms(run, reps=50)
                plain_ms = cuda_ms(plain, reps=5, warmup=1)
                lib_ms = cuda_ms(lambda i: xb @ q40.dequantize_tpu(
                    q40.QuantizedMatrix(qs[i % copies], scales[i % copies])).to(torch.bfloat16), reps=5, warmup=1)
                mm_ms = cuda_ms(lambda i: xb @ w_bf16, reps=20)
                # the function's bytes: the half-split pack forces all n_pad
                # rows (one byte holds rows i and i + n_pad/2), while padded
                # output columns carry zero scales and are trimmed, so only
                # the logical d columns count
                need_bytes = n_pad // 2 * d + n_pad // 32 * d * 4 + x_bytes + T * d * 4
                bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 2.0 * T * n_pad * d / ops_rate * 1e3
                row = dict(kernel=name, shape=shape, n=n, d=d, T=T, per_token=per_token,
                           max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol_rel=TOL_REL[name],
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bf16_matmul_only_ms=mm_ms,
                           bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations")
                rows.append(row)
                print(f"{name:12s} {shape:8s} T={T:3d} err {err:.3e} (rel {row['max_rel_err']:.1e} <= "
                      f"{TOL_REL[name]:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"library {lib_ms:.4f} ms (bf16 matmul alone {mm_ms:.4f}) bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})", flush=True)
        del qs, scales
        torch.cuda.empty_cache()
    return rows


def device_profile(engine, first: int, decode_ms: float, steps: int = 8) -> dict:
    """Device busy time per decoded token from a torch.profiler trace of
    ``steps`` greedy decode steps (kernel durations on the card, which the
    profiler's host overhead does not stretch), its share of the unprofiled
    ``decode_ms``, and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.decode_chunk(first, steps, 0.0, 0.9)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) / steps
    if busy == 0.0:
        print("profiler recorded no device time: device busy share not measured")
        return {"device_busy_ms_per_token": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  device busy {busy:.2f} ms/token = {100 * busy / decode_ms:.1f}% of {decode_ms:.2f} ms/token; "
          f"idle {100 * (1 - busy / decode_ms):.1f}%")
    for name, ms in top:
        print(f"    {ms / steps:8.3f} ms/token  {name[:100]}")
    return {"device_busy_ms_per_token": busy, "device_idle_share": 1 - busy / decode_ms,
            "top_kernels_ms_per_token": {n[:100]: ms / steps for n, ms in top}}


def small_reference_check(synthetic, InferenceEngine, FloatType, workdir: Path) -> None:
    """Phase 4: the card's forward against the CPU's (plain kernel
    versions) on a small model. Activations are re-quantized to Q80 and
    the KV cache is bf16, so ulp-level differences between the devices'
    f32 ops can move single activations by a quantization step: the
    logits agree to 5% of their largest magnitude, and greedy tokens to
    the argmax where the CPU's top-2 gap exceeds twice that."""
    spec = synthetic.tiny_spec(dim=1024, hidden_dim=2048, n_layers=2, n_heads=8, n_kv_heads=4,
                               vocab_size=512, seq_len=1024, weights_float_type=FloatType.Q40)
    path = str(workdir / "small.m")
    synthetic.write_synthetic_model(path, spec, seed=0)
    for q40_path in ("int8", "f32"):
        gpu = InferenceEngine(path, dtype="q40", device="cuda", q40_path=q40_path)
        cpu = InferenceEngine(path, dtype="q40", device="cpu", q40_path=q40_path)
        for prompt in ([1, 5, 9], [1, 300, 17, 42, 7, 99, 250, 3, 11, 64, 128]):
            gpu.reset(), cpu.reset()
            a, b = gpu.prefill(prompt), cpu.prefill(prompt)
            for step in range(4):
                check(a.shape == b.shape == (512,), f"logits shape {a.shape}")
                check(bool(torch.isfinite(torch.from_numpy(a)).all()), "non-finite logits on the card")
                tol = 0.05 * float(abs(b).max())
                err = float(abs(a - b).max())
                check(err <= tol, f"small model {q40_path} step {step}: card vs CPU logits differ by {err} > {tol}")
                top2 = sorted(b)[-2:]
                if top2[1] - top2[0] > 2 * tol:
                    check(int(a.argmax()) == int(b.argmax()), "card and CPU argmax differ")
                tok = int(b.argmax())
                a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        print(f"small model ({q40_path}): card matches CPU within 5% of max |logit| over 2 prompts x 4 steps")
        del gpu, cpu


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke test needs a GPU", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.engine import InferenceEngine
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.ops import cuda_build, q40
    from distributed_llama_tpu_torch.quants import FloatType

    t_all = time.perf_counter()
    summary: dict = {}

    t = phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")
    summary["card"] = smi

    t = phase("2. build kernels")
    build_s = cuda_build.build()
    for name in cuda_build.KERNELS:
        cuda_build.function(name)  # load every library
    print(f"nvcc build: {build_s:.1f} s for {list(cuda_build.KERNELS)}")
    for name, log in cuda_build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    summary["build_s"] = build_s

    t = phase("3. kernels vs plain versions at the Llama-2-7B shapes")
    rows = kernel_checks(q40)
    summary["kernel_rows"] = rows
    print(f"phase 3: {time.perf_counter() - t:.1f} s")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        t = phase("4. small model: card vs CPU")
        small_reference_check(synthetic, InferenceEngine, FloatType, workdir)
        print(f"phase 4: {time.perf_counter() - t:.1f} s")

        t = phase(f"5. main path: CLI generate at Llama-2-7B width, {N_LAYERS} layers")
        spec = synthetic.llama2_7b_spec(n_layers=N_LAYERS, seq_len=4096)
        model = str(workdir / "llama2_7b_width.m")
        synthetic.write_random_q40_model(model, spec, seed=0)
        tok = str(workdir / "tok.t")
        with open(tok, "wb") as f:
            write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=spec.vocab_size))
        print(f"wrote {os.path.getsize(model) / 1e9:.2f} GB .m in {time.perf_counter() - t:.1f} s")

        def args(*extra):
            return cli.build_parser().parse_args([
                "inference", "--model", model, "--tokenizer", tok, "--dtype", "q40",
                "--decode", "device", "--max-seq-len", str(SEQ_LEN), "--steps", "48",
                "--decode-chunk", "16", *extra])

        t_load = time.perf_counter()
        built = cli.make_engine(args("--prompt", "hello world", "--temperature", "0"))
        engine = built[0]
        torch.cuda.synchronize()
        print(f"engine load + repack: {time.perf_counter() - t_load:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        per_forward = 4 * engine.cfg.n_layers + 1

        runs = [
            ("greedy", "int8", ["--prompt", "hello world, hello", "--temperature", "0", "--seed", "1"]),
            ("greedy again", "int8", ["--prompt", "hello world, hello", "--temperature", "0", "--seed", "1"]),
            ("sampled", "int8", ["--prompt", "hello hello world", "--temperature", "0.8", "--topp", "0.9", "--seed", "42"]),
            ("sampled again", "int8", ["--prompt", "hello hello world", "--temperature", "0.8", "--topp", "0.9", "--seed", "42"]),
            ("greedy f32 path", "f32", ["--prompt", "hello world, hello", "--temperature", "0", "--seed", "1"]),
        ]
        streams = {}
        q40.reset_launches()  # the main path's counts start here
        for label, path, extra in runs:
            engine.reset()
            stream = engine.default_stream
            f0, l0 = stream.forwards, dict(q40.launches)
            print(f"--- {label} (--q40-path {path})")
            res = cli.generate(args("--q40-path", path, *extra), benchmark=True, built=built)
            torch.cuda.synchronize()
            forwards = stream.forwards - f0
            d_int8 = q40.launches["q40_int8"] - l0["q40_int8"]
            d_deq = q40.launches["q40_dequant"] - l0["q40_dequant"]
            print(f"{label}: {len(res['tokens'])} tokens, {forwards} forwards, launches int8 {d_int8} "
                  f"dequant {d_deq} (expected {per_forward} per forward on the {path} path)")
            check(len(res["tokens"]) > 0, f"{label}: no tokens generated")
            check(all(0 <= t_ < spec.vocab_size for t_ in res["tokens"]), f"{label}: token out of range")
            if path == "int8":
                check(d_int8 == per_forward * forwards and d_deq == 0, f"{label}: launch count")
            else:
                check(d_deq == per_forward * forwards and d_int8 == 0, f"{label}: launch count")
            streams[label] = res["tokens"]
        main_launches = dict(q40.launches)
        check(streams["greedy"] == streams["greedy again"], "greedy streams differ between runs")
        check(streams["sampled"] == streams["sampled again"], "sampled streams differ for one seed")
        check(all(v > 0 for v in main_launches.values()), f"a kernel was never launched: {main_launches}")
        summary["streams"] = streams
        summary["main_path_launches"] = main_launches

        # timings of the same engine, fenced by synchronize
        timing = {}
        for path in ("int8", "f32"):
            engine.q40_path = path
            prompt = built[1].encode("hello world " * 10, add_bos=True)[:64]
            for _ in range(2):  # the second round is the measured one
                engine.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = engine.prefill(prompt)
                prefill_ms = (time.perf_counter() - t0) * 1e3
                check(bool(torch.isfinite(torch.from_numpy(logits)).all()), "non-finite prefill logits")
                first = int(logits.argmax())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = engine.decode_chunk(first, 32, 0.0, 0.9)
                decode_ms = (time.perf_counter() - t0) * 1e3 / 32
            timing[path] = dict(prompt_tokens=len(prompt), prefill_ms=prefill_ms,
                                decode_ms_per_token=decode_ms, tok_per_s=1e3 / decode_ms)
            print(f"{path} path: prefill {len(prompt)} tokens {prefill_ms:.1f} ms, decode "
                  f"{decode_ms:.2f} ms/token ({1e3 / decode_ms:.1f} tok/s) over 32 greedy tokens")
            check(len(toks) == 32, "decode chunk length")
            timing[path].update(device_profile(engine, first, decode_ms))
        summary["timing"] = timing
        print(f"phase 5: {time.perf_counter() - t:.1f} s")

    kernels = []
    for name in ("q40_int8", "q40_dequant"):
        src, replaces = KERNEL_INFO[name]
        mine = [r for r in rows if r["kernel"] == name and r["T"] == 1]
        # one decoded token at 32 layers: each shape weighted by its launches per token
        tot = {k: sum(r[k] * r["per_token"] for r in mine) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        bytes_bound = all(r["bound_by"] == "bytes" for r in mine)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if bytes_bound else "operations", library_ms=tot["library_ms"],
        ))
    summary["kernels"] = kernels
    summary["total_s"] = time.perf_counter() - t_all
    OUT_FILE.parent.mkdir(exist_ok=True)
    OUT_FILE.write_text(json.dumps(summary, indent=1))
    print(f"\ntotal {summary['total_s']:.1f} s; details in {OUT_FILE}")
    print("kernel numbers: ms/plain_ms/bound_ms/library_ms are one decoded token's worth of "
          "launches at 32 layers (T=1, each shape times its launches per token); "
          "launches are the main path's")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
