"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. identify the card (nvidia-smi name and power limit, torch's device name);
2. build the port's CUDA kernels from ``distributed_llama_tpu_torch/csrc``
   with nvcc, one process per source, started together;
3. hold each kernel against its plain PyTorch version at the five
   Llama-2-7B matmul shapes (qkv 4096->12288, wo 4096->4096, gate_up
   4096->22016, down 11008->4096, wcls 4096->32000): K1 at T = 1, 2, 5,
   20, 64 and 512, both of its tiles (dp4a, and the int8 tensor cores) equal
   bit for bit to ``q40_int8_ordered_plain`` and every row of a T > 1
   launch equal to a T = 1 launch of that row; K3 at T = 1, 2, 5, 20, 64
   and 512, repeat launches bit-equal and every row of a T > 1 launch equal
   to a T = 1 launch of that row; and time each against the plain version, the library yardstick (dequantize
   + torch.matmul in bf16, and the bf16 matmul alone) and the bound (the
   logical output columns' bytes over 3.35 TB/s, their operations over the
   tensor-core peak, or for K1 its f32 epilogue over the f32 rate); also
   what the 64-row blocks of the bias correction and rmsnorm cost a
   prefill forward;
4. check the port's forward on the card against the same engine on the CPU
   on a small synthetic model, and on a small Mixtral and Grok-1 (8
   experts, 2 active; on the f32 path the CPU computes the dequant matmuls
   in bf16 as the card does): expert ids of every layer equal on every
   forward first, then logits;
5. write a Q40 `.m` file at full Llama-2-7B width (random blocks from a
   seed; MAIN_LAYERS of its 32 layers) and a tokenizer padded to vocab
   32000, and drive the port's CLI
   ``generate``/``inference`` entry with ``--dtype q40 --decode device``:
   greedy twice, sampled twice, once on the f32 (dequant) kernel path and
   greedy with ``--spec-draft 4`` on each path; assert identical streams
   for identical seeds, each speculative stream equal to its path's plain
   greedy one token for token, tokens in range, and 4 * n_layers + 1
   kernel launches per forward; hold a verify window's logits against the same decode
   steps' (0 apart with per-position attention; the T-row einsums' gap is
   reported as the size before the repair); then show the chunk pipeline's
   delivery: chunk k's tokens reach the host while chunk k+1 still runs
   (the delivery lag before and after the pinned-copy repair);
6. (a) hold K2, the paged-attention kernel, against its plain version
   (run on the host's CPU from the same inputs; the gap to its run on the
   card is reported beside) at Llama-2-7B heads (K=32, M=1, hd=128; and a
   K=8, M=4 GQA case), S=2048, page 64, rows whose matched lengths put
   chunks in the pool-only, mixed and slab-only segments: bf16 and f32
   caches at T=1 and T=3, and the int8 cache (halves from
   ``quantize_rows``) at T=1 and T=5, the verify window of --spec-draft 4;
   also at Llama-2-7B's full context, S=4096, rows near position 4000
   (bf16 and int8); at 40 queries per (row, kv head) with S = 131072, and
   at head sizes 64, 96 and 256; at "B4 K32 M1" and those new cases check K2's
   contracts bit for bit (a
   verify row t equals a decode at pos+t, a row alone equals it in the
   batch, pool pages equal the same KV through the slab, repeat launches
   are equal) and hold each of its two passes (chunk partials, fold)
   against its plain function; kernel and plain version both against K2's
   function in f64, a query beyond the tolerance accepted only as one-ulp
   flips of bf16 softmax weights at rounding midpoints; timed against the bound (live KV bytes, 2 K
   (hd + 4) per position for int8, + q/out/tables over 3.35 TB/s), the
   plain version and the library yardstick (a page-table gather, for int8
   a dequantize to bf16, then scaled_dot_product_attention, SDPA alone in
   brackets);
   (b) start the port's API server in process over the phase-5 model with
   --parallel 4 --max-seq-len 2048, send a cold request with a ~600-token
   system prompt and then four concurrent ones sharing it (greedy and
   sampled, SSE and JSON) and a lone hit; assert 200s, prefix hits, K2
   launches equal to n_layers x batched forwards, and a hit's first-token
   logits within 5% of a cold prefill's; report TTFT cold vs hit,
   aggregate decode tok/s at 1 and 4 rows and the device idle share;
   (c) the same server and requests with --cache-dtype i8 --spec-draft 4:
   K2 launched only in its int8 form, K1's tensor-core tile on every
   verify forward, verify steps with their drafted/accepted counts and
   tokens per row-step, the KV bytes of slab and pool beside bf16's, and
   every greedy completion's token ids equal to what a spec_draft=0
   BatchScheduler on the same engine and cache decodes for the same
   prompt; then a second server at --parallel 16 --max-seq-len 1000 (the
   einsum attention; over phase 7c's 8-layer file) with 16 concurrent
   greedy requests, whose verify forwards reach 80 rows, held to the same
   equality;
7. (a) hold K4, the ring all-reduce kernel, against its plain version bit
   for bit on every rank, for 2 and 4 ranks at [1, 4096] and [16, 4096],
   timed against the bound (n inputs read and n outputs written over
   3.35 TB/s, beside the measured launch floor), the plain version and the
   library yardstick (torch.stack(xs).sum(0) and n copies);
   (b) hold K5, the int8 matmul fused into the ring, bit for bit against
   the K1 kernel, then the bias correction, then the K4 kernel, and within
   K1's tolerance of its plain version, at the 7B wo and down shard shapes
   for tp = 2 and 4 (T = 1 and 8), repeat launches bit-equal, the cluster
   shape it launches with printed, timed likewise (library: per-rank
   dequantize + bf16 matmul, then the stacked sum);
   (c) the slice's path: the CLI ``generate`` at 7B width, 8 layers, with
   ``--tp 1``, then ``--tp 2 --allreduce ring`` and ``--tp 4 --allreduce
   ring`` (the ranks share the card): K4 and K5 launched, every rank's
   residual stream byte-identical, first-step logits within 2.5e-2 of max
   |logit| of tp=1's, the greedy tokens matching tp=1's before the first
   divergence counted, and ms/token beside the device-busy ms/token;
8. the mixture-of-experts slice: (a) K1 (both tiles bit for bit against
   ``q40_int8_ordered_plain``, rows against T=1 launches) and K3 (repeat
   launches and rows against T=1 launches bit for bit) at the Mixtral-8x7B
   expert shapes (gate_up 4096->28672, down 14336->4096) and Grok-1's
   (gate_up 6144->65536, down 32768->6144, wcls 6144->131072), T = 1, 4,
   64, timed as in phase 3; (b) a random-Q40 `.m` at Mixtral-8x7B's widths
   cut to 2 layers through the CLI: greedy and sampled twice each (equal
   streams), the f32 path, ``--moe-capacity 2.0`` on a prompt of >= 32
   tokens (the bucketed prefill), ``--spec-draft 4`` (its MoE warning, the
   plain greedy stream); (2 + 2E)·L + 1 Q40 launches per prefill and
   (2 + 2k)·L + 1 per decode step, L expert-id host reads per decoded
   token; ms/token, device busy and the bound per token; (c) the API
   server over that model as in 6b, then with ``--cache-dtype i8``, each
   greedy completion's first 8 tokens against the single-stream decode
   (reported, not failed: a 4-row step sums the experts in another
   order); (d) Grok-1's widths cut to 1 layer through the CLI;
9. telemetry, request tracing and the load generator (run after 7b, over a
   7B-width file cut to 8 layers, phase 7c's; ``--loadgen`` alone runs
   the 7B-width file at all 32 layers): the port's API server in process with
   ``--telemetry --parallel 4 --max-seq-len 2048`` (prefix cache on,
   ``--admission-queue 24``), driven through the port's load generator's
   ``--url`` path (``python -m distributed_llama_tpu_torch.loadgen``): 24
   requests, Poisson at 2 requests/s, seed 0, 4 shared ~600-token prefixes
   under Zipf s = 1.1, 6 suffixes, max_tokens 32, half sampled
   (``--sampled-share 0.5``), after 2 unmeasured warmup requests. Asserts
   every request completed, ``--assert`` (greedy consistency) and a zero
   host-sampler fallback delta; over the window, the chat-route 200s and
   the TTFT observations equal 24, prefix hits + misses equal the
   scheduler's admissions (24), tokens generated equal the tokens the
   scheduler delivered to rows plus the 24 first tokens (the requests
   consume the rest; chunk tails past a stop are counted, as in the JAX
   package); the client/server skew within ``SKEW_BOUND_MS`` per request;
   ``dllama_kernel_path_total`` naming only K1's tiles and K2 (no
   ``plain``), K1 and K2 launched in the window; one request's
   ``/debug/trace/<id>`` (JSON and Chrome) with its queue, prefill and
   decode stages; ``/healthz`` and ``/readyz`` 200. Prints the client's
   TTFT/TPOT/E2E percentiles, the server's mean stage times, the summed
   dispatch spans (the host's issue) against the fetch spans (the wait for
   the card), and the 4-row decode step with telemetry on, a reading that
   does not fail the run;
10. fault containment and fair admission (after 9, over phase 9's 8-layer
   file; ``--faults`` alone runs the 7B-width file at all 32 layers): one engine
   with ``--telemetry``, one server per
   fault plan (``--parallel 4 --max-seq-len 2048``, prefix cache on), each
   plan armed after the server's warm-up request. (a) The fault-free
   reference: 4 concurrent requests (2 greedy, 2 sampled with seeds) over a
   ~600-token shared system prompt, 48 tokens each, their token ids
   recorded; also the preemption round's 4 requests and a lone request's
   TTFT, and a hit's first-token logits against a cold prefill's (a
   reading). (b) ``batch.row:kind=nan,row=1,count=1``, then
   ``engine.paged_attn:kind=raise,row=1,count=1``: the victim 500 with its
   typed message, the other 3 streams equal (a)'s token for token, one
   quarantine per round, the victim row's pins released and the pinned
   pages back to their value before the round once the lanes reset, K2
   (``dllama_kernel_path_total``, no ``plain``) serving the survivors. (c)
   ``batch.fetch:kind=raise,count=1``: all 4 streams equal (a)'s, one
   retry, no quarantine. (d) ``batch.fetch:kind=hang`` with
   ``--stall-timeout-s 2``: every row ends StallTimeout within the timeout,
   the watchdog's period and ``STALL_CHUNK_S`` of the hang, one stall, and
   the next request returns 200 with its (a) stream. (e) ``--tenants
   "batch:weight=1,priority=0;live:weight=1,priority=1"``: 4 greedy batch
   streams of 96 tokens (distinct user turns, then ~3 pages of a shared
   story) fill the rows; after their first chunk a live request arrives:
   one preemption, one requeue, and every batch client's full stream equal
   to the same request's on the (a) server token for token (the replay
   contract; a failure prints the first divergent token and the positions
   each run read from the pool); the live request's TTFT beside its TTFT
   alone. (f) A deadline that expires mid-decode ends its SSE stream with a
   ``deadline_exceeded`` event while its 3 co-batched rows equal (a); one
   that expires in the queue gets 504; two deadlines counted. (g)
   ``weights_checksum`` of the 7B engine, timed against its bound (leaf
   bytes over 3.35 TB/s), changed after one ``engine.sdc:kind=corrupt``
   fire. Prints phase 10's seconds. Phase 4 also holds the small model's
   checksum on the card equal to the CPU engine's, and every fault-free
   server of phases 6, 8 and 9 ends with no retry, quarantine, stall or
   deadline counted.

11. the host spill tier and the supervised replica pool (after 10, over
   phase 9's 8-layer file; ``--spill`` alone runs phase 5's file, all 32
   layers; ``--telemetry``): (a) a server
   with ``--parallel 4 --kv-pages 24 --host-spill-mb 2048``, bf16 then
   ``--cache-dtype i8``: a ~600-token system prompt P1 cold, again (a lone
   hit), three other distinct ~600-token prompts (P1 evicted and spilled),
   P1 again (reloaded from the arena): the streams equal token for token,
   spills, reloads and evictions counted, every eviction spilled (no
   "page spill failed");
   then every evictable page spilled and P1's reloaded under a fence (ms
   per page both ways), the reloaded pages' first-token logits equal a cold
   prefill's bit for bit, and with int8 the reloaded pages' data and scales
   byte-equal to the spilled ones; prints the cold, lone-hit and reloaded
   TTFT and the scheduler-lock hold per spill. (b) A 40 MiB host arena over
   a 1 GiB ``--spill-disk-dir`` tier: pages demote to disk and reload with
   the cold stream; then an ``engine.spill:kind=corrupt`` fire: the CRC
   drops the entry and the cold prefill streams the same tokens. (c)
   ``--replicas 2 --parallel 2 --host-spill-mb 2048``: card memory after
   boot, an unfaulted round of 4 streams, then the same 4 with a ``replica.crash`` on replica
   0 armed once every stream is past its first delta: every client's text
   and every replayed stream equal the unfaulted run, the failover and
   replay counts, replica 0 walks dead -> healthy (its rebuild checked
   against the load-time weight checksum), card memory back within 5% of
   the post-boot level, ``/readyz`` lists both replicas healthy, the flight
   recorder holds the fault fire and the failover; aggregate decode tok/s
   of 4 streams over 2 replicas beside 2 streams on one replica (11a); and
   a chain replica 1 spilled reloads into replica 0 by copy with first-token
   logits equal to replica 0's cold prefill; each victim's decode before
   the crash is a strict prefix of its unfaulted stream, and the replica
   it replayed on is printed. (d) With ``--spill`` only: two rows decode
   200 tokens while 6 distinct ~600-token prompts churn a 24-page pool,
   at ``--host-spill-mb`` 64 (the default) and 0, in the order 64, 0, 0,
   64: the rows' aggregate tok/s and TPOT inside the churn window, the
   churn prompts' TTFT, the spills and the lock held for them (a reading).
   Every sub-phase's ``dllama_kernel_path_total`` names only K1's tiles
   and K2.

12. the SDC canary, shadow votes, weight versions with blue-green rollout
   and the fleet controller (after 11, over phase 9's 8-layer file;
   ``--fleet`` alone runs the 7B-width file at all 32 layers): one server,
   ``--replicas 2 --parallel 2 --telemetry --sdc-shadow-rate 1.0
   --rollout-drain-s 120 --fleet-min-replicas 2 --fleet-max-replicas 3``,
   bf16 cache. (a) Canary ticks by hand: the golden is set, then three ticks
   match on both replicas while a 600-token request decodes on replica 1
   (the probe shares its steps); ``engine.sdc kind=corrupt row=1 count=-1``
   corrupts replica 1's weights again at each of its batched dispatches
   (that request's chunks, the probes') until the canary walks it to dead
   as corrupt (the fires before the first mismatch are printed), then is
   disarmed; the streaming victim ends
   ``replica_corrupt`` with no replay, the supervisor's rebuild passes the
   checksum and the next tick matches; a JSON request (no delta sent) on
   replica 1 hit by the same corrupt loss replays equal to its reference.
   (b) Two greedy requests' shadow votes agree; with ``engine.sdc`` firing
   on replica 1 again a later vote diverges, both replicas turn suspect,
   and the canary clears replica 0 and kills replica 1. (c) ``POST
   /admin/rollout`` to v1 (a hard link of the boot file) while 4 streams
   run: 200, zero failed requests, every stream equal token for token to
   its run before the rollout, both replicas on v1 and certified,
   ``dllama_weights_version`` v1=1 and v0=0; then a rollout to v2 with
   ``server.rollout kind=corrupt row=1``: 500 ``rollout_aborted``, both
   replicas back on v1. (d) Aggregate decode at 2 replicas x 2 rows; a
   burst of 12 queues, two ticks grow a third replica (permits 4 -> 6),
   the rate at 3 x 2, then idle ticks retire it (6 -> 4; its engine freed)
   and the controller stops at the minimum. After every replica move card
   memory is within 1% of its level after boot; every sub-phase's kernel
   paths are K1's two tiles and K2 only. Prints each move's drain, rebuild
   and certify seconds, the peak card memory during the moves, the canary
   probes' p50 wall time (``dllama_canary_latency_seconds``) and the rates.

13. from a Hugging Face checkpoint to a chat, and MoE under ``--tp`` (13c
   after 8c over phase 8's Mixtral-width file, 13a-b after 8d): (a) a
   synthetic F16 checkpoint with meta-llama/Llama-2-7b-hf's published
   config.json fields (cut to 2 layers), in two safetensors files with an
   index, and a 32000-token ``tokenizer.json``, converted by ``python -m
   distributed_llama_tpu_torch.converter.hf`` (Q40) and ``.tokenizers``;
   the `.m` equals, byte for byte, ``ModelFileWriter``'s direct write of the
   same tensors; prints the conversion's seconds and GB/s; (b) ``chat`` on
   the converted model, greedy, reading a system prompt and two user turns
   from stdin, under ``--decode device`` (also ``--spec-draft 4``) and
   ``--decode host``, the EOS a token of a greedy probe's first reply (random
   weights emit none): the same turns in every mode, turn 2's reply equal to
   one prefill of its token history followed by ``stream_decode``,
   ``generate_on_device`` equal to ``generate_chunks`` for one first token
   and seed, K1 in both tiles and no ``plain`` path; (c) K1 at the Mixtral
   expert shard shapes (tp = 2 and 4, T=1) as in phase 3, then the Mixtral
   CLI at ``--tp 1``, ``--tp 2`` and ``--tp 4`` (the ranks on the card, each
   under ``--allreduce psum`` and ``ring``, ``--moe-capacity 2.0``): the
   expert ids of every router call, then 32 greedy tokens, equal to tp = 1's
   (a divergence prints tp = 1's top-2 logit gap there), one expert-id host
   read per layer per decoded token, K1's dp4a tile, K4 and K5 launched
   under ring and no plain path, rank residuals byte-identical, the
   bucketed prefill of a long prompt on every rank of every layer, and
   ms/token with device busy ms/token per tp.

``--k1`` runs phase 3's K1 part alone, ``--k3`` its K3 part, ``--k2``
phase 6a alone and ``--k5`` phase 7b (``--root DIR``: the port under DIR,
e.g. an earlier commit unpacked with ``git archive``, to time two designs in
one call); ``--moe`` runs phase 4's MoE part and phase 8 alone;
``--loadgen`` writes phase 5's files and runs phase 9 alone, ``--faults``
phase 10 alone, ``--spill`` phase 11 alone, ``--fleet`` phase 12 alone and
``--chat`` phase 13 alone (with 7a's K4 rows at [1, 4096] and a Mixtral-width
file of its own).

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import filecmp
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12
# f32 adds and multiplies outside the tensor cores, each rounded on its own:
# one per lane and cycle, half the 67 TFLOP/s that counts an FMA as two
F32_OPS_PER_S = 33.5e12
BF16_OPS_PER_S = 989e12
N_LAYERS = 32  # Llama-2-7B's depth: the kernel line's per-token numbers count all of it
# phases 5, 6b and 6c's depth in the full run: at 32 layers they took
# 126.5 + 64.2 + 107.4 s of a 980.8 s run on an H100 host, which leaves no
# room for a host ~33% slower (see MIXTRAL_LAYERS); ``--loadgen``,
# ``--faults``, ``--spill`` and ``--fleet`` alone keep all 32
MAIN_LAYERS = 16
# phase 7c's depth: its three engines at 8 of Llama-2-7B's 32 layers, which
# keeps the whole run, phase 8 included, well inside its time limit
TP_LAYERS = 8
SEQ_LEN = 1024  # --max-seq-len of the driven runs
# the 7B main path's matmuls: name -> (n, d, launches per decoded token)
SHAPES = {
    "qkv": (4096, 12288, N_LAYERS),
    "wo": (4096, 4096, N_LAYERS),
    "gate_up": (4096, 22016, N_LAYERS),
    "down": (11008, 4096, N_LAYERS),
    "wcls": (4096, 32000, 1),
}
# K1's rows: decode, a 2-row decode step (the tensor-core tile's switch
# point), a 1-row --spec-draft 4 window, 4 rows' windows, a prefill piece,
# a prefill; K3's (the --q40-path f32 arm)
K1_TS = (1, 2, 5, 20, 64, 512)
K3_TS = (1, 2, 5, 20, 64, 512)
# kernel vs plain version: K1's block sums are exact integers in both, K3's
# bf16 products are exact in f32 in both; only f32 summation order differs
TOL_REL = {"q40_int8": 1e-5, "q40_dequant": 1e-4}
# K2 vs its plain version, of max |out|: f32 caches differ only in the order
# of f32 sums; bf16 and int8 caches also round the softmax weights (for
# int8 scaled by the value scale) to bf16 before the value mix, where an
# ulp of exp can flip one rounding. A query beyond the tolerance passes only
# if at most K2_MAX_FLIPS such flips account for its whole gap: each of one
# bf16 ulp exactly (within K2_FLIP_ULP_TOL), at a position whose exact f64
# weight lies within K2_MIDPOINT ulps of a rounding midpoint, the gap left
# after them within the tolerance. An f32 ulp of a score near 5 moves a
# weight by ~1e-4 of its bf16 ulp, so a flip from the order of f32 sums
# lies a few 1e-4 ulps from the midpoint or closer (the S=4096 bf16 case's
# one flip: 2.1e-5 ulps, a move of -1.0000 ulp, 2e-8 of gap left, on an
# H100). Apart from flips, the kernel must lie no further from K2's
# function in f64 than its plain version does, within the tolerance.
K2_TOL_REL = {torch.float32: 1e-5, torch.bfloat16: 4e-4, "i8": 4e-4}
K2_MAX_FLIPS = 3
K2_FLIP_ULP_TOL = 0.01
K2_MIDPOINT = 1e-3
KERNEL_INFO = {
    "q40_int8": ("distributed_llama_tpu_torch/csrc/q40_int8.cu",
                 "distributed_llama_tpu/ops/q40.py:725 (_make_q40_int8_kernel)"),
    "q40_int8_mma": ("distributed_llama_tpu_torch/csrc/q40_int8_mma.cuh",
                     "distributed_llama_tpu/ops/q40.py:725 (_make_q40_int8_kernel, T >= 2)"),
    "q40_dequant": ("distributed_llama_tpu_torch/csrc/q40_dequant.cu",
                    "distributed_llama_tpu/ops/q40.py:493 (_make_q40_kernel)"),
    "paged_attention": ("distributed_llama_tpu_torch/csrc/paged_attention.cu",
                        "distributed_llama_tpu/ops/attention.py:371 (_fused_paged_attention)"),
    "paged_attention_i8": ("distributed_llama_tpu_torch/csrc/paged_attention.cu",
                           "distributed_llama_tpu/ops/attention.py:371 (_fused_paged_attention, "
                           "int8 halves :389-413)"),
}
KERNEL_INFO.update({
    "ring_all_reduce": ("distributed_llama_tpu_torch/csrc/ring_all_reduce.cu",
                        "distributed_llama_tpu/ops/collectives.py:460 (_make_ring_kernel)"),
    "fused_matmul_ring": ("distributed_llama_tpu_torch/csrc/fused_matmul_ring.cu",
                          "distributed_llama_tpu/ops/collectives.py:181 (_make_fused_matmul_ring_kernel)"),
})
DIM, HIDDEN = 4096, 11008  # Llama-2-7B widths of the tensor-parallel shards
TP_SIZES = (2, 4)
# phase 7c: tp=n logits against tp=1's in the same run, of max |logit|: the
# ranks' partial sums associate differently and Q80 re-quantization
# amplifies an ulp apart (the JAX package's own tp=2/tp=4 q40 logits differ
# from its tp=1 logits by 1.70% / 1.40% of max |logit| on its test model)
TP_LOGIT_TOL = 2.5e-2
TP_PROMPT = "hello world, hello hello world " * 3  # phase 7c's prompt
SERVER_SEQ_LEN = 2048  # --max-seq-len of the phase-6 server
# phase 6c's second server: 16 rows at S = 1000 (the einsum attention), so
# that verify forwards reach 16 x 5 = 80 rows
WIDE_ROWS, WIDE_SEQ_LEN = 16, 1000
K2_PAGE = 64
K2_DTYPES = (torch.bfloat16, torch.float32, "i8")
# (label, K, M, hd, pos per row, matched per row, S, cache kinds, T values
# (None: 1 and 3 for float caches, 1 and 5 for int8), whether K2's
# bit-for-bit contracts and its two passes are checked there): the segment
# mixes of phase 6a at Llama-2-7B's heads, Mixtral's (K=8, M=4) and Grok-1's
# (K=8, M=6), Llama-2-7B's full context, and the shapes K2 refused
# before this slice: 40 queries per (row, kv head) (Llama-2/3-70B's GQA
# M = 8 under --spec-draft 4), with the fold factors of S = 131072 over
# 48 KB, and head sizes 64, 96 and 256 (an f32 cache at 256, whose K and V
# slices do not fit a CTA together, loads V into K's buffer)
K2_CASES = [
    ("B1 K32 M1", 32, 1, 128, [1500], [1024], 2048, K2_DTYPES, None, False),
    ("B4 K32 M1", 32, 1, 128, [1900, 800, 1300, 2000], [0, 576, 1024, 576], 2048, K2_DTYPES, None, True),
    ("B4 K8 M4", 8, 4, 128, [1900, 800, 1300, 2000], [0, 576, 1024, 576], 2048, K2_DTYPES, None, False),
    ("B4 K8 M6", 8, 6, 128, [1900, 800, 1300, 2000], [0, 576, 1024, 576], 2048, (torch.bfloat16, "i8"), None,
     False),
    ("B4 K32 M1 S4096", 32, 1, 128, [4000, 3950, 4090, 3900], [0, 1024, 2048, 576], 4096,
     (torch.bfloat16, "i8"), None, False),
    ("B1 K8 M8 S131072", 8, 8, 128, [131000], [65536], 131072, (torch.bfloat16, "i8"), (5,), True),
    ("B2 K4 M8 hd64", 4, 8, 64, [1900, 1300], [576, 1024], 2048, (torch.bfloat16,), (1, 5), True),
    ("B2 K4 M8 hd96", 4, 8, 96, [1900, 1300], [576, 1024], 2048, (torch.bfloat16,), (1, 5), True),
    ("B2 K4 M2 hd256", 4, 2, 256, [1900, 1300], [576, 1024], 2048, (torch.bfloat16, torch.float32), (1, 3), True),
]
# the cases an earlier tree's K2 refuses (skipped when timing one)
K2_NEW_CASES = ("B1 K8 M8 S131072", "B2 K4 M8 hd64", "B2 K4 M8 hd96", "B2 K4 M2 hd256")
# K2's fold alone against its plain version, of max |out|: the same f32
# formula in the same order; only exp's last ulp may differ
K2_FOLD_TOL_REL = 1e-6
OUT_FILE = ROOT / "build" / "chip_smoke.json"  # the full results
# phase 9: 24 requests, Poisson at 2 requests/s, 4 shared ~600-token prefixes
# (6b's system prompt) under Zipf s = 1.1, 32 tokens each, half sampled
LOADGEN_REQUESTS = 24
LOADGEN_RATE = 2.0
LOADGEN_PREFIX_TOKENS = 600
LOADGEN_MAX_TOKENS = 32
# client E2E minus the server's stage sums, per request: what the server
# cannot see (connect, HTTP parse, the last SSE frames), a few ms on one
# host, with room for handler threads waiting on the interpreter lock behind
# the scheduler's eager launches
SKEW_BOUND_MS = 250.0
# phase 8: Mixtral-8x7B and Grok-1 at their published widths, depth cut to
# fit the run (a Mixtral file of 2 of 32 layers is ~2.2 GB, a Grok-1 file
# of 1 of 64 layers ~6.4 GB). On an H100 80GB HBM3 at 700 W, from 4 and 2
# layers to 2 and 1 took phases 8b, 8c, 13c and 8d from 219.4 s to 166.0 s,
# while the whole run went from 944.0 s to 980.8 s (host time varies more
# than that between machines: one ran every phase ~33% slower, 1260.7 s)
MIXTRAL_LAYERS = 2
GROK_LAYERS = 1
MOE_TS = (1, 4, 64)
# the expert matmuls and Grok-1's logits head: name -> (n, d, launches per
# decoded token: k = 2 experts' gate_up and down in every layer)
MOE_SHAPES = {
    "mixtral gate_up": (4096, 28672, 2 * MIXTRAL_LAYERS),
    "mixtral down": (14336, 4096, 2 * MIXTRAL_LAYERS),
    "grok gate_up": (6144, 65536, 2 * GROK_LAYERS),
    "grok down": (32768, 6144, 2 * GROK_LAYERS),
    "grok wcls": (6144, 131072, 1),
}
# phase 4's small MoE models (dim 1024, 8 experts, 2 active): seeds whose
# routing margins (2nd minus 3rd probability) on the CPU run all exceed
# 3e-3 on both Q40 paths, so an expert flip between the card and the CPU is
# a fault
MOE_SMALL_SEEDS = {"mixtral": 2, "grok": 5}
# phase 10: tokens per request of the fault rounds and of the preemption
# round, the row the row faults target, the stall timeout and the hang
# (long past it), and the allowance for one chunk's launches after the
# watchdog's period in the stall bound
FAULT_TOKENS = 48
PREEMPT_TOKENS = 96
VICTIM_ROW = 1
STALL_TIMEOUT_S = 2.0
HANG_MS = 20000
STALL_CHUNK_S = 1.0
# 10f: the mid-decode deadline, the sleep before its request's first SSE
# event that makes it run out between the first and second token, and its
# head start on its co-batched requests (the host launches a decode chunk
# under the scheduler lock for ~0.7 s, and a prefill waits behind it)
DEADLINE_MS = 6000
DEADLINE_SEND_MS = 9000
DEADLINE_LEAD_S = 0.5
K2_PATH = 'dllama_kernel_path_total{kernel="paged_attention",path="k2"}'
# phase 11: a 24-page pool (~2.5 of the ~600-token prompts) over a 2 GiB
# host arena makes eviction certain; 11b's host arena of 40 MiB holds one
# 32 MiB bf16 page at 32 layers (five 8 MiB pages at 8), the rest demotes to
# a 1 GiB disk tier; 11c's replicas
SPILL_KV_PAGES = 24
SPILL_HOST_MB = 2048
SPILL_DISK_HOST_MB = 40
SPILL_DISK_MB = 1024
SPILL_TOKENS = 16
REPLICA_TOKENS = 32
RATE_TOKENS = 32
MEMORY_TOL_REL = 0.05
# 11d (``--spill`` only): 2 decoding rows of 200 tokens through 6 churn
# prompts, at the default arena and none, in the order 64, 0, 0, 64
SPILL_COST_CHURN = 6
SPILL_COST_DECODE_TOKENS = 200
SPILL_COST_ARMS = (64, 0, 0, 64)
# phase 12: 12a's long request on replica 1 (its row shares the canary's
# steps, then the corruption lands in it), 12c's four rollout streams (a
# 120 s drain cap: two busy replicas decode a 7B row at ~2.5 tok/s, PR 11),
# 12d's queued burst (12 requests on 4 lanes); card memory after each
# replica move within 1% of the post-boot level
FLEET_LONG_TOKENS = 600
FLEET_TOKENS = 32
FLEET_BURST = 12
FLEET_MEM_TOL_REL = 0.01
K1_K2_PATHS = ("q40_matmul/k1_dp4a", "q40_matmul/k1_mma", "paged_attention/k2", "paged_attention/k2_i8")
ROUTE_MARGIN = 1e-5
# phase 13: the converted model's depth and context; meta-llama/Llama-2-7b-hf
# config.json's published fields, typed in (its rope theta, 10000, is the
# transformers default it leaves out), cut to CHAT_LAYERS layers in 13a
CHAT_LAYERS = 2
CHAT_SEQ_LEN = 512
LLAMA2_7B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 11008, "max_position_embeddings": 4096,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
    "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True, "vocab_size": 32000,
}
# 13b's stdin: a system prompt, a user turn, an empty line (asked again), a
# second user turn
CHAT_LINES = ("You are a helpful assistant.", "hello world, tell me about the world", "", "hello again, world")
CHAT_STOP_AT = 6  # from this token of the first turn's greedy reply on, one becomes the EOS
MOE_TP_TOKENS = 32
# K1 at 13c's Mixtral expert shards: name -> (n, d, launches per decoded
# token: 2 active experts x MIXTRAL_LAYERS layers x tp ranks)
MOE_TP_SHAPES = {f"mixtral_tp{tp}_{m}": (n, d, 2 * MIXTRAL_LAYERS * tp) for tp in (2, 4)
                 for m, n, d in (("gate_up", 4096, 2 * 14336 // tp), ("down", 14336 // tp, 4096))}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gate(strict: bool, ok: bool, msg: str) -> None:
    """``check`` for this tree's port; for another tree's (an earlier design
    timed in the same call) a failed check is printed, not fatal."""
    if strict:
        check(ok, msg)
    elif not ok:
        print(f"OUT OF CONTRACT: {msg}")


# (phase id, start time) of every phase in this run, for the closing breakdown
PHASE_STARTS: list = []


def phase(name: str) -> float:
    print(f"\n=== {name}", flush=True)
    t = time.perf_counter()
    PHASE_STARTS.append((name.split(".")[0], t))
    return t


def phase_seconds(end: float) -> dict:
    """Seconds from each phase's start to the next one's (the last: to
    ``end``), by phase id."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [end]
    return {name: round(e - t, 1) for (name, t), e in zip(PHASE_STARTS, ends)}


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


def k1_bound(n_pad: int, d: int, T: int) -> tuple[float, str]:
    """K1's least time on the card (ms) and what sets it: the larger of its
    bytes (the half-split pack forces all n_pad rows, since one byte holds
    rows i and i + n_pad/2, while padded output columns carry zero scales
    and are trimmed, so only the logical d columns count; the Q80
    activations; the f32 output) over the memory rate, its int8 products on
    the tensor cores, and its f32 epilogue: for every row, column and block
    half (dot * sw) * sx and its sum, three separately rounded operations
    that no FMA may fuse, at one per lane and cycle."""
    need_bytes = n_pad // 2 * d + n_pad // 32 * d * 4 + T * n_pad + T * n_pad // 32 * 4 + T * d * 4
    times = {"bytes": need_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(2.0 * T * n_pad * d / INT8_OPS_PER_S, 3.0 * T * d * (n_pad // 32) / F32_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def _weight_copies(q40, n: int, d: int, g) -> tuple[list, list, int, int]:
    """Enough random Q40 weight copies of [n, d] to exceed the 50 MB L2
    cache, so each timed launch reads its weights cold, as a decode step
    does."""
    dev = torch.device("cuda")
    n_pad, d_pad = q40._n_padded(n), q40._d_padded(d)
    w_bytes = n_pad // 2 * d_pad + n_pad // 32 * d_pad * 4
    copies = max(2, math.ceil(256e6 / w_bytes))
    qs = [torch.randint(0, 256, (n_pad // 2, d_pad), dtype=torch.uint8, device=dev, generator=g)
          for _ in range(copies)]
    scales = [torch.rand((n_pad // 32, d_pad), device=dev, generator=g) / (4.6 * math.sqrt(n))
              for _ in range(copies)]
    return qs, scales, n_pad, copies


def k1_checks(q40, strict: bool = True, shapes: dict = SHAPES, ts=K1_TS) -> list:
    """K1 at ``shapes`` (the five 7B shapes) and T in ``ts``. For this tree's port: every
    launch of each tile equal bit for bit to ``q40_int8_ordered_plain`` on
    the same inputs, the wrapper's launch (the tile it picks) too, and each
    row of a T > 1 launch equal to a T = 1 launch of that row alone; within
    TOL_REL of the plain version; each tile timed beside the plain version,
    the library chain (dequantize + bf16 matmul), the bf16 matmul alone and
    the bound. For another tree's port (``strict`` False: an earlier
    design, timed in the same call) the wrapper alone, reported against
    the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    own = hasattr(q40, "q40_int8_ordered_plain")
    rows = []
    for shape, (n, d, per_token) in shapes.items():
        qs, scales, n_pad, copies = _weight_copies(q40, n, d, g)
        w_bf16 = q40.dequantize_tpu(q40.QuantizedMatrix(qs[0], scales[0])).to(torch.bfloat16)
        for T in ts:
            x = torch.randn((T, n_pad), device=dev, generator=g)
            xq, sx = q40.quantize_q80(x)
            xb = x.to(torch.bfloat16)
            args0 = (xq, sx, qs[0], scales[0])
            got = q40.q40_int8(*args0)
            want = q40.q40_int8_plain(*args0)
            row = dict(kernel="q40_int8", shape=shape, n=n, d=d, T=T, per_token=per_token)
            if own:
                ordered = q40.q40_int8_ordered_plain(*args0)
                tiles = {tile: q40._q40_int8_launch(*args0, tile) for tile in q40.K1_TILES}
                torch.cuda.synchronize()
                for tile, out in tiles.items():
                    check(torch.equal(out, ordered),
                          f"K1 {tile} tile {shape} T={T}: differs from q40_int8_ordered_plain "
                          f"(max abs diff {(out - ordered).abs().max().item()})")
                check(torch.equal(got, tiles[q40.k1_tile(T)]), f"K1 {shape} T={T}: the wrapper's launch differs")
                if T > 1:
                    alone = torch.cat([q40._q40_int8_launch(xq[t:t + 1], sx[t:t + 1], qs[0], scales[0], "dp4a")
                                       for t in range(T)])
                    check(torch.equal(got, alone), f"K1 {shape} T={T}: a row differs from its T=1 launch")
                row["tile"] = q40.k1_tile(T)
                for tile in q40.K1_TILES:
                    row[f"{tile}_ms"] = cuda_ms(lambda i, tile=tile: q40._q40_int8_launch(
                        xq, sx, qs[i % copies], scales[i % copies], tile), reps=50)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            gate(strict, math.isfinite(err) and err <= TOL_REL["q40_int8"] * scale,
                 f"q40_int8 {shape} T={T}: max abs err {err} > {TOL_REL['q40_int8']} x {scale}")
            ms = cuda_ms(lambda i: q40.q40_int8(xq, sx, qs[i % copies], scales[i % copies]), reps=50)
            plain_ms = event_ms(lambda i: q40.q40_int8_plain(*args0), reps=3)
            lib_ms = cuda_ms(lambda i: xb @ q40.dequantize_tpu(
                q40.QuantizedMatrix(qs[i % copies], scales[i % copies])).to(torch.bfloat16), reps=5, warmup=1)
            mm_ms = cuda_ms(lambda i: xb @ w_bf16, reps=20)
            bound_ms, bound_by = k1_bound(n_pad, d, T)
            row.update(max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol_rel=TOL_REL["q40_int8"],
                       bit_equal_ordered_plain=own, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bf16_matmul_only_ms=mm_ms, bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            tiles_txt = "; ".join(f"{t} {row[f'{t}_ms']:.4f}" for t in ("dp4a", "mma") if f"{t}_ms" in row)
            print(f"q40_int8     {shape:15s} T={T:3d} err {err:.3e} (rel {row['max_rel_err']:.1e} <= "
                  f"{TOL_REL['q40_int8']:.0e}){' both tiles == ordered plain bit for bit' if own else ''} "
                  f"kernel {ms:.4f} ms{f' ({tiles_txt})' if own else ''} plain {plain_ms:.4f} ms "
                  f"library {lib_ms:.4f} ms (bf16 matmul alone {mm_ms:.4f}) bound {bound_ms:.4f} ms ({bound_by})",
                  flush=True)
        del qs, scales, w_bf16
        torch.cuda.empty_cache()
    return rows


def k3_checks(q40, strict: bool = True, shapes: dict = SHAPES, ts=K3_TS) -> list:
    """K3 at ``shapes`` (the 7B shapes) and T in ``ts``: within TOL_REL of its plain
    version, repeat launches bit-equal, and every row of a T > 1 launch
    equal bit for bit to a T = 1 launch of that row (what the f32 path's
    speculative verify needs to give what plain decode gives); timed like
    K1 (its bound: the bytes, or its bf16 products on the tensor cores).
    For another tree's port (``strict`` False: an earlier design, timed in
    the same call) a failed check is printed, not fatal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    for shape, (n, d, per_token) in shapes.items():
        qs, scales, n_pad, copies = _weight_copies(q40, n, d, g)
        w_bf16 = q40.dequantize_tpu(q40.QuantizedMatrix(qs[0], scales[0])).to(torch.bfloat16)
        for T in ts:
            xb = torch.randn((T, n_pad), device=dev, generator=g).to(torch.bfloat16)
            got = q40.q40_dequant(xb, qs[0], scales[0])
            again = q40.q40_dequant(xb, qs[0], scales[0])
            want = q40.q40_dequant_plain(xb, qs[0], scales[0])
            torch.cuda.synchronize()
            gate(strict, torch.equal(got, again), f"q40_dequant {shape} T={T}: repeat launches differ")
            rows_equal = True
            if T > 1:
                alone = torch.cat([q40.q40_dequant(xb[t:t + 1], qs[0], scales[0]) for t in range(T)])
                rows_equal = torch.equal(got, alone)
                gate(strict, rows_equal, f"q40_dequant {shape} T={T}: a row differs from its T=1 launch "
                     f"(max abs diff {(got - alone).abs().max().item()})")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            gate(strict, math.isfinite(err) and err <= TOL_REL["q40_dequant"] * scale,
                 f"q40_dequant {shape} T={T}: max abs err {err} > {TOL_REL['q40_dequant']} x {scale}")
            ms = cuda_ms(lambda i: q40.q40_dequant(xb, qs[i % copies], scales[i % copies]), reps=50)
            plain_ms = event_ms(lambda i: q40.q40_dequant_plain(xb, qs[0], scales[0]), reps=3)
            lib_ms = cuda_ms(lambda i: xb @ q40.dequantize_tpu(
                q40.QuantizedMatrix(qs[i % copies], scales[i % copies])).to(torch.bfloat16), reps=5, warmup=1)
            mm_ms = cuda_ms(lambda i: xb @ w_bf16, reps=20)
            need_bytes = n_pad // 2 * d + n_pad // 32 * d * 4 + xb.numel() * 2 + T * d * 4
            bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2.0 * T * n_pad * d / BF16_OPS_PER_S * 1e3
            row = dict(kernel="q40_dequant", shape=shape, n=n, d=d, T=T, per_token=per_token,
                       max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol_rel=TOL_REL["q40_dequant"],
                       rows_equal_t1=rows_equal, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bf16_matmul_only_ms=mm_ms, bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            rows.append(row)
            print(f"q40_dequant  {shape:15s} T={T:3d} err {err:.3e} (rel {row['max_rel_err']:.1e} <= "
                  f"{TOL_REL['q40_dequant']:.0e}){' rows == T=1 launches, repeats bit-equal' if rows_equal else ''} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
                  f"{lib_ms:.4f} ms (bf16 matmul alone {mm_ms:.4f}) bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
        del qs, scales, w_bf16
        torch.cuda.empty_cache()
    return rows


def k1_forward_rows(rows: list, label: str = "K1") -> list:
    """K1's (or K3's) numbers per forward at each T: each shape's numbers
    times its launches per forward (4 per layer and one wcls)."""
    out = []
    for T in sorted({r["T"] for r in rows}):
        mine = [r for r in rows if r["T"] == T]
        keys = [k for k in ("ms", "dp4a_ms", "mma_ms", "plain_ms", "library_ms", "bf16_matmul_only_ms", "bound_ms")
                if all(k in r for r in mine)]
        out.append(dict(T=T, **{k: sum(r[k] * r["per_token"] for r in mine) for k in keys},
                        per_call_ms={r["shape"]: r["ms"] for r in mine}))
        print(f"{label} per forward at T={T}: " + ", ".join(f"{k} {out[-1][k]:.3f}" for k in keys), flush=True)
    return out


def row_block_cost(q40, Ts=(600, 1024)) -> dict:
    """What pinning the bias correction's matmul and rmsnorm to 64-row
    blocks costs one prefill forward of T rows (a ~600-token prompt runs at
    its exact length, or at its bucket of 1024 rows): device ms of the
    forward's row-count-dependent ops (a correction matmul per Q40 matmul
    at the 7B shapes, two rmsnorms per layer and the final one) in 64-row
    blocks, against the same ops on all T rows at once."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for T in Ts:
        res = {"blocked_ms": 0.0, "one_call_ms": 0.0}
        for n, d, per in SHAPES.values():
            sc = torch.rand((q40._n_padded(n) // 32, q40._d_padded(d)), device=dev, generator=g)
            xsum = torch.randn((T, q40._n_padded(n) // 32), device=dev, generator=g)
            res["blocked_ms"] += per * cuda_ms(lambda i: q40._true_f32_matmul(xsum, sc), reps=10)
            res["one_call_ms"] += per * cuda_ms(lambda i: xsum @ sc, reps=10)
        xr = torch.randn((T, DIM), device=dev, generator=g)
        wr = torch.rand(DIM, device=dev, generator=g)

        def norm(x):
            return wr * (x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-5))

        norms = 2 * N_LAYERS + 1
        res["blocked_ms"] += norms * cuda_ms(lambda i: q40._at_row_bucket(norm, xr), reps=10)
        res["one_call_ms"] += norms * cuda_ms(lambda i: norm(xr), reps=10)
        out[T] = res
        print(f"64-row blocks at a {T}-row prefill forward: correction matmuls + rmsnorms {res['blocked_ms']:.3f} ms "
              f"in blocks vs {res['one_call_ms']:.3f} ms in one call each", flush=True)
    return out


def event_ms(fn, reps: int) -> float:
    """Milliseconds per ``fn(i)`` between CUDA events over ``reps`` eager
    calls (for code that reads the device, which a CUDA graph cannot hold)."""
    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def to_cpu(x):
    """A K2 operand (a tensor, an int8 half, or a tuple of them) copied to
    the host."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    if hasattr(x, "scales"):
        return type(x)(x.data.cpu(), x.scales.cpu())
    return x.cpu()


def k2_contracts(attn, kvc, fn, qg, halves, pos, paged_args, T: int, label: str) -> None:
    """K2's bit-for-bit contracts on the card: (a) a verify launch's row t
    equals a decode launch at pos+t; (b) a row launched alone equals the
    same row in the batch; (c) a row read wholly through pool pages equals
    the same KV through the slab; (d) two launches on the same inputs are
    equal."""
    (slab_k, slab_v), (pool_k, pool_v, tables, matched) = halves, paged_args
    out = fn(qg, slab_k, slab_v, pos, 512, paged_args)
    check(torch.equal(out, fn(qg, slab_k, slab_v, pos, 512, paged_args)), f"K2 {label}: (d) two launches differ")
    if T > 1:
        for t in range(T):
            dec = attn.fused_paged_decode_attention(qg[:, t].contiguous(), slab_k, slab_v, pos + t, 512, paged_args)
            check(torch.equal(out[:, t], dec), f"K2 {label}: (a) verify row {t} differs from a decode at pos+{t}")
    for b in range(qg.shape[0]):
        alone = fn(qg[b:b + 1].contiguous(), slab_k[b:b + 1], slab_v[b:b + 1], pos[b:b + 1], 512,
                   (pool_k, pool_v, tables[b:b + 1].contiguous(), matched[b:b + 1].contiguous()))
        check(torch.equal(alone, out[b:b + 1]), f"K2 {label}: (b) row {b} alone differs from it in the batch")
    S = slab_k.shape[1]
    full = torch.full_like(matched, S)
    virt = [kvc.virtual_rows_batched(h[:qg.shape[0]], p, tables, full) for h, p in ((slab_k, pool_k), (slab_v, pool_v))]
    via_pool = fn(qg, slab_k, slab_v, pos, 512, (pool_k, pool_v, tables, full))
    via_slab = fn(qg, virt[0], virt[1], pos, 512, None)
    check(torch.equal(via_pool, via_slab), f"K2 {label}: (c) pool pages and slab rows of the same KV differ")
    print(f"K2 {label}: bit for bit (a) verify row t == decode at pos+t{'' if T > 1 else ' (T=1: n/a)'}, "
          f"(b) row alone == in the batch, (c) pool == slab, (d) repeat launches", flush=True)


def k2_pass_checks(attn, fn, qg, halves, pos, paged_args, label: str, tol: float) -> dict:
    """K2's two passes, each against its plain version: the chunk partials,
    the fold on the plain workspace, and the two passes composed equal to
    the whole call bit for bit. A partial is held where the plain chunk is
    live (elsewhere the empty partial, identical): m within tol of max |m|,
    and l and o by their share of the output, weighted by the plain
    exp(m_c - m_max) / l_total, within tol of 1 and of max |out|, the
    output's own tolerance (a bf16 weight flipped by an ulp of exp moves o
    by as much as it moves the output)."""
    slab_k, slab_v = halves
    ws = attn.paged_attention_partials(qg, slab_k, slab_v, pos, 512, paged_args)
    ws_plain = attn.paged_attention_partials_plain(*to_cpu((qg, slab_k, slab_v, pos)), 512,
                                                   to_cpu(paged_args)).to(qg.device)
    torch.cuda.synchronize()
    m_p = ws_plain[..., 0]
    live = torch.isfinite(m_p)
    check(torch.equal(live, torch.isfinite(ws[..., 0])) and torch.equal(ws[~live], ws_plain[~live]),
          f"K2 {label}: the partials' empty entries differ from the plain version's")
    weight = torch.exp(m_p - m_p.amax(dim=2, keepdim=True))  # 0 where the chunk is empty
    share = (weight / (ws_plain[..., 1] * weight).sum(dim=2, keepdim=True))[live]
    out_scale = attn.paged_attention_fold_plain(ws_plain.cpu(), qg.shape).abs().max().item()
    g, w = ws[live], ws_plain[live]
    errs = {}
    for name, err, scale in (
            ("m", (g[:, 0] - w[:, 0]).abs().max().item(), w[:, 0].abs().max().item()),
            ("l", ((g[:, 1] - w[:, 1]).abs() * share).max().item(), 1.0),
            ("o", ((g[:, 2:] - w[:, 2:]).abs() * share[:, None]).max().item(), out_scale)):
        check(err <= tol * scale, f"K2 {label}: partials {name} err {err} > {tol} x {scale}")
        errs[f"partials_{name}_max_abs_err"] = err
    fold = attn.paged_attention_fold(ws_plain, qg.shape)
    fold_plain = attn.paged_attention_fold_plain(ws_plain.cpu(), qg.shape).to(qg.device)
    err = (fold - fold_plain).abs().max().item()
    scale = fold_plain.abs().max().item()
    check(err <= K2_FOLD_TOL_REL * scale, f"K2 {label}: fold err {err} > {K2_FOLD_TOL_REL} x {scale}")
    errs["fold_max_abs_err"] = err
    check(torch.equal(attn.paged_attention_fold(ws, qg.shape), fn(qg, slab_k, slab_v, pos, 512, paged_args)),
          f"K2 {label}: partials + fold differ from the whole call")
    print(f"K2 {label}: partials vs plain m/l/o err (l, o as shares of the output) {errs['partials_m_max_abs_err']:.2e}/"
          f"{errs['partials_l_max_abs_err']:.2e}/{errs['partials_o_max_abs_err']:.2e}; fold vs plain {err:.2e}; "
          f"partials + fold == the whole call", flush=True)
    return errs


def k2_exact(kvc, qg, halves, paged_args, pos_l: list, i8: bool, chunk: int = 512) -> dict:
    """K2's function in f64 on the operands as the kernel reads them (q
    rounded to the cache's compute dtype, the slab rows and pool pages of
    every row's virtual KV), per query n of [N = B*T*K*M]: the exact output
    [N, hd]; and, for bf16 and int8 caches, the pieces of the one-ulp flip
    of a bf16 softmax weight at every position j of [L]: the weight before
    rounding, w = exp(s_j - m_chunk) (times the value scale for int8), and
    the output's move when w's rounding moves by one bf16 ulp,
    exp(m_chunk - m) * ulp(w) * u_j / l (u: the values as mixed, raw int8
    for an int8 half; l: the f64 sum of the unscaled weights)."""
    (slab_k, slab_v), (pool_k, pool_v, tables, matched) = halves, paged_args
    dev = qg.device
    B, K, M, hd = qg.shape[0], qg.shape[-3], qg.shape[-2], qg.shape[-1]
    T = qg.shape[1] if qg.dim() == 5 else 1
    S = (slab_k.data if i8 else slab_k).shape[1]
    L = min(max(pos_l) + T, S)
    q = qg.reshape(B, T, K, M, hd).to(torch.bfloat16 if i8 else slab_k.dtype).double()

    def rows(slab, pool):  # [B, L, K, hd] values as mixed, [B, L, K] scale
        v = kvc.virtual_rows_batched(slab, pool, tables, matched)
        if i8:
            return v.data[:, :L].double(), v.scales[:, :L, :, 0].double()
        return v[:, :L].double(), torch.ones((B, L, K), dtype=torch.float64, device=dev)

    (kd, ks), (vd, vs) = rows(slab_k, pool_k), rows(slab_v, pool_v)
    s = torch.einsum("btkmh,bjkh->btkmj", q, kd) * ks.permute(0, 2, 1)[:, None, :, None, :] / math.sqrt(hd)
    del kd, ks
    qpos = torch.tensor(pos_l, device=dev)[:, None] + torch.arange(T, device=dev)[None, :]
    live = (torch.arange(L, device=dev)[None, None, :] <= qpos[:, :, None])[:, :, None, None, :]
    s = s.masked_fill(~live, -math.inf)
    vscale = vs.permute(0, 2, 1)[:, None, :, None, :]  # [B, 1, K, 1, L]
    exact = torch.einsum("btkmj,bjkh->btkmh", torch.softmax(s, dim=-1) * vscale, vd)
    out = dict(exact=exact.reshape(-1, hd), vd=vd, K=K, M=M, T=T)
    n_c = -(-L // chunk)
    sc = torch.nn.functional.pad(s, (0, n_c * chunk - L), value=-math.inf).reshape(*s.shape[:-1], n_c, chunk)
    m_c = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - torch.where(torch.isfinite(m_c), m_c, 0.0))  # 0 where masked
    m = m_c.amax(dim=-2, keepdim=True)
    a_c = torch.where(torch.isfinite(m_c), torch.exp(m_c - m), 0.0)
    l_tot = (a_c * p).sum(dim=(-2, -1), keepdim=True)
    w = (p * torch.nn.functional.pad(vscale, (0, n_c * chunk - L), value=0.0).reshape(*vscale.shape[:-1], n_c,
                                                                                       chunk)).flatten(-2)[..., :L]
    ulp = torch.where(w > 0, torch.exp2(torch.floor(torch.log2(w.clamp_min(1e-300))) - 7), 0.0)
    out.update(w=w.reshape(-1, L), ulp=ulp.reshape(-1, L),
               coef=(ulp * (a_c / l_tot).expand(*a_c.shape[:-1], chunk).flatten(-2)[..., :L]).reshape(-1, L))
    return out


def k2_flips(ex: dict, got: torch.Tensor, want: torch.Tensor, tol_abs: float, label: str) -> list:
    """Account for every query of ``got`` (K2) further than ``tol_abs`` from
    ``want`` (its plain version) by one-ulp flips of bf16 softmax weights
    (:func:`k2_exact`), greedily: at each step the position whose flip
    vector best explains the gap left, K2_MAX_FLIPS at most. Returns one
    dict per such query: its index, the gap before and after, and each
    flip's position, weight, multiple of one ulp's move and distance from a
    rounding midpoint (in ulps)."""
    gap = (got - want).double().reshape(-1, ex["exact"].shape[1])
    K, M, T = ex["K"], ex["M"], ex["T"]
    found = []
    for n in (gap.abs().amax(dim=1) > tol_abs).nonzero().flatten().tolist()[:16]:
        b, k = n // (T * K * M), n // M % K
        r, flips = gap[n].clone(), []
        delta = ex["coef"][n][:, None] * ex["vd"][b, :, k]  # [L, hd]: one ulp's move at each position
        norm2 = (delta * delta).sum(dim=1)
        for _ in range(K2_MAX_FLIPS):
            if r.abs().max().item() <= tol_abs:
                break
            c = (delta @ r) / norm2.clamp_min(1e-300)
            j = int(torch.argmax(c * c * norm2))
            mult = round(float(c[j]))
            if mult == 0:
                break
            frac = float(ex["w"][n, j] / ex["ulp"][n, j]) % 1.0
            flips.append(dict(position=j, weight=float(ex["w"][n, j]), ulp_multiple=float(c[j]),
                              midpoint_distance=abs(frac - 0.5)))
            r = r - mult * delta[j]
        found.append(dict(query=n, gap=float(gap[n].abs().max()), left=float(r.abs().max()), flips=flips))
        print(f"  K2 {label}: query {n} (row {b}, kv head {k}) gap {found[-1]['gap']:.3e} > {tol_abs:.3e}; "
              + "; ".join(f"flip at position {f['position']} (weight {f['weight']:.6f}, "
                          f"{f['ulp_multiple']:+.4f} ulp, {f['midpoint_distance']:.2e} ulp from the midpoint)"
                          for f in flips) + f"; gap left {found[-1]['left']:.3e}", flush=True)
    return found


def k2_checks(attn, kvc, contracts: bool = True, strict: bool = True) -> list:
    """Phase 6a: K2 against its plain version at the K2_CASES, timed, for
    bf16 and f32 caches (T = 1 and 3) and the int8 cache (T = 1 and 5, the
    verify window of --spec-draft 4), whose halves are ``quantize_rows`` of
    the same kind of random inputs; at the contract cases also its
    bit-for-bit contracts and each of its two passes (``contracts``).
    ``strict`` False (timing another tree's K2) skips the cases that tree
    refuses, reports a result out of tolerance and goes on."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for label, K, M, hd, pos_l, matched_l, S, dtypes, Ts, with_contracts in K2_CASES:
        if not strict and label in K2_NEW_CASES:
            continue
        B = len(pos_l)
        n_table = S // K2_PAGE
        for dtype in dtypes:
            i8 = dtype == "i8"
            # bytes of one cache position of one half and row
            pos_bytes = K * (hd + 4) if i8 else K * hd * torch.empty(0, dtype=dtype).element_size()

            def half(shape):
                x = torch.randn(shape, device=dev, generator=g)
                return kvc.QuantizedKV(*kvc.quantize_rows(x)) if i8 else x.to(dtype)

            n_pages = B * n_table
            set_bytes = 2 * (B * S + n_pages * K2_PAGE) * pos_bytes
            copies = max(2, math.ceil(256e6 / set_bytes))  # each timed launch reads its KV from HBM
            sets = [(half((2, B, S, K, hd)), half((2, n_pages, K2_PAGE, K, hd))) for _ in range(copies)]
            tables = torch.stack([torch.randperm(n_pages, device=dev, generator=g)[:n_table] for _ in range(B)])
            tables = tables.to(torch.int32)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            matched = torch.tensor(matched_l, dtype=torch.int32, device=dev)
            for T in Ts or ((1, 5) if i8 else (1, 3)):
                shape = (B, T, K, M, hd) if T > 1 else (B, K, M, hd)
                qg = torch.randn(shape, device=dev, generator=g)
                fn = attn.fused_paged_verify_attention if T > 1 else attn.fused_paged_decode_attention

                def paged(i):
                    slab, pool = sets[i % copies]
                    return (pool[0], pool[1], tables, matched)

                run = lambda i: fn(qg, sets[i % copies][0][0], sets[i % copies][0][1], pos, 512, paged(i))
                plain = lambda i: attn.paged_attention_plain(qg, sets[0][0][0], sets[0][0][1], pos, 512, paged(0))
                # the reference is the plain version on the host's CPU: on
                # the card its einsums go through cuBLAS, whose f32 sums move
                # scores by ulps that flip bf16 weights (PERF.md); the
                # kernel's distance to the card's plain run is reported too
                got, want_card = run(0), plain(0)
                want = attn.paged_attention_plain(*to_cpu((qg, sets[0][0][0], sets[0][0][1], pos)), 512,
                                                  to_cpu(paged(0))).to(dev)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                card_err = (got - want_card).abs().max().item()
                tol = K2_TOL_REL[dtype]
                name = f"paged_attention{'_i8' if i8 else ''}"
                # both against K2's function in f64 on the same operands
                ex = k2_exact(kvc, qg, sets[0][0], paged(0), pos_l, i8)
                exact_err = {who: (x.double().reshape(ex["exact"].shape) - ex["exact"]).abs().max().item()
                             for who, x in (("kernel", got), ("plain", want))}
                flips = []
                if math.isfinite(err) and err > tol * scale and dtype != torch.float32:
                    flips = k2_flips(ex, got, want, tol * scale, f"{label} T={T} {dtype}")
                explained = bool(flips) and all(
                    f["left"] <= tol * scale and f["flips"] and all(
                        abs(abs(x["ulp_multiple"]) - 1) <= K2_FLIP_ULP_TOL and x["midpoint_distance"] <= K2_MIDPOINT
                        for x in f["flips"]) for f in flips)
                del ex
                gate(strict, math.isfinite(err) and (err <= tol * scale or explained),
                     f"{name} {label} T={T} {dtype}: max abs err {err} > {tol} x {scale}, not one-ulp bf16 "
                     f"weight flips at rounding midpoints")
                gate(strict, exact_err["kernel"] <= exact_err["plain"] + tol * scale,
                     f"{name} {label} T={T} {dtype}: {exact_err['kernel']} from the f64 function, the plain "
                     f"version {exact_err['plain']} (+ {tol} x {scale})")
                extra = {}
                if contracts and with_contracts:
                    k2_contracts(attn, kvc, fn, qg, sets[0][0], pos, paged(0), T, f"{label} T={T} {dtype}")
                    extra = k2_pass_checks(attn, fn, qg, sets[0][0], pos, paged(0), f"{label} T={T} {dtype}", tol)
                    extra["partials_ms"] = cuda_ms(lambda i: attn.paged_attention_partials(
                        qg, sets[i % copies][0][0], sets[i % copies][0][1], pos, 512, paged(i)), reps=50)
                    ws0 = attn.paged_attention_partials_plain(qg, sets[0][0][0], sets[0][0][1], pos, 512, paged(0))
                    extra["fold_ms"] = cuda_ms(lambda i: attn.paged_attention_fold(ws0, qg.shape), reps=50)
                    print(f"K2 {label} T={T} {dtype}: partials pass {extra['partials_ms']:.4f} ms, fold pass "
                          f"{extra['fold_ms']:.4f} ms", flush=True)
                ms = cuda_ms(run, reps=50)
                plain_ms = event_ms(plain, reps=5)
                # the library yardstick: gather every row's pages into a
                # dense view (the page-table gather; for int8 then
                # dequantized, data * scale, to bf16), then SDPA over the
                # live length with a causal mask per row and query
                sd_dtype = torch.bfloat16 if i8 else dtype
                L = min(max(pos_l) + T, S)
                kpos = torch.arange(L, device=dev)
                qpos = (pos[:, None] + torch.arange(T, device=dev)[None, :]).repeat_interleave(M, dim=1)
                mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]  # [B, 1, T*M, L]
                q_sd = qg.reshape(B, T, K, M, hd).permute(0, 2, 1, 3, 4).reshape(B, K, T * M, hd).to(sd_dtype)

                def gather(i):
                    slab, pool = sets[i % copies]
                    kv = []
                    for h in (0, 1):
                        v = kvc.virtual_rows_batched(slab[h], pool[h], tables, matched)[:, :L]
                        if i8:
                            v = (v.data.to(torch.float32) * v.scales).to(torch.bfloat16)
                        kv.append(v.transpose(1, 2))
                    return kv

                def library(i):
                    k_sd, v_sd = gather(i)
                    return torch.nn.functional.scaled_dot_product_attention(q_sd, k_sd, v_sd, attn_mask=mask)

                lib_ms = cuda_ms(library, reps=5, warmup=1)
                k_sd, v_sd = gather(0)
                sdpa_ms = cuda_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
                    q_sd, k_sd, v_sd, attn_mask=mask), reps=20)
                del k_sd, v_sd
                live = sum(min(p + T, S) for p in pos_l)
                need_bytes = 2 * live * pos_bytes + 2 * qg.numel() * 4 + tables.numel() * 4 + 2 * B * 4
                bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 4.0 * live * K * M * T * hd / BF16_OPS_PER_S * 1e3
                row = dict(kernel=name, case=label, S=S, B=B, K=K, M=M, hd=hd, T=T, dtype=str(dtype),
                           pos=pos_l, matched=matched_l, max_abs_err=err, max_rel_err=err / max(scale, 1e-30),
                           tol_rel=tol, card_plain_rel_err=card_err / max(scale, 1e-30),
                           kernel_f64_rel_err=exact_err["kernel"] / max(scale, 1e-30),
                           plain_f64_rel_err=exact_err["plain"] / max(scale, 1e-30), weight_flips=flips, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, sdpa_only_ms=sdpa_ms,
                           bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           **extra)
                rows.append(row)
                print(f"{name} {label} T={T} {str(dtype).replace('torch.', ''):8s} err {err:.3e} (rel "
                      f"{row['max_rel_err']:.1e} <= {tol:.0e}{' after flips' if flips else ''}; vs the card's "
                      f"plain run {row['card_plain_rel_err']:.1e}; vs f64 kernel {row['kernel_f64_rel_err']:.1e}, "
                      f"plain {row['plain_f64_rel_err']:.1e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"library {lib_ms:.4f} ms (SDPA alone {sdpa_ms:.4f}) bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})", flush=True)
            del sets
            torch.cuda.empty_cache()
    return rows


def launch_floor_ms() -> float:
    """Device ms of the smallest kernel, an in-place add to one element,
    timed as the kernels are (one CUDA graph of many launches): the floor
    under any one launch."""
    tiny = torch.zeros(1, device="cuda")
    return cuda_ms(lambda i: tiny.add_(1.0), reps=200)


def k4_checks(coll, row_counts=(1, 16)) -> list:
    """Phase 7a: K4 against its plain version, bit for bit on every rank,
    for n = 2 and 4 ranks at the decode payload [1, 4096] and prefill
    payloads [R, 4096] (``row_counts``: 16, and the rows phase 7c's prefill
    launches it with), timed against the bound (n inputs read and n outputs
    written over 3.35 TB/s), the plain version and the library yardstick
    (torch.stack(xs).sum(0) and the n copies)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for n in TP_SIZES:
        for R in row_counts:
            xs = [torch.randn((R, DIM), device=dev, generator=g) for _ in range(n)]
            got = coll.ring_all_reduce(xs)
            want = coll.ring_all_reduce_plain(xs)
            torch.cuda.synchronize()
            check(all(torch.equal(o, got[0]) for o in got), f"K4 n={n} R={R}: ranks hold different bytes")
            check(all(torch.equal(o, w) for o, w in zip(got, want)), f"K4 n={n} R={R}: differs from its plain version")
            err = max((o - w).abs().max().item() for o, w in zip(got, want))
            ms = cuda_ms(lambda i: coll.ring_all_reduce(xs), reps=200)
            plain_ms = event_ms(lambda i: coll.ring_all_reduce_plain(xs), reps=20)

            def library(i):
                s = torch.stack(xs).sum(0)
                return [s.clone() for _ in range(n)]

            lib_ms = cuda_ms(library, reps=50)
            bound_ms = 2 * n * R * DIM * 4 / HBM_BYTES_PER_S * 1e3
            row = dict(kernel="ring_all_reduce", n=n, R=R, d=DIM, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by="bytes")
            rows.append(row)
            print(f"ring_all_reduce n={n} [{R}, {DIM}] bit-equal to plain on every rank; kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms library {lib_ms:.4f} ms bound {bound_ms:.6f} ms (bytes)", flush=True)
    return rows


def k5_checks(q40, coll, strict: bool = True) -> list:
    """Phase 7b: K5 at the 7B wo and down shard shapes for tp = 2 and 4
    (T = 1, and T = 8, a prefill bucket): bit-equal to the K1 kernel, then
    the bias correction, then the K4 kernel on the same inputs, and within
    K1's tolerance of its plain version; timed against the bound (the whole
    matrix's Q40 bytes, the activations, corrections and the n outputs over
    3.35 TB/s), the plain version and the library yardstick (per rank
    dequantize + bf16 matmul, then the stacked sum). Prints the cluster
    shape K5 launches with. For another tree's port (``strict`` False) a
    failed check is printed, not fatal."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rows = []

    for n in TP_SIZES:
        cluster = coll.k5_cluster_dims(n) if hasattr(coll, "k5_cluster_dims") else None
        print(f"K5 at tp={n}: cluster shape {cluster} (CTAs per cluster along x, y, z)")
        for shape, (n_full, d) in (("wo", (DIM, DIM)), ("down", (HIDDEN, DIM))):
            n_shard = n_full // n
            n_pad = q40._n_padded(n_shard)
            w_bytes = n * (n_pad // 2 * d + n_pad // 32 * d * 4)
            copies = max(2, math.ceil(256e6 / w_bytes))  # each timed launch reads its weights cold
            sets = [[q40.QuantizedMatrix(
                torch.randint(0, 256, (n_pad // 2, d), dtype=torch.uint8, device=dev, generator=g),
                torch.rand((n_pad // 32, d), device=dev, generator=g) / (4.6 * math.sqrt(n_full)),
                n_logical=n_shard, d_logical=d) for _ in range(n)] for _ in range(copies)]
            for T in (1, 8):
                xs = [torch.randn((T, n_shard), device=dev, generator=g).to(torch.bfloat16) for _ in range(n)]
                qms = sets[0]
                check(coll.fused_ring_eligible(xs, qms), f"K5 {shape} tp={n} T={T} not eligible")
                l0 = coll.launches["fused_matmul_ring"]
                fused = coll.fused_matmul_ring_all_reduce(xs, qms)
                check(coll.launches["fused_matmul_ring"] == l0 + 1, "K5 did not launch")
                unfused = coll.ring_all_reduce([q40._int8_core(*q40.quantize_for(x, qm), qm)
                                                for x, qm in zip(xs, qms)])
                preps = [q40.quantize_for(x, qm) for x, qm in zip(xs, qms)]
                corrs = [q40.bias_correction(xq, sx, qm) for (xq, sx), qm in zip(preps, qms)]
                args = ([p[0] for p in preps], [p[1] for p in preps], corrs)
                plain = coll.fused_matmul_ring_plain(*args, [qm.qs for qm in qms], [qm.scales for qm in qms])
                torch.cuda.synchronize()
                gate(strict, all(torch.equal(f, fused[0]) for f in fused),
                     f"K5 {shape} tp={n}: ranks hold different bytes")
                gate(strict, all(torch.equal(f, u) for f, u in zip(fused, unfused)),
                     f"K5 {shape} tp={n} T={T}: differs from K1 + correction + K4")
                again = coll.fused_matmul_ring_all_reduce(xs, qms)
                torch.cuda.synchronize()
                gate(strict, all(torch.equal(f, a) for f, a in zip(fused, again)),
                     f"K5 {shape} tp={n} T={T}: repeats differ")
                err = (fused[0] - plain[0]).abs().max().item()
                scale = plain[0].abs().max().item()
                gate(strict, math.isfinite(err) and err <= TOL_REL["q40_int8"] * scale,
                     f"K5 {shape} tp={n} T={T}: max abs err {err} > {TOL_REL['q40_int8']} x {scale}")

                def run(i):
                    c = sets[i % copies]
                    return coll.fused_matmul_ring(*args, [qm.qs for qm in c], [qm.scales for qm in c])

                ms = cuda_ms(run, reps=50)
                plain_ms = event_ms(lambda i: coll.fused_matmul_ring_plain(
                    *args, [qm.qs for qm in qms], [qm.scales for qm in qms]), reps=3)

                def library(i):
                    c = sets[i % copies]
                    return torch.stack([x @ q40.dequantize_tpu(qm).to(torch.bfloat16) for x, qm in zip(xs, c)]).sum(0)

                lib_ms = cuda_ms(library, reps=5, warmup=1)
                need_bytes = w_bytes + n * T * (n_pad + n_pad // 32 * 4) + 2 * n * T * d * 4
                bytes_ms = need_bytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 2.0 * T * n * n_pad * d / INT8_OPS_PER_S * 1e3
                row = dict(kernel="fused_matmul_ring", shape=shape, tp=n, n_shard=n_shard, d=d, T=T, cluster=cluster,
                           max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol_rel=TOL_REL["q40_int8"],
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations")
                rows.append(row)
                print(f"fused_matmul_ring {shape:5s} tp={n} T={T} == K1 + correction + K4 bit for bit; err vs plain "
                      f"{err:.3e} (rel {row['max_rel_err']:.1e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"library {lib_ms:.4f} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            del sets
            torch.cuda.empty_cache()
    return rows


def tp_runs(cli, llama, coll, q40, model: str, tok: str) -> dict:
    """Phase 7c: the CLI ``generate`` at 7B width with ``--tp 1``, ``--tp 2
    --allreduce ring`` and ``--tp 4 --allreduce ring`` on one card. For each
    tp > 1: K4 and K5 launched on the run, every rank's residual stream
    byte-identical after a prefill, first-step logits within TP_LOGIT_TOL of
    max |logit| of tp=1's, and the greedy tokens matching tp=1's before the
    first divergence; ms/token and device-busy ms/token of each tp."""
    prompt = TP_PROMPT

    def args(tp):
        return cli.build_parser().parse_args([
            "inference", "--model", model, "--tokenizer", tok, "--dtype", "q40", "--decode", "device",
            "--max-seq-len", str(SEQ_LEN), "--steps", "64", "--decode-chunk", "8", "--temperature", "0",
            "--seed", "1", "--prompt", prompt, "--tp", str(tp), "--allreduce", "ring"])

    out: dict = {}
    ref_logits = ref_tokens = None
    for tp in (1, *TP_SIZES):
        t_load = time.perf_counter()
        built = cli.make_engine(args(tp))
        engine = built[0]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t_load
        prompt_tokens = built[1].encode(prompt, add_bos=True)
        check(len(prompt_tokens) > 8, "the phase-7 prompt must prefill past the K5 gate (T > 8)")
        engine.reset()
        logits = engine.prefill(prompt_tokens)
        check(bool(np.isfinite(logits).all()) and logits.shape == (engine.cfg.vocab_size,), "tp logits")
        row = dict(tp=tp, load_s=load_s, transfer_ms_per_token=engine._transfer_ms)
        if tp > 1:
            # every rank's residual stream after the prompt, byte for byte
            caches = engine.tp_backend.init_cache(engine.cache_dtype)
            toks = torch.tensor(prompt_tokens, dtype=torch.int64, device=engine.device)
            xs, _ = llama.forward_hidden_tp(engine.cfg, engine.params, toks, caches, 0, "int8", "ring")
            check(all(torch.equal(x, xs[0]) for x in xs), f"tp={tp}: rank residual streams differ")
            del caches, xs
            err = float(np.abs(logits - ref_logits).max())
            tol = TP_LOGIT_TOL * float(np.abs(ref_logits).max())
            print(f"tp={tp}: ranks' residual streams byte-identical; first-step logits vs tp=1 max diff {err:.4g} "
                  f"(tolerance {tol:.4g}, {TP_LOGIT_TOL} of max |logit|), argmax {int(logits.argmax())} vs "
                  f"{int(ref_logits.argmax())}")
            check(err <= tol, f"tp={tp}: first-step logits differ from tp=1's by {err} > {tol}")
            row.update(logit_diff=err, logit_tol=tol, residuals_identical=True)
        else:
            ref_logits = logits
        engine.reset()
        coll.reset_launches()
        q40.reset_launches()
        stream = engine.default_stream
        f0 = stream.forwards
        res = cli.generate(args(tp), benchmark=False, built=built)
        torch.cuda.synchronize()
        launches = {**coll.launches, **q40.launches}
        forwards = stream.forwards - f0
        tokens = res["tokens"]
        check(len(tokens) > 0 and all(0 <= t < engine.cfg.vocab_size for t in tokens), f"tp={tp}: tokens")
        if tp == 1:
            ref_tokens = tokens
        else:
            check(launches["ring_all_reduce"] > 0 and launches["fused_matmul_ring"] > 0,
                  f"tp={tp}: K4/K5 not launched on the path: {launches}")
            same = next((i for i, (a, b) in enumerate(zip(tokens, ref_tokens)) if a != b),
                        min(len(tokens), len(ref_tokens)))
            row.update(tokens_equal_to_tp1_before_divergence=same, tokens_compared=min(len(tokens), len(ref_tokens)))
            print(f"tp={tp}: {same} of {min(len(tokens), len(ref_tokens))} greedy tokens equal tp=1's before the "
                  f"first divergence")
        row.update(tokens=tokens, forwards=forwards, launches=launches)
        print(f"tp={tp}: {len(tokens)} tokens in {forwards} forwards; launches {launches}; engine load {load_s:.1f} s, "
              f"transfer probe {engine._transfer_ms:.3f} ms/token")
        # decode timing of the same engine, fenced by synchronize
        engine.reset()
        first = int(engine.prefill(prompt_tokens).argmax())
        engine.decode_chunk(first, 4, 0.0, 0.9)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_chunk(first, 8, 0.0, 0.9)
        decode_ms = (time.perf_counter() - t0) * 1e3 / 8
        row["decode_ms_per_token"] = decode_ms
        print(f"tp={tp}: decode {decode_ms:.2f} ms/token over 8 greedy tokens")
        row.update(device_profile(engine, first, decode_ms, steps=4))
        row["wall_s"] = time.perf_counter() - t_load
        print(f"tp={tp}: {row['wall_s']:.1f} s in all")
        out[f"tp{tp}"] = row
        del engine, built
        gc.collect()
        torch.cuda.empty_cache()
    return out


def spec_window_check(engine, llama, prompt_tokens: list, k: int = 4) -> dict:
    """Phase 5, the single-stream verify window against decode: after the
    prompt, k + 1 greedy decode steps one at a time give k + 1 logit rows;
    the same k + 1 tokens as one verify window (what ``--spec-draft k``
    runs) give them again, once with each query row attending on its own
    (``per_position``, the repaired window) and once through T-row
    attention einsums (the window before the repair). Returns the max abs
    difference of each from the decode rows; the repaired one must be 0."""
    stream = engine.default_stream
    engine.reset()
    logits = engine.prefill(prompt_tokens)
    start = engine.pos
    feed, rows = [int(logits.argmax())], []
    for _ in range(k + 1):
        rows.append(engine.decode_step(feed[-1]))
        feed.append(int(rows[-1].argmax()))
    decode = torch.from_numpy(np.stack(rows)).to(engine.device)
    toks = torch.tensor(feed[: k + 1], dtype=torch.int64, device=engine.device)
    out = {}
    for name, per_position in (("before", False), ("after", True)):
        stream.rollback(start)
        window, stream.cache = llama.forward_tokens(engine.cfg, engine.params, toks, stream.cache, start,
                                                    engine.q40_path, per_position=per_position)
        out[name] = float((window - decode).abs().max())
    engine.reset()
    print(f"  verify window of {k + 1} vs {k + 1} decode steps: max |logit diff| {out['before']:.3e} with T-row "
          f"attention (before the repair), {out['after']:.3e} per position (after)")
    check(out["after"] == 0.0, "the repaired verify window differs from decode")
    return out


def chunk_delivery(engine, first: int, sleep_cycles: int = 200_000_000) -> dict:
    """Phase 5, chunk delivery: how late chunk k's tokens reach the host after
    chunk k+1 is issued, fetched the old way (a blocking ``.cpu()``, queued
    behind chunk k+1) and the repaired way (a pinned copy started at
    dispatch, waited on by its own event). Measured on the real decode and
    with ``torch.cuda._sleep`` of ``sleep_cycles`` queued at the end of chunk
    k+1, which stands for a chunk whose device time outlasts its issue."""
    from distributed_llama_tpu_torch.platform import HostFetch

    stream = engine.default_stream
    out = {}
    for sleep in (False, True):
        for way in ("blocking .cpu()", "pinned copy + event"):
            engine.reset()
            engine.prefill([1, 5, 9, first])
            torch.cuda.synchronize()
            toks_k = stream._dispatch_chunk(first, 8, 0.0, 0.9, 0, 0)
            fetch_k = HostFetch(toks_k)
            toks_k1 = stream._dispatch_chunk(toks_k[-1], 8, 0.0, 0.9, 0, 0)
            if sleep:
                torch.cuda._sleep(sleep_cycles)
            fetch_k1 = HostFetch(toks_k1)
            t0 = time.perf_counter()
            got = toks_k.cpu().numpy() if way == "blocking .cpu()" else fetch_k.wait()
            lag_ms = (time.perf_counter() - t0) * 1e3
            k1_running = not fetch_k1.ready()
            fetch_k1.wait()
            check(np.array_equal(got, fetch_k.wait()), "chunk tokens differ between the two fetches")
            key = f"{way}{' + device sleep' if sleep else ''}"
            out[key] = dict(lag_ms=lag_ms, next_chunk_still_running=k1_running)
            print(f"  chunk k fetched by {key}: {lag_ms:.3f} ms after chunk k+1 was issued; "
                  f"chunk k+1 still running then: {k1_running}")
    check(out["pinned copy + event + device sleep"]["next_chunk_still_running"],
          "chunk k's tokens did not reach the host while chunk k+1 was still running")
    return out


def device_ms_by_name(prof) -> dict[str, float]:
    """Device time by kernel name from a finished torch.profiler trace, read
    from its raw kineto events: the durations ``prof.events()`` gives its
    device events, without building the host-side event tree, which took
    14-32 s per server-phase profile (PR 9's third chip call)."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return out


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
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values()) / steps
    # the raw events against the event tree, on this short window
    tree_ms = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3
    print(f"  device time from the raw events {busy * steps:.3f} ms, from prof.events() {tree_ms:.3f} ms")
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
        check(gpu.weights_checksum() == cpu.weights_checksum(),
              f"weight checksums differ: card {gpu.weights_checksum()}, CPU {cpu.weights_checksum()}")
        print(f"small model ({q40_path}): weights_checksum {gpu.weights_checksum()} on the card equals the CPU's")
        del gpu, cpu


class RouteRecorder:
    """Records the expert ids and the smallest routing margin (k-th minus
    (k+1)-th probability, real rows only) of every router call of the
    port's ``models.moe`` while active."""

    def __init__(self, moe):
        self.moe, self.orig = moe, moe.router_topk
        self.ids: list = []  # per call: [rows, k] expert ids
        self.margins: list = []  # per call: [rows] margins
        self.rows = None  # rows of each call that are real (None: all)

    @property
    def margin(self) -> float:
        return min(float(m.min()) for m in self.margins)

    def __enter__(self):
        def spy(cfg, xn, router):
            vals, idx = self.orig(cfg, xn, router)
            probs = torch.sort(self.moe.router_probs(cfg, xn, router), dim=-1, descending=True).values
            k = cfg.n_active_experts
            n = self.rows or idx.shape[0]
            self.ids.append(idx[:n].cpu())
            self.margins.append((probs[:n, k - 1] - probs[:n, k]).cpu())
            return vals, idx

        self.moe.router_topk = spy
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.orig


def small_moe_check(synthetic, InferenceEngine, moe, q40, workdir: Path) -> dict:
    """Phase 4, MoE: a small Mixtral and a small Grok-1 (dim 1024, hidden
    1024, 2 layers, 8 experts, 2 active, Q40, every matmul kernel-eligible)
    on the card against the same engine on the CPU, on both Q40 paths, 2
    prompts x 5 forwards each, every one compared: the chosen expert ids of
    every prefill row and decode step equal on every layer, every routing
    margin above ROUTE_MARGIN, then the logits within 5% of max |logit| (the
    tolerance of the dense small model). On the f32 path the CPU engine
    computes the dequant matmuls in bf16 as the card does
    (``q40.CPU_DEQUANT_DTYPE``), not in f32: f32 moves router probabilities
    by ~1e-2 and so swaps experts at margins of several 1e-3."""
    from distributed_llama_tpu_torch.formats.model_file import ArchType, HiddenAct
    from distributed_llama_tpu_torch.quants import FloatType

    prompts = ([1, 5, 9], [1, 300, 17, 42, 7, 99, 250, 3, 11, 64, 128])
    steps = 5
    out = {}
    for arch, seed in MOE_SMALL_SEEDS.items():
        grok = arch == "grok"
        spec = synthetic.tiny_spec(
            arch_type=ArchType.GROK1 if grok else ArchType.MIXTRAL, dim=1024, hidden_dim=1024, n_layers=2,
            n_heads=8, n_kv_heads=4, n_experts=8, n_active_experts=2,
            hidden_act=HiddenAct.GELU if grok else HiddenAct.SILU, vocab_size=512, seq_len=1024,
            weights_float_type=FloatType.Q40)
        path = str(workdir / f"small_{arch}.m")
        synthetic.write_synthetic_model(path, spec, seed=seed)
        res = dict(seed=seed, min_routing_margin=float("inf"), max_rel_logit_diff={}, forwards_compared={})
        for q40_path in ("int8", "f32"):
            q40.CPU_DEQUANT_DTYPE = torch.bfloat16 if q40_path == "f32" else torch.float32
            try:
                gpu = InferenceEngine(path, dtype="q40", device="cuda", q40_path=q40_path)
                cpu = InferenceEngine(path, dtype="q40", device="cpu", q40_path=q40_path)
                n, worst = 0, 0.0
                for prompt in prompts:
                    gpu.reset(), cpu.reset()
                    feed = None
                    for step in range(steps):
                        routes = []
                        for eng in (gpu, cpu):
                            with RouteRecorder(moe) as rec:
                                rec.rows = len(prompt) if feed is None else 1
                                logits = eng.prefill(prompt) if feed is None else eng.decode_step(feed)
                            routes.append((rec, logits))
                        (rg, a), (rc, b) = routes
                        check(len(rg.ids) == len(rc.ids) == spec.n_layers, f"{arch}: router calls {len(rg.ids)}")
                        check(bool(np.isfinite(a).all()) and a.shape == b.shape == (512,), f"small {arch}: logits")
                        for l, (ig, ic) in enumerate(zip(rg.ids, rc.ids)):
                            for r in (ig != ic).any(dim=-1).nonzero().flatten().tolist():
                                fail(f"small {arch} {q40_path} step {step} layer {l} row {r}: card experts "
                                     f"{ig[r].tolist()} vs CPU {ic[r].tolist()} at a CPU margin "
                                     f"{float(rc.margins[l][r]):.3e}")
                        res["min_routing_margin"] = min(res["min_routing_margin"], rc.margin)
                        check(rc.margin > ROUTE_MARGIN, f"small {arch}: routing margin {rc.margin:.3e}")
                        err, tol = float(abs(a - b).max()), 0.05 * float(abs(b).max())
                        worst = max(worst, err / float(abs(b).max()))
                        check(err <= tol, f"small {arch} {q40_path} step {step}: card vs CPU logits {err} > {tol}")
                        n += 1
                        feed = int(b.argmax())
            finally:
                q40.CPU_DEQUANT_DTYPE = torch.float32
            check(n == len(prompts) * steps, f"small {arch} {q40_path}: {n} forwards compared")
            res["forwards_compared"][q40_path], res["max_rel_logit_diff"][q40_path] = n, worst
            del gpu, cpu
        print(f"small {arch} (8 experts, 2 active): every forward (2 prompts x 5 on each Q40 path) with card == "
              f"CPU expert ids on every layer, smallest routing margin {res['min_routing_margin']:.3e}, logits "
              f"within {res['max_rel_logit_diff']['int8']:.2e} (int8) / {res['max_rel_logit_diff']['f32']:.2e} "
              f"(f32, CPU in bf16) of max |logit| (<= 5%)")
        out[arch] = res
    return out


def moe_per_token_bound(cfg) -> tuple[float, float]:
    """The least device ms of one decoded token's Q40 matmuls on a MoE
    model (K1's bound of qkv, wo and the k selected experts' gate_up and
    down in every layer, and wcls, at T = 1), and the Q40 weight bytes that
    token reads at the file's 18 bytes per 32 weights."""
    from distributed_llama_tpu_torch.ops import q40

    def bound(n, d):
        return k1_bound(q40._n_padded(n), d, 1)[0]

    kv = cfg.n_kv_heads * cfg.head_size
    layer = bound(cfg.dim, cfg.dim + 2 * kv) + bound(cfg.dim, cfg.dim) + cfg.n_active_experts * (
        bound(cfg.dim, 2 * cfg.hidden_dim) + bound(cfg.hidden_dim, cfg.dim))
    weights = cfg.n_layers * (cfg.dim * (2 * cfg.dim + 2 * kv)
                              + 3 * cfg.n_active_experts * cfg.dim * cfg.hidden_dim) + cfg.dim * cfg.vocab_size
    return cfg.n_layers * layer + bound(cfg.dim, cfg.vocab_size), weights * 18 / 32


def moe_cli(cli, moe, q40, model: str, tok: str, runs: list, capacity_prompt: str | None = None) -> dict:
    """Phases 8b and 8d: the CLI ``generate`` (``--dtype q40 --decode
    device``) over a MoE model at full width. ``runs`` = (label, q40 path,
    extra arguments). Every run's kernel launches are held to (2 + 2E)·L + 1
    for its prefill (every expert, several rows) plus (2 + 2k)·L + 1 per
    decode step (the k selected experts), its expert-id host reads to L per
    decode step; streams of one seed must be equal, a ``--spec-draft``
    run prints its MoE warning and equals plain greedy, and a
    ``capacity_prompt`` run (``--moe-capacity 2.0``, its own engine) takes
    the bucketed prefill. Then ms/token, device-busy ms/token and host
    reads per token, against the per-token bound."""
    def args(*extra):
        return cli.build_parser().parse_args([
            "inference", "--model", model, "--tokenizer", tok, "--dtype", "q40", "--decode", "device",
            "--max-seq-len", str(SEQ_LEN), "--steps", "40", "--decode-chunk", "8", *extra])

    t_load = time.perf_counter()
    built = cli.make_engine(args("--prompt", "hello", "--temperature", "0"))
    engine = built[0]
    torch.cuda.synchronize()
    cfg = engine.cfg
    L, E, k = cfg.n_layers, cfg.n_experts, cfg.n_active_experts
    per_prefill, per_decode = (2 + 2 * E) * L + 1, (2 + 2 * k) * L + 1
    out: dict = {"load_s": time.perf_counter() - t_load, "card_gb": torch.cuda.memory_allocated() / 1e9,
                 "launches_per_prefill": per_prefill, "launches_per_decode_step": per_decode}
    print(f"engine load + repack: {out['load_s']:.1f} s, {out['card_gb']:.2f} GB on the card; {E} experts, {k} "
          f"active, {L} layers: {per_prefill} Q40 launches per prefill, {per_decode} per decode step")

    def drive(label, path, extra, eng_built):
        eng = eng_built[0]
        eng.reset()
        stream = eng.default_stream
        f0, l0, h0 = stream.forwards, dict(q40.launches), moe.host_reads["expert_ids"]
        res = cli.generate(args("--q40-path", path, *extra), benchmark=False, built=eng_built)
        torch.cuda.synchronize()
        forwards = stream.forwards - f0
        kernel = "q40_int8" if path == "int8" else "q40_dequant"
        d = {n: q40.launches[n] - l0[n] for n in q40.launches}
        reads = moe.host_reads["expert_ids"] - h0
        want = per_prefill + (forwards - 1) * per_decode
        print(f"{label}: {len(res['tokens'])} tokens, {forwards} forwards, launches {d} (expected {kernel} "
              f"{want}), expert-id host reads {reads} ({L} per decode step)")
        check(len(res["tokens"]) > 0 and all(0 <= t < cfg.vocab_size for t in res["tokens"]), f"{label}: tokens")
        check(d[kernel] == want and sum(d.values()) == want, f"{label}: launch count {d} != {want}")
        check(reads == L * (forwards - 1), f"{label}: {reads} expert-id host reads, expected {L * (forwards - 1)}")
        return res["tokens"]

    streams = {}
    q40.reset_launches()  # this path's counts start here
    moe.reset_host_reads()
    for label, path, extra in runs:
        spec_run = "--spec-draft" in extra
        engine._spec_fallback_warned = False
        streams[label] = drive(label, path, extra, built)
        if spec_run:
            check(engine._spec_fallback_warned, f"{label}: the MoE --spec-draft warning was not printed")
    for label in streams:
        if label.endswith(" again"):
            check(streams[label] == streams[label[: -len(" again")]], f"{label}: streams differ for one seed")
        if "spec" in label:
            check(streams[label] == streams["greedy"], f"{label}: differs from plain greedy")
    out.update(streams=streams, launches=dict(q40.launches), tile_launches=dict(q40.tile_launches))
    if capacity_prompt is not None:
        cap_built = cli.make_engine(args("--prompt", capacity_prompt, "--temperature", "0",
                                         "--moe-capacity", "2.0"))
        n_prompt = len(cap_built[1].encode(capacity_prompt, add_bos=True))
        check(n_prompt >= moe.MOE_BUCKETED_MIN_T, f"the capacity prompt has {n_prompt} tokens")
        bucketed = []
        orig = moe._route_buckets
        moe._route_buckets = lambda *a, **kw: bucketed.append(a[1].shape[0]) or orig(*a, **kw)
        try:
            cap = drive("greedy --moe-capacity 2.0", "int8", ["--prompt", capacity_prompt, "--temperature", "0",
                                                               "--seed", "1", "--steps", "160"], cap_built)
        finally:
            moe._route_buckets = orig
        check(len(bucketed) == L, f"the bucketed prefill ran {len(bucketed)} times, expected {L}")
        exact = drive("greedy exact, same prompt", "int8", ["--prompt", capacity_prompt, "--temperature", "0",
                                                             "--seed", "1", "--steps", "160"], built)
        same = next((i for i, (a, b) in enumerate(zip(cap, exact)) if a != b), min(len(cap), len(exact)))
        C = moe.bucket_capacity(2.0, bucketed[0], k, E)
        print(f"--moe-capacity 2.0: a {n_prompt}-token prompt padded to {bucketed[0]} rows, {C} rows per expert "
              f"bucket in every layer; {same} of {min(len(cap), len(exact))} greedy tokens equal the exact path's "
              f"before the first divergence")
        out.update(capacity_prompt_tokens=n_prompt, capacity_tokens_equal_exact=same)
        del cap_built
        gc.collect()
    launches, tiles = dict(q40.launches), dict(q40.tile_launches)
    check(all(v > 0 for v in launches.values()) and all(v > 0 for v in tiles.values()),
          f"a kernel of the MoE path was not launched: {launches} {tiles}")
    out.update(launches=launches, tile_launches=tiles, host_reads=moe.host_reads["expert_ids"])

    # timings of the same engine, fenced by synchronize
    bound_ms, weight_bytes = moe_per_token_bound(cfg)
    out.update(bound_ms_per_token=bound_ms, q40_weight_bytes_per_token=weight_bytes)
    for path in ("int8", "f32"):
        engine.q40_path = path
        prompt = built[1].encode("hello world " * 10, add_bos=True)[:64]
        for _ in range(2):  # the second round is the measured one
            engine.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = engine.prefill(prompt)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            check(bool(np.isfinite(logits).all()), "non-finite prefill logits")
            first = int(logits.argmax())
            h0 = moe.host_reads["expert_ids"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = engine.decode_chunk(first, 32, 0.0, 0.9)
            decode_ms = (time.perf_counter() - t0) * 1e3 / 32
            reads = (moe.host_reads["expert_ids"] - h0) / 32
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks), "decode chunk tokens")
        row = dict(prompt_tokens=len(prompt), prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
                   host_reads_per_token=reads)
        print(f"{path} path: prefill {len(prompt)} tokens {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms/token over "
              f"32 greedy tokens, {reads:.0f} expert-id host reads per token; bound {bound_ms:.3f} ms/token "
              f"(Q40 weights {weight_bytes / 1e9:.3f} GB a token at 18 B per 32)")
        row.update(device_profile(engine, first, decode_ms))
        out[f"timing_{path}"] = row
    engine.q40_path = "int8"
    out["wall_s"] = time.perf_counter() - t_load
    del engine, built
    gc.collect()
    torch.cuda.empty_cache()
    return out


def single_stream_divergence(state, captured: list, n: int = 8) -> list:
    """Phase 8c: every greedy completion's first ``n`` tokens against the
    engine's single-stream decode (what the CLI runs) of the same prompt.
    A 4-row batched step takes the all-experts path and a single stream
    the top-k path, which add the experts in another order, so a row may
    part from the single stream where two logits nearly tie: the first
    divergence is reported, not failed."""
    engine = state.engine
    out = []
    for prompt, temperature, seed, ids in captured:
        if temperature != 0.0:
            continue
        stream = engine.default_stream
        stream.reset()
        first = stream.prefill_device(prompt, 0.0, 0.9, seed)
        got = []
        stream.stream_decode(first, lambda p, t: got.append(t) or len(got) < n, 0.0, 0.9, seed=seed,
                             limit=stream.pos + n, first_prev=prompt[-1])
        want = ids[:n]
        same = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        out.append(dict(prompt_tokens=len(prompt), equal_before_divergence=same, compared=min(len(got), len(want))))
        print(f"  greedy completion ({len(prompt)}-token prompt): {same} of {min(len(got), len(want))} tokens equal "
              f"the single-stream decode before the first divergence")
    engine.reset()
    return out


def _post(url: str, body: dict):
    """POST a completion; returns (status, seconds to the first SSE event or
    the JSON body, total seconds, the JSON body or the SSE events)."""
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            payload = json.loads(r.read())
            t = time.perf_counter() - t0
            return r.status, t, t, payload
        events, first = [], None
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if first is None:
                first = time.perf_counter() - t0
            if line[6:] != "[DONE]":
                events.append(json.loads(line[6:]))
        return r.status, first, time.perf_counter() - t0, events


def _capture_streams(state, captured: list, tag=None) -> None:
    """Record each completion's decoded token ids: every lane's
    ``stream_decode`` is wrapped so that (prompt tokens, temperature, seed,
    ids) is appended to ``captured`` when the request's decode ends, with
    ``tag`` as a fifth element when one is given (11c, 12: the replica).
    Integrity probes (no ``prompt_tokens``) pass through unrecorded."""
    lock = threading.Lock()
    for slot in state.slots:
        orig = slot.stream.stream_decode

        def wrapped(first, on_token, temperature=0.0, *a, _orig=orig, **kw):
            if "prompt_tokens" not in kw:  # an integrity probe, not a request
                return _orig(first, on_token, temperature, *a, **kw)
            ids = []

            def rec(prev, t):
                ids.append(t)
                return on_token(prev, t)

            try:
                return _orig(first, rec, temperature, *a, **kw)
            finally:
                run = (list(kw["prompt_tokens"]), float(temperature), kw["seed"], ids)
                with lock:
                    captured.append(run if tag is None else run + (tag,))

        slot.stream.stream_decode = wrapped


def _reference_streams(server_api, state, args, captured: list) -> int:
    """Phase 6c's correctness check: replay every greedy completion, in the
    order the server finished them, through a second BatchScheduler on the
    same engine and cache dtype with spec_draft 0 (the same prefix-cache
    hits, so the same prefill pieces) and compare token ids. Returns the
    number of tokens compared; a mismatch fails with its first diverging
    position."""
    # no watchdog: its thread would hold the reference scheduler's slab and
    # pool past this function
    ref_args = argparse.Namespace(**{**vars(args), "spec_draft": 0, "stall_timeout_s": 0})
    ref = server_api.ApiState(state.engine, state.tokenizer, state.slots[0].sampler, ref_args).batch
    check(ref is not None and ref.spec_draft == 0 and ref._prefix is not None, "reference scheduler")
    lane = ref._streams[0]
    n = 0
    for prompt, temperature, seed, ids in captured:
        if temperature != 0.0:
            continue
        lane.reset()
        first = lane.prefill_device(prompt, 0.0, 0.9, seed)
        got = []

        def on_token(prev, t):
            got.append(t)
            return len(got) < len(ids)

        lane.stream_decode(first, on_token, 0.0, 0.9, seed=seed, limit=lane.pos + len(ids), first_prev=prompt[-1])
        if got != ids:
            at = next((i for i, (x, y) in enumerate(zip(got, ids)) if x != y), min(len(got), len(ids)))
            fail(f"speculative stream differs from the spec_draft=0 stream at position {at} of "
                 f"{len(ids)}: {ids[max(0, at - 2):at + 3]} vs {got[max(0, at - 2):at + 3]} "
                 f"({len(prompt)}-token prompt, prefix hit {lane.matched_len} positions)")
        n += len(ids)
    lane.reset()
    return n


def decode_rows(sched, n_rows: int, n_tok: int = 32) -> tuple[float, int, int]:
    """Aggregate decode straight through the scheduler's first ``n_rows``
    lanes, one thread each, from position 4 (speculative when the scheduler
    is): (wall seconds, tokens, batched steps)."""
    lanes = sched._streams[:n_rows]
    firsts = []
    for r, lane in enumerate(lanes):
        lane.reset()
        firsts.append(lane.prefill_device([1, 300 + r, 17, 42], 0.0, 0.9, 1))
    torch.cuda.synchronize()

    def go(lane, first, r):
        lane.stream_decode(first, lambda p, t: True, 0.0, 0.9, seed=1, limit=lane.pos + n_tok,
                           first_prev=42, spec_draft=sched.spec_draft, prompt_tokens=[1, 300 + r, 17, 42])

    ts = [threading.Thread(target=go, args=(lane, first, r)) for r, (lane, first) in enumerate(zip(lanes, firsts))]
    f1 = sched.decode_forwards
    t = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    torch.cuda.synchronize()
    return time.perf_counter() - t, n_rows * n_tok, sched.decode_forwards - f1


def server_run(server_api, attn, kvc, llama, model: str, tok_path: str, q40, extra=(), spec: bool = False,
               single_stream: bool = False) -> dict:
    """Phase 6b (bf16 cache) and 6c (``extra`` = the int8 cache and
    speculative decoding, ``spec`` True): the port's API server over the
    7B-width model, batched (--parallel 4) with the prefix cache on; phase
    8c over the Mixtral-width model, with ``single_stream`` (each greedy
    completion against the single-stream decode of its prompt)."""
    from distributed_llama_tpu_torch.tokenizer import ChatItem

    args = server_api.build_parser().parse_args([
        "generate", "--model", model, "--tokenizer", tok_path, "--dtype", "q40", "--max-seq-len",
        str(SERVER_SEQ_LEN), "--parallel", "4", "--decode-chunk", "8", "--chat-template", "chatml",
        "--host", "127.0.0.1", "--port", "0", "--temperature", "0", *extra])
    t0 = time.perf_counter()
    server, state = server_api.make_server(args)
    sched = state.batch
    check(sched is not None and sched._prefix is not None, "the server did not build a paged BatchScheduler")
    engine = state.engine
    cfg = engine.cfg
    n_layers = cfg.n_layers
    i8 = kvc.is_quantized_cache_dtype(engine.cache_dtype)
    kernel = "paged_attention_i8" if i8 else "paged_attention"
    print(f"server up in {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
          f"the card, {sched._prefix.capacity} pool pages of {sched._prefix.page}, cache {engine.cache_dtype}, "
          f"spec draft {sched.spec_draft}")
    out: dict = {"cache_dtype": str(engine.cache_dtype), "spec_draft": sched.spec_draft}
    # the KV memory of the slab and pool, beside what bf16 halves would take
    slab_bytes = sum(kvc.half_bytes(leaf) for leaf in sched._slab)
    pool_bytes = sum(kvc.half_bytes(h) for pair in sched._pool for h in pair)
    bf16_slab = 2 * n_layers * sched.b_max * cfg.seq_len * cfg.n_kv_heads * cfg.head_size * 2
    bf16_pool = sched._prefix.capacity * llama.page_pool_bytes(cfg, sched._prefix.page, torch.bfloat16)
    check(pool_bytes == sched._prefix.capacity * llama.page_pool_bytes(cfg, sched._prefix.page, engine.cache_dtype),
          "pool bytes differ from page_pool_bytes")
    ratio = (slab_bytes + pool_bytes) / (bf16_slab + bf16_pool)
    print(f"KV memory: slab {slab_bytes / 1e9:.3f} GB + pool {pool_bytes / 1e9:.3f} GB; bf16 halves of the same "
          f"shape: {bf16_slab / 1e9:.3f} + {bf16_pool / 1e9:.3f} GB ({ratio:.4f}x)")
    out.update(slab_bytes=slab_bytes, pool_bytes=pool_bytes, bf16_slab_bytes=bf16_slab, bf16_pool_bytes=bf16_pool)
    captured: list = []
    _capture_streams(state, captured)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def prompt_tokens(system: str, user: str) -> list[int]:
            text = state.template.generate([ChatItem("system", system), ChatItem("user", user)])
            return state.tokenizer.encode(text, add_bos=True)

        system = "You are a helpful assistant. "
        while len(prompt_tokens(system, "hello")) < 600:
            system += "hello world, "
        n_prompt = len(prompt_tokens(system, "hello"))

        def body(user, stream, temperature=0.0, seed=1):
            return {"messages": [{"role": "system", "content": system}, {"role": "user", "content": user}],
                    "max_tokens": 24, "stream": stream, "temperature": temperature, "seed": seed}

        attn.reset_launches()  # the main path's counts start here
        q40.reset_launches()
        f0 = sched.decode_forwards
        s0 = (sched.spec_row_steps, sched.spec_drafted, sched.spec_emitted)
        status, ttft_cold, total_cold, events = _post(url, body("hello", True))
        check(status == 200 and events, "cold request failed")
        print(f"cold request: {n_prompt} prompt tokens, TTFT {ttft_cold * 1e3:.1f} ms, total {total_cold:.2f} s")
        results: dict = {}
        variants = {"greedy SSE": body("hello world", True), "sampled SSE": body("world", True, 0.8, 5),
                    "greedy JSON": body("world hello", False), "sampled JSON": body("hello hello", False, 0.8, 9)}

        def run(name):
            results[name] = _post(url, variants[name])

        threads = [threading.Thread(target=run, args=(n,)) for n in variants]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall4 = time.perf_counter() - t1
        for name, (status, ttft, total, payload) in results.items():
            if isinstance(payload, dict):
                n_out = payload["usage"]["completion_tokens"]
                check(payload["usage"]["prompt_tokens"] > 500, f"{name}: prompt tokens {payload['usage']}")
            else:
                n_out = len(payload)
            check(status == 200 and n_out > 0, f"{name}: status {status}, {n_out} outputs")
            print(f"  {name}: 200, {n_out} {'tokens' if isinstance(payload, dict) else 'SSE events'}, "
                  f"first response {ttft * 1e3:.1f} ms, total {total:.2f} s")
        n_out_4 = sum(len(ids) for _, _, _, ids in captured[1:])
        status, ttft_hit, total_hit, events = _post(url, body("hello", True, seed=2))
        check(status == 200 and events, "lone hit request failed")
        launches = attn.launches[kernel]
        others = {k: v for k, v in attn.launches.items() if k != kernel and v}
        forwards = sched.decode_forwards - f0
        tiles = dict(q40.tile_launches)
        out["k1_tile_launches"] = tiles
        print(f"K1 launches by tile {tiles}")
        if spec:  # every verify forward (5 rows or more) runs K1's tensor-core tile
            check(tiles["mma"] >= (4 * n_layers + 1) * forwards, f"K1's tensor-core tile on the verify path: {tiles}")
        print(f"K2 ({kernel}) launches {launches} = {n_layers} layers x {forwards} batched forwards; other K2 "
              f"launches {others or 0}; prefix hits {sched._prefix.hits}, misses {sched._prefix.misses}; lone hit "
              f"TTFT {ttft_hit * 1e3:.1f} ms vs cold {ttft_cold * 1e3:.1f} ms")
        check(launches == n_layers * forwards and forwards > 0, "K2 launches != n_layers x batched forwards")
        check(not others, f"the server launched another form of K2: {others}")
        check(sched._prefix.hits >= 5, f"expected prefix hits, got {sched._prefix.hits}")
        sched.check_prefix()
        out.update(prompt_tokens=n_prompt, ttft_cold_ms=ttft_cold * 1e3, ttft_hit_alone_ms=ttft_hit * 1e3,
                   ttft_hit_concurrent_ms={k: v[1] * 1e3 for k, v in results.items() if k.endswith("SSE")},
                   concurrent_wall_s=wall4, concurrent_tokens=n_out_4, concurrent_tok_per_s=n_out_4 / wall4,
                   main_path_launches=launches, batched_forwards=forwards,
                   prefix_hits=sched._prefix.hits, prefix_misses=sched._prefix.misses)
        print(f"4 concurrent requests: {n_out_4} tokens in {wall4:.2f} s = {n_out_4 / wall4:.2f} tok/s "
              f"(prefill included)")
        if spec:
            steps, drafted, emitted = (x - y for x, y in zip(
                (sched.spec_row_steps, sched.spec_drafted, sched.spec_emitted), s0))
            out.update(spec_row_steps=steps, spec_drafted=drafted, spec_accepted=emitted - steps,
                       spec_emitted=emitted, tokens_per_verify_row_step=emitted / max(steps, 1))
            print(f"verify steps: {steps} row-steps, {drafted} drafted, {emitted - steps} accepted, {emitted} "
                  f"emitted = {emitted / max(steps, 1):.3f} tokens per row-step")
            check(steps > 0, "no verify step was delivered")
            n_cmp = _reference_streams(server_api, state, args, captured)
            print(f"greedy speculative streams equal the spec_draft=0 scheduler's: {n_cmp} tokens over "
                  f"{sum(1 for c in captured if c[1] == 0.0)} requests")
            check(n_cmp > 0, "no greedy stream was compared")
            out["greedy_tokens_compared"] = n_cmp

        if single_stream:
            out["single_stream_divergence"] = single_stream_divergence(state, captured)

        # a hit's first-token logits against a cold prefill of the same prompt
        row = sched._streams[0]
        toks = prompt_tokens(system, "hello")
        row.reset()
        row.prefix_cache_enabled = False
        cold = row.prefill(toks)
        row.reset()
        hit = row.prefill(toks)
        check(row.matched_len > 0, "the logit check's second prefill did not hit")
        err, tol = float(np.abs(hit - cold).max()), 0.05 * float(np.abs(cold).max())
        print(f"hit vs cold first-token logits: max diff {err:.4g} (tolerance {tol:.4g}, 5% of max |logit|), "
              f"{row.matched_len} positions from the pool")
        check(np.isfinite(hit).all() and err <= tol, "hit and cold logits disagree")
        row.reset()
        out.update(hit_vs_cold_logit_diff=err, hit_vs_cold_tol=tol)

        # aggregate decode rate straight through the lanes (speculative in 6c)
        for n_rows in (1, 4) if not spec else (4,):
            decode_rows(sched, n_rows, 8)  # warm
            wall, n_tok, steps = decode_rows(sched, n_rows)
            out[f"decode_tok_per_s_{n_rows}_rows"] = n_tok / wall
            out[f"decode_ms_per_step_{n_rows}_rows"] = wall / steps * 1e3
            print(f"aggregate decode at {n_rows} row(s): {n_tok / wall:.2f} tok/s ({wall:.2f} s for {n_tok} tokens, "
                  f"{steps} batched steps, {wall / steps * 1e3:.2f} ms per step)")
        from torch.profiler import ProfilerActivity, profile

        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_p, n_tok, steps = decode_rows(sched, 4)
        t_read = time.perf_counter()
        busy_ms = sum(device_ms_by_name(prof).values())
        # what the profile costs the run: the smoke test's time limit is shared by every phase
        out["profile_s"] = {"window_and_stop": t_read - t_prof, "read_events": time.perf_counter() - t_read}
        print(f"profiler: the window and its stop {t_read - t_prof:.1f} s, reading its events "
              f"{time.perf_counter() - t_read:.1f} s")
        wall_ms = n_tok / out["decode_tok_per_s_4_rows"] * 1e3
        if busy_ms == 0.0:
            print("profiler recorded no device time: device idle share not measured")
        else:
            out["device_busy_ms_per_step_4_rows"] = busy_ms / steps
            out["device_idle_share_4_rows"] = 1 - busy_ms / wall_ms
            print(f"4-row decode: device busy {busy_ms / steps:.2f} ms per batched step, idle "
                  f"{100 * out['device_idle_share_4_rows']:.1f}% of the unprofiled {wall_ms / steps:.2f} ms")
        out["fault_counts"] = no_fault_counts(state, "server run")
    finally:
        server.shutdown()
        server.server_close()
        state.close()
    del state, sched
    return out


def wide_spec_run(server_api, q40, model: str, tok_path: str) -> dict:
    """Phase 6c, second server: ``--parallel 16 --max-seq-len 1000
    --cache-dtype i8 --spec-draft 4``. S = 1000 takes the einsum attention
    (no K2), and 16 concurrent greedy requests put up to 16 rows x 5 = 80
    rows in a verify forward: K1's rows and the 64-row blocks of the bias
    correction and rmsnorm at widths of 64 rows and more. Every greedy
    completion must equal what a spec_draft=0 scheduler on the same engine
    decodes for the same prompt."""
    from distributed_llama_tpu_torch.tokenizer import ChatItem

    args = server_api.build_parser().parse_args([
        "generate", "--model", model, "--tokenizer", tok_path, "--dtype", "q40", "--max-seq-len",
        str(WIDE_SEQ_LEN), "--parallel", str(WIDE_ROWS), "--decode-chunk", "8", "--chat-template", "chatml",
        "--host", "127.0.0.1", "--port", "0", "--temperature", "0", "--cache-dtype", "i8", "--spec-draft", "4"])
    server, state = server_api.make_server(args)
    sched = state.batch
    check(sched is not None and sched.spec_draft == 4 and sched.b_max == WIDE_ROWS, "the 16-row server")
    captured: list = []
    _capture_streams(state, captured)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    out: dict = {}
    try:
        system = "You are a helpful assistant. "
        while len(state.tokenizer.encode(state.template.generate(
                [ChatItem("system", system), ChatItem("user", "hello")]), add_bos=True)) < 600:
            system += "hello world, "

        def body(user):
            return {"messages": [{"role": "system", "content": system}, {"role": "user", "content": user}],
                    "max_tokens": 16, "stream": False, "temperature": 0.0, "seed": 1}

        status, _, _, _ = _post(url, body("hello"))  # publishes the system prompt's pages
        check(status == 200, "the 16-row server's first request failed")
        q40.reset_launches()
        f0, r0 = sched.decode_forwards, sched.spec_row_steps
        results: dict = {}
        users = [" ".join(("hello", "world")[(i >> k) & 1] for k in range(4)) for i in range(WIDE_ROWS)]

        def run(i):
            results[i] = _post(url, body(users[i]))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(WIDE_ROWS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        for i, (status, _, _, payload) in results.items():
            check(status == 200 and payload["usage"]["completion_tokens"] > 0, f"16-row request {i}: {status}")
        tiles = dict(q40.tile_launches)
        print(f"{WIDE_ROWS} concurrent requests in {wall:.2f} s: {sched.decode_forwards - f0} verify forwards, "
              f"{sched.spec_row_steps - r0} row-steps, the widest {sched.spec_rows_max} rows; K1 tiles {tiles}")
        check(sched.spec_rows_max >= 64, f"no verify forward reached 64 rows (widest {sched.spec_rows_max})")
        check(tiles["mma"] > 0, "K1's tensor-core tile was not launched")
        n_cmp = _reference_streams(server_api, state, args, captured)
        print(f"greedy speculative streams at up to {sched.spec_rows_max} rows equal the spec_draft=0 scheduler's: "
              f"{n_cmp} tokens over {len(captured)} requests")
        check(n_cmp > 0, "no greedy stream was compared")
        out.update(rows=WIDE_ROWS, seq_len=WIDE_SEQ_LEN, wall_s=wall, verify_forwards=sched.decode_forwards - f0,
                   widest_verify_rows=sched.spec_rows_max, k1_tile_launches=tiles, greedy_tokens_compared=n_cmp,
                   fault_counts=no_fault_counts(state, "6c's 16-row server"))
    finally:
        server.shutdown()
        server.server_close()
        state.close()
    del state, sched
    return out


def _scrape(url: str) -> dict:
    from distributed_llama_tpu_torch.loadgen.report import parse_prometheus

    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return parse_prometheus(r.read().decode())


def _get_json(url: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def loadgen_phase(server_api, attn, q40, model: str, tok_path: str, smi: str) -> dict:
    """Phase 9: the port's server over the 7B-width model with --telemetry,
    --parallel 4, the prefix cache on, driven by the port's load generator
    through its --url path (see the module docstring)."""
    import contextlib
    import io

    from distributed_llama_tpu_torch import telemetry
    from distributed_llama_tpu_torch.loadgen import __main__ as loadgen_cli
    from distributed_llama_tpu_torch.loadgen import runner as lg_runner

    args = server_api.build_parser().parse_args([
        "generate", "--model", model, "--tokenizer", tok_path, "--dtype", "q40", "--max-seq-len",
        str(SERVER_SEQ_LEN), "--parallel", "4", "--decode-chunk", "8", "--chat-template", "chatml",
        "--host", "127.0.0.1", "--port", "0", "--temperature", "0", "--admission-queue", str(LOADGEN_REQUESTS),
        "--telemetry"])
    telemetry.reset()
    telemetry.enable()  # serve()'s order: before the engine and server bind their instruments
    t0 = time.perf_counter()
    server, state = server_api.make_server(args)
    sched = state.batch
    check(sched is not None and sched._prefix is not None, "the server did not build a paged BatchScheduler")
    check(state.traces is not None and sched.engine._tel.enabled, "telemetry is not bound on the server")
    print(f"server up in {time.perf_counter() - t0:.1f} s with --telemetry, {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB on the card")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    report_path = ROOT / "build" / "chip_smoke_loadgen_report.json"
    out: dict = {"card": smi}
    try:
        def argv(prefix_chars: int) -> list[str]:
            return ["--url", url, "--requests", str(LOADGEN_REQUESTS), "--rate", str(LOADGEN_RATE), "--seed", "0",
                    "--prefixes", "4", "--zipf-s", "1.1", "--prefix-chars", str(prefix_chars), "--suffixes", "6",
                    "--tenants", f"default:max_tokens={LOADGEN_MAX_TOKENS}", "--temperature", "0.8", "--topp", "0.9",
                    "--sampled-share", "0.5", "--warmup", "0", "--timeout-s", "300", "--assert",
                    "--expect-zero", "dllama_host_sampler_fallback_total", "--out", str(report_path)]

        def schedule_of(prefix_chars: int):
            return loadgen_cli.build(loadgen_cli.build_parser().parse_args(argv(prefix_chars)))[1]

        # size the shared prefixes to ~LOADGEN_PREFIX_TOKENS tokens each
        chars = LOADGEN_PREFIX_TOKENS
        for _ in range(3):
            sysp = schedule_of(chars)[0].body["messages"][0]["content"]
            chars = max(1, round(chars * LOADGEN_PREFIX_TOKENS / len(state.tokenizer.encode(sysp, add_bos=False))))
        schedule = schedule_of(chars)
        prefix_tokens = sorted({len(state.tokenizer.encode(r.body["messages"][0]["content"], add_bos=False))
                                for r in schedule})
        n_sampled = sum(r.body["temperature"] > 0 for r in schedule)
        print(f"schedule: {len(schedule)} requests, Poisson {LOADGEN_RATE} rps, --prefix-chars {chars} "
              f"({prefix_tokens} tokens per prefix), {len({r.prefix_id for r in schedule})} prefixes used, "
              f"{n_sampled} sampled / {len(schedule) - n_sampled} greedy, max_tokens {LOADGEN_MAX_TOKENS}")
        check(0 < n_sampled < len(schedule), "the schedule does not mix greedy and sampled requests")
        warmed = lg_runner.warm_server(url, schedule, n=2, timeout_s=300.0)
        check(warmed == 2, f"warmup: {warmed} of 2 requests completed")

        # the measured window: counts from 0 just before, read just after
        captured: list = []
        _capture_streams(state, captured)
        attn.reset_launches()
        q40.reset_launches()
        telemetry.TRACER.clear()
        before = _scrape(url)
        admissions0 = sched._prefix.hits + sched._prefix.misses
        delivered0 = sched.tokens_delivered
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the report JSON and the request log
            code = loadgen_cli.main(argv(chars))
        wall = time.perf_counter() - t1
        after = loadgen_cli.settled_scrape(url)
        launches = {"q40_int8": q40.launches["q40_int8"], "k1_tiles": dict(q40.tile_launches),
                    "paged_attention": attn.launches["paged_attention"]}
        report = json.loads(report_path.read_text())
        out.update(report=report, wall_s=wall, prefix_chars=chars, prefix_tokens=prefix_tokens, launches=launches)
        agg = report["aggregate"]
        print(f"loadgen exit {code} in {wall:.1f} s: {agg['counts']}; checks "
              f"{ {k: v['ok'] for k, v in report['checks'].items()} }")
        check(code == 0, f"loadgen --assert failed: {report['checks']}")
        check(agg["counts"]["completed"] == LOADGEN_REQUESTS, f"not every request completed: {agg['counts']}")

        def delta(series: str) -> float:
            return after.get(series, 0.0) - before.get(series, 0.0)

        chat200 = delta('dllama_http_requests_total{route="/v1/chat/completions",status="200"}')
        ttft_n = delta('dllama_ttft_seconds_count{tenant="default"}')
        hits, misses = delta("dllama_prefix_cache_hits_total"), delta("dllama_prefix_cache_misses_total")
        admissions = sched._prefix.hits + sched._prefix.misses - admissions0
        generated = delta("dllama_tokens_generated_total")
        delivered = sched.tokens_delivered - delivered0
        consumed = sum(len(ids) for *_, ids in captured)
        print(f"deltas: chat 200s {chat200:g}, TTFT count {ttft_n:g}, prefix hits {hits:g} + misses {misses:g} "
              f"(admissions counted by the scheduler {admissions}), tokens generated {generated:g} = delivered to "
              f"rows {delivered} + {LOADGEN_REQUESTS} first tokens; the requests consumed {consumed} of them "
              f"(the client streamed {agg['tokens_streamed']} deltas), host-sampler fallback "
              f"{delta('dllama_host_sampler_fallback_total'):g}")
        check(chat200 == LOADGEN_REQUESTS, f"chat 200s {chat200} != {LOADGEN_REQUESTS}")
        check(ttft_n == LOADGEN_REQUESTS, f"TTFT observations {ttft_n} != {LOADGEN_REQUESTS}")
        check(hits + misses == admissions == LOADGEN_REQUESTS, f"prefix hits + misses {hits + misses} != admissions "
              f"{admissions} != {LOADGEN_REQUESTS}")
        check(generated == delivered + LOADGEN_REQUESTS, f"tokens generated {generated} != delivered {delivered} "
              f"+ {LOADGEN_REQUESTS} first tokens")
        check(len(captured) == LOADGEN_REQUESTS and consumed <= generated,
              f"{len(captured)} decodes consumed {consumed} tokens of {generated} generated")
        check(delta("dllama_host_sampler_fallback_total") == 0, "the host sampler ran")
        skew = report["client_vs_server_skew"]["default"]
        print(f"client vs server: client E2E {skew['client_e2e_s']} s, server-attributed {skew['server_attributed_s']} "
              f"s, skew {skew['skew_per_request_ms']} ms per request (bound {SKEW_BOUND_MS} ms)")
        check(-1.0 <= skew["skew_per_request_ms"] <= SKEW_BOUND_MS, f"client/server skew {skew}")

        paths = {}
        for k, v in after.items():
            if k.startswith("dllama_kernel_path_total{"):
                labels = dict(p.split("=") for p in k[len("dllama_kernel_path_total{"):-1].split(","))
                paths[f"{labels['kernel'].strip(chr(34))}/{labels['path'].strip(chr(34))}"] = v
        print(f"kernel paths since the server started (warmup included): {paths}; launches in the window: {launches}")
        out["kernel_paths"] = paths
        check(paths and all(p in ("q40_matmul/k1_dp4a", "q40_matmul/k1_mma", "paged_attention/k2") for p in paths),
              f"a path other than K1's tiles and K2 served: {paths}")
        check(launches["q40_int8"] > 0 and launches["paged_attention"] > 0, f"K1 or K2 was not launched: {launches}")

        # one request's trace, through the debug endpoint
        rid = state.traces._done[-1].request_id
        status, tree = _get_json(f"{url}/debug/trace/{rid}")
        status_c, chrome = _get_json(f"{url}/debug/trace/{rid}?format=chrome")
        spans = sorted({sp["name"] for a in tree.get("attempts", []) for sp in a["spans"]})
        print(f"/debug/trace/{rid}: {status}, stages {tree.get('stages')}, spans {spans}; chrome {status_c}, "
              f"{len(chrome.get('traceEvents', []))} events")
        check(status == 200 and status_c == 200 and {"queue", "prefill", "decode"} <= set(tree["stages"]),
              f"trace of {rid}: {status} {tree}")
        for probe in ("/healthz", "/readyz"):
            code_p, body = _get_json(url + probe)
            print(f"{probe}: {code_p} {body}")
            check(code_p == 200, f"{probe} returned {code_p}")

        # latency and where it went ({smi} beside every number)
        for name in ("ttft_ms", "tpot_ms", "e2e_ms"):
            q = agg[name]
            print(f"client {name[:-3].upper()}: p50 {q['p50']} ms, p90 {q['p90']} ms, p99 {q['p99']} ms, "
                  f"mean {q['mean']} ms over {q['n']} ({smi})")
        stages = {}
        for stage in ("queue", "placement", "prefill", "decode"):
            key = f'{{stage="{stage}",tenant="default"}}'
            n = delta(f"dllama_request_stage_seconds_count{key}")
            tot = delta(f"dllama_request_stage_seconds_sum{key}")
            stages[stage] = {"n": n, "sum_s": tot, "mean_ms": tot / n * 1e3 if n else None}
        out["stages"] = stages
        print("server stages per request (mean ms): " + ", ".join(
            f"{k} {v['mean_ms']:.1f}" for k, v in stages.items() if v["mean_ms"] is not None) + f" ({smi})")
        # the prefill stage of an admission that missed the prefix cache
        # (the cold TTFT's work) against one that hit, from the kept traces
        prefill_by: dict = {"miss": [], "hit": []}
        for ctx in list(state.traces._done):
            tree_ = ctx.tree()
            match = [sp for a in tree_["attempts"] for sp in a["spans"] if sp["name"] == "prefix_match"]
            if match and "prefill" in tree_["stages"]:
                prefill_by["hit" if match[0]["args"]["matched_tokens"] else "miss"].append(
                    tree_["stages"]["prefill"] * 1e3)
        out["prefill_stage_ms"] = prefill_by
        print("prefill stage per admission: " + ", ".join(
            f"{k} {sum(v) / len(v):.1f} ms mean over {len(v)}" for k, v in prefill_by.items() if v) + f" ({smi})")
        spans_by = {}
        for ev in telemetry.TRACER.events():
            spans_by.setdefault(ev.name, []).append(ev.dur_us / 1e3)
        host = {k: {"n": len(v), "sum_ms": sum(v), "mean_ms": sum(v) / len(v)} for k, v in sorted(spans_by.items())}
        out["spans"] = host
        for a_, b_ in (("batch_decode_chunk", "batch_decode_fetch"), ("prefill_dispatch", "first_token_fetch")):
            if a_ in host and b_ in host:
                print(f"{a_} (host issue) {host[a_]['mean_ms']:.2f} ms x {host[a_]['n']} = {host[a_]['sum_ms']:.0f} ms "
                      f"against {b_} (wait for the card) {host[b_]['mean_ms']:.2f} ms x {host[b_]['n']} = "
                      f"{host[b_]['sum_ms']:.0f} ms ({smi})")
        check("batch_decode_chunk" in host and "batch_decode_fetch" in host, f"no dispatch/fetch spans: {list(host)}")

        # the 4-row step with telemetry on: a reading (phase 6b's is off, at
        # MAIN_LAYERS layers)
        decode_rows(sched, 4, 8)  # warm
        wall4, _, steps = decode_rows(sched, 4)
        out["decode_ms_per_step_4_rows_telemetry_on"] = on_ms = wall4 / steps * 1e3
        print(f"4-row decode step: {on_ms:.2f} ms with telemetry on at {sched.engine.cfg.n_layers} layers ({smi}; "
              "host time spreads between calls)")
        out["fault_counts"] = no_fault_counts(state, "phase 9")
        series = {k: v for k, v in _scrape(url).items() if k.startswith((
            "dllama_batch_retries_total", "dllama_rows_quarantined_total", "dllama_watchdog_stalls_total",
            "dllama_deadline_exceeded_total"))}
        check(not any(series.values()), f"phase 9: a fault series moved: {series}")
    finally:
        server.shutdown()
        server.server_close()
        state.close()
        telemetry.disable()
        telemetry.reset()
    del state, sched
    return out


def loadgen_only(smi: str) -> None:
    """``--loadgen``: phase 2, phase 5's 7B-width files and phase 9 alone."""
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.ops import attention as attn
    from distributed_llama_tpu_torch.ops import cuda_build, q40
    from distributed_llama_tpu_torch.server import api as server_api

    phase("2. build kernels")
    print(f"nvcc build: {cuda_build.build():.1f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        model, tok = write_7b_files(synthetic, write_tokenizer_file, Path(tmp))
        print(f"wrote the 7B-width files in {time.perf_counter() - t:.1f} s")
        t = phase(f"9. the slice's path: the load generator against the API server with --telemetry, {N_LAYERS} layers")
        summary = {"loadgen": loadgen_phase(server_api, attn, q40, model, tok, smi)}
        print(f"phase 9: {time.perf_counter() - t:.1f} s")
    (ROOT / "build" / "chip_smoke_loadgen.json").write_text(json.dumps(summary, indent=1))
    print(f"card: {smi}")


def no_fault_counts(state, label: str) -> dict:
    """A fault-free phase moved no retry, quarantine, watchdog or deadline
    count (the scheduler's and the server's plain counts, which the
    registry's series mirror)."""
    sched = state.batch
    counts = {"retries": sched.retries_total, "quarantined": sched.quarantined_total,
              "stalls": sched.stalls_total, "deadlines": state.deadline_exceeded_total}
    check(not any(counts.values()), f"{label}: a fault-free phase moved a fault count: {counts}")
    return counts


def _post_any(url: str, body: dict, t_start: float | None = None) -> dict:
    """POST a completion and return its status, its JSON body or SSE events,
    and its seconds to the first event and to the end (from ``t_start``,
    default the call)."""
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter() if t_start is None else t_start
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, raw_first, events = r.status, None, []
            if body.get("stream"):
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        if raw_first is None:
                            raw_first = time.perf_counter() - t0
                        if line[6:] != "[DONE]":
                            events.append(json.loads(line[6:]))
                payload = events
            else:
                payload = json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, raw_first, payload = e.code, None, json.loads(e.read())
    return {"status": status, "payload": payload, "first_s": raw_first, "end_s": time.perf_counter() - t0}


def _concurrent(url: str, bodies: list) -> list:
    """POST every body at once; their results in order."""
    out: list = [None] * len(bodies)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, _post_any(url, bodies[i], t0)))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _record_matched(state) -> dict:
    """seed -> the positions each of its decodes read from the pool (its
    row's matched length when the decode starts), over every lane."""
    seen: dict = {}
    for slot in state.slots:
        orig, stream = slot.stream.stream_decode, slot.stream

        def wrapped(*a, _orig=orig, _s=stream, **kw):
            seen.setdefault(kw["seed"], []).append(_s.matched_len)
            return _orig(*a, **kw)

        slot.stream.stream_decode = wrapped
    return seen


def _open_sse(url: str, body: dict):
    """An SSE completion whose events are read as they come."""
    import http.client
    import urllib.parse

    p = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(p.hostname, p.port, timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200, f"SSE request: {resp.status}")
    return conn, resp


def _sse_events(resp):
    for raw in resp:
        line = raw.strip()
        if line.startswith(b"data: "):
            if line[6:] == b"[DONE]":
                return
            yield json.loads(line[6:])


def _read_deltas(sse, n: int) -> str:
    """Read an open SSE completion until ``n`` content deltas arrived."""
    text, got = "", 0
    for e in _sse_events(sse[1]):
        check("error" not in e, f"SSE error: {e}")
        piece = (e["choices"][0].get("delta") or {}).get("content", "")
        text += piece
        got += bool(piece)
        if got >= n:
            break
    return text


def _read_rest(sse) -> tuple[str, str | None]:
    text, err = _sse_text(list(_sse_events(sse[1])))
    sse[0].close()
    return text, err


def _sse_text(events) -> tuple[str, str | None]:
    """(the content an SSE client saw, its terminal error type or None)."""
    if not isinstance(events, list):
        fail(f"not an SSE stream: {events}")
    text, err = "", None
    for e in events:
        if "error" in e:
            err = e["error"]["type"]
        else:
            text += (e["choices"][0].get("delta") or {}).get("content", "")
    return text, err


def faults_phase(server_api, attn, q40, model: str, tok_path: str, smi: str) -> dict:
    """Phase 10 (see the module docstring): fault containment and fair
    admission in the port's server over a 7B-width model (8 layers in the
    full run, 32 with ``--faults``). The engine loads once; each fault plan
    gets its own server (a plan binds at construction), armed after the
    server's warm-up request so its rules count the round's hits."""
    from distributed_llama_tpu_torch import telemetry
    from distributed_llama_tpu_torch.apps.cli import make_engine
    from distributed_llama_tpu_torch.engine import faults, integrity
    from distributed_llama_tpu_torch.loadgen.report import parse_prometheus
    from distributed_llama_tpu_torch.tokenizer import ChatItem, Sampler

    t_phase = time.perf_counter()
    base = ["generate", "--model", model, "--tokenizer", tok_path, "--dtype", "q40", "--max-seq-len",
            str(SERVER_SEQ_LEN), "--parallel", "4", "--decode-chunk", "8", "--chat-template", "chatml",
            "--host", "127.0.0.1", "--port", "0", "--temperature", "0", "--admission-queue", "16", "--telemetry"]
    telemetry.reset()
    telemetry.enable()  # before the engine binds its instruments
    t0 = time.perf_counter()
    engine, tokenizer, _ = make_engine(server_api.build_parser().parse_args(base))
    torch.cuda.synchronize()
    print(f"engine load: {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    out: dict = {"card": smi}

    def counters() -> dict:
        m = parse_prometheus(telemetry.prometheus_text())
        return {k: v for k, v in m.items() if k.startswith(("dllama_batch_retries_total", "dllama_rows_quarantined",
                                                            "dllama_watchdog_stalls", "dllama_deadline_exceeded",
                                                            "dllama_preempt", "dllama_kernel_path_total"))}

    def moved(before: dict, after: dict, prefix: str) -> float:
        return sum(v - before.get(k, 0.0) for k, v in after.items() if k.startswith(prefix))

    def start(extra=(), plan: str | None = None):
        """A server over the shared engine; ``plan``'s rules start disarmed
        (count 0) and :func:`arm` gives them their counts."""
        args = server_api.build_parser().parse_args(base + list(extra))
        fault_plan = counts = None
        if plan:
            fault_plan = faults.install(faults.parse(plan))
            counts = [r.count for r in fault_plan.rules]
            for r in fault_plan.rules:
                r.count = 0
        try:
            state = server_api.ApiState(engine, tokenizer, Sampler(vocab_size=engine.cfg.vocab_size,
                                                                   temperature=0.0, topp=0.9, seed=1), args)
        finally:
            faults.clear()
        server, _ = server_api.make_server(args, state=state)
        captured: list = []
        _capture_streams(state, captured)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"

        def arm():
            if fault_plan is not None:
                for r, c in zip(fault_plan.rules, counts):
                    r.count = c
                fault_plan.reset()

        return server, state, url, captured, arm

    def stop(server, state):
        server.shutdown()
        server.server_close()
        state.close()  # frees its slab and pool
        gc.collect()
        torch.cuda.empty_cache()

    system = "You are a helpful assistant. "
    while len(tokenizer.encode(system, add_bos=False)) < 590:
        system += "hello world, "
    # every user turn starts with its own letter, so the pages a request
    # publishes past the shared system prompt match no other request and
    # each request of a round matches the same shared pages (the warm-up's)
    # on every server; the preemption round's turns go on with ~3 pages of
    # a story, so a replay matches further through the pool than its first
    # run did
    story = " tell me a story about " + "the world and hello " * 20

    def body(user, temperature=0.0, seed=1, max_tokens=FAULT_TOKENS, stream=False, **kw):
        return {"messages": [{"role": "system", "content": system}, {"role": "user", "content": user}],
                "max_tokens": max_tokens, "temperature": temperature, "seed": seed, "stream": stream, **kw}

    # 10a's round: 2 greedy and 2 sampled requests over the shared prefix;
    # each is keyed by its seed in the captured decodes
    round_a = [body("A hello", 0.0, 11), body("B world", 0.0, 12), body("C hello world", 0.8, 13),
               body("D world hello", 0.8, 14)]
    round_e = [body(c + story, 0.0, 21 + i, max_tokens=PREEMPT_TOKENS, stream=True, tenant="batch")
               for i, c in enumerate("EFGH")]
    warm = body("W warm up", 0.0, 99, max_tokens=4)
    live_body = body("L quick question", 0.0, 31, max_tokens=16, stream=True)

    def prompt_tokens(b: dict) -> list[int]:
        return tokenizer.encode(state.template.generate([ChatItem(m["role"], m["content"]) for m in b["messages"]],
                                                        append_generation_prompt=True), add_bos=True)

    def ids_by_seed(captured: list) -> dict:
        got: dict = {}
        for _, _, seed, ids in captured:
            got.setdefault(seed, []).append(ids)
        return got

    def warm_up(url, state, arm):
        r = _post_any(url, warm)
        check(r["status"] == 200, f"warm-up request: {r['status']}")
        for slot in state.slots:  # idle lanes drop their page pins
            slot.stream.reset()
        arm()

    # ---- 10a: the fault-free reference ---------------------------------
    server, state, url, captured, arm = start()
    matched_a = _record_matched(state)
    try:
        warm_up(url, state, arm)
        c0 = counters()
        attn.reset_launches()  # this path's counts start here
        q40.reset_launches()
        res = _concurrent(url, round_a)
        launches = {"q40_int8": q40.launches["q40_int8"], "k1_tiles": dict(q40.tile_launches),
                    "paged_attention": attn.launches["paged_attention"]}
        check(all(r["status"] == 200 for r in res), f"10a: {[r['status'] for r in res]}")
        check(launches["q40_int8"] > 0 and launches["paged_attention"] > 0, f"10a: K1 or K2 not launched: {launches}")
        print(f"10a: launches in the round {launches}")
        out["launches"] = launches
        ref = {s: v[-1] for s, v in ids_by_seed(captured).items()}
        check(all(ref[b["seed"]] for b in round_a), "10a: a stream is empty")
        print(f"10a: 4 concurrent requests ({len(prompt_tokens(round_a[0]))}-token prompts, {matched_a[11][-1]} "
              f"positions from the pool, 2 greedy, 2 sampled), {[len(ref[b['seed']]) for b in round_a]} tokens, in "
              f"{max(r['end_s'] for r in res):.2f} s")
        res_e = _concurrent(url, round_e)
        check(all(r["status"] == 200 for r in res_e), "10a: the preemption round's reference")
        ref_e = {b["seed"]: _sse_text(r["payload"])[0] for b, r in zip(round_e, res_e)}
        ids_now = ids_by_seed(captured)
        ref_e_ids = {b["seed"]: ids_now[b["seed"]][-1] for b in round_e}
        ref_e_matched = {b["seed"]: matched_a[b["seed"]][-1] for b in round_e}
        live_alone = _post_any(url, live_body)
        out["live_ttft_alone_ms"] = live_alone["first_s"] * 1e3
        a_counts = no_fault_counts(state, "10a")
        paths = {k: v - c0.get(k, 0.0) for k, v in counters().items() if k.startswith("dllama_kernel_path_total")}
        check(not any("plain" in k for k in paths), f"10a: a plain path served: {paths}")
        # the first-token logits of a hit (the shared pages) against a cold
        # prefill of the same prompt, bit for bit (a reading; 6b holds 5%)
        row = state.batch._streams[0]
        toks = prompt_tokens(round_e[0])
        row.reset()
        row.prefix_cache_enabled = False
        cold = row.prefill(toks)
        row.reset()
        row.prefix_cache_enabled = True
        hit = row.prefill(toks)
        matched = row.matched_len
        row.reset()
        out["hit_vs_cold"] = {"matched": matched, "max_abs_diff": float(np.abs(hit - cold).max()),
                              "bit_equal": bool(np.array_equal(hit, cold))}
        print(f"10a: a {len(toks)}-token prompt's first-token logits, hit ({matched} positions from the pool) vs "
              f"cold: max diff {out['hit_vs_cold']['max_abs_diff']:.4g}, bit-equal {out['hit_vs_cold']['bit_equal']}")
    finally:
        stop(server, state)
    out["10a"] = {"counts": a_counts}

    # ---- 10b: row faults -------------------------------------------------
    for label, plan in (("batch.row nan", f"batch.row:kind=nan,row={VICTIM_ROW},count=1"),
                        ("engine.paged_attn raise", f"engine.paged_attn:kind=raise,row={VICTIM_ROW},count=1")):
        server, state, url, captured, arm = start(plan=plan)
        sched = state.batch
        try:
            warm_up(url, state, arm)
            pinned0, c0 = sched._prefix._pinned, counters()
            res = _concurrent(url, round_a)
            statuses = [r["status"] for r in res]
            check(sorted(statuses) == [200, 200, 200, 500], f"10b {label}: statuses {statuses}")
            bad = next(r for r in res if r["status"] == 500)
            check("retired" in bad["payload"]["error"]["message"], f"10b {label}: {bad['payload']}")
            got = ids_by_seed(captured)
            for b, r in zip(round_a, res):
                if r["status"] == 200:
                    check(got[b["seed"]][-1] == ref[b["seed"]], f"10b {label}: survivor seed {b['seed']} diverged "
                          f"from 10a")
            c1 = counters()
            q = moved(c0, c1, "dllama_rows_quarantined_total")
            check(q == 1 and sched.quarantined_total == 1, f"10b {label}: quarantined {q}")
            check(not sched._streams[VICTIM_ROW]._alias_chain, f"10b {label}: the victim row kept its page pins")
            paths = {k: v - c0.get(k, 0.0) for k, v in c1.items() if k.startswith("dllama_kernel_path_total")}
            check(paths.get(K2_PATH, 0) > 0
                  and not any("plain" in k and v for k, v in paths.items()), f"10b {label}: kernel paths {paths}")
            for slot in state.slots:
                slot.stream.reset()
            sched.check_prefix()
            check(sched._prefix._pinned == pinned0, f"10b {label}: pinned pages {sched._prefix._pinned} after the "
                  f"round's lanes reset, {pinned0} before")
            print(f"10b {label}: statuses {statuses}; the 3 survivors equal 10a token for token; rows quarantined "
                  f"+{q:g}; pinned pages back to {pinned0} once the lanes reset; K2 calls in the round "
                  f"{paths.get(K2_PATH, 0):g}")
        finally:
            stop(server, state)
        out[f"10b {label}"] = {"statuses": statuses, "quarantined": q}

    # ---- 10c: a transient fetch error -----------------------------------
    server, state, url, captured, arm = start(plan="batch.fetch:kind=raise,count=1")
    sched = state.batch
    try:
        warm_up(url, state, arm)
        c0 = counters()
        res = _concurrent(url, round_a)
        check(all(r["status"] == 200 for r in res), f"10c: {[r['status'] for r in res]}")
        got = ids_by_seed(captured)
        check(all(got[b["seed"]][-1] == ref[b["seed"]] for b in round_a), "10c: a stream diverged from 10a")
        c1 = counters()
        retries = moved(c0, c1, "dllama_batch_retries_total")
        check(retries == 1 and sched.retries_total == 1, f"10c: retries {retries}")
        check(moved(c0, c1, "dllama_rows_quarantined_total") == 0, "10c: a row was quarantined")
        print(f"10c: all 4 streams equal 10a; dllama_batch_retries_total +{retries:g}, no quarantine")
    finally:
        stop(server, state)
    out["10c"] = {"retries": retries}

    # ---- 10d: a hung fetch ------------------------------------------------
    hang_at: list = []

    def on_fire(site, rule, row):
        if site == "batch.fetch" and rule.kind == "hang":
            hang_at.append(time.perf_counter())

    server, state, url, captured, arm = start(
        extra=("--stall-timeout-s", str(STALL_TIMEOUT_S)),
        plan=f"batch.fetch:kind=hang,delay_ms={HANG_MS},count=1")
    sched = state.batch
    faults.add_fire_observer(on_fire)
    try:
        warm_up(url, state, arm)
        c0 = counters()
        t_round = time.perf_counter()
        res = _concurrent(url, round_a)
        check(len(hang_at) == 1, f"10d: the hang fired {len(hang_at)} times")
        ends = [t_round + r["end_s"] - hang_at[0] for r in res]
        statuses = [r["status"] for r in res]
        check(all(s == 500 and "stall" in r["payload"]["error"]["message"] for s, r in zip(statuses, res)),
              f"10d: {statuses} {[r['payload'] for r in res]}")
        interval = max(min(STALL_TIMEOUT_S / 4.0, 1.0), 0.005)
        bound = STALL_TIMEOUT_S + interval + STALL_CHUNK_S
        print(f"10d: every row ended StallTimeout (500) at {', '.join(f'{e:.2f}' for e in ends)} s after the fetch "
              f"hung (stall timeout {STALL_TIMEOUT_S} s, watchdog period {interval} s; bound {bound} s)")
        check(max(ends) <= bound, f"10d: a row ended {max(ends):.2f} s after the hang (bound {bound} s)")
        c1 = counters()
        stalls = moved(c0, c1, "dllama_watchdog_stalls_total")
        check(stalls == 1 and sched.stalls_total == 1, f"10d: stalls {stalls}")
        r = _post_any(url, round_a[0])
        got = ids_by_seed(captured)
        check(r["status"] == 200 and got[round_a[0]["seed"]][-1] == ref[round_a[0]["seed"]],
              f"10d: the next request: {r['status']}")
        print("10d: the next request returned 200 and equals its 10a stream")
    finally:
        faults.remove_fire_observer(on_fire)
        stop(server, state)
    out["10d"] = {"ends_after_hang_s": ends, "bound_s": bound, "stalls": stalls}

    # ---- 10e: preemption --------------------------------------------------
    server, state, url, captured, arm = start(extra=("--tenants", "batch:weight=1,priority=0;live:weight=1,priority=1"))
    sched = state.batch
    matched_by_seed = _record_matched(state)
    try:
        warm_up(url, state, arm)
        c0 = counters()
        conns = [_open_sse(url, b) for b in round_e]
        firsts = [_read_deltas(c, 2) for c in conns]  # the fused first token and the first chunk's
        live = _post_any(url, {**live_body, "tenant": "live"})
        check(live["status"] == 200, f"10e: the live request: {live['status']}")
        texts, errs = [], []
        for c, first in zip(conns, firsts):
            rest, err = _read_rest(c)
            texts.append(first + rest)
            errs.append(err)
        c1 = counters()
        pre, req = moved(c0, c1, "dllama_preemptions_total"), moved(c0, c1, "dllama_preempted_requeued_total")
        check(not any(errs), f"10e: a batch stream ended with an error: {errs}")
        check(pre == 1 and req == 1 and sched.preempted_total == 1, f"10e: preemptions {pre}, requeued {req}")
        got = ids_by_seed(captured)
        contract = True
        for b, text in zip(round_e, texts):
            seed = b["seed"]
            runs = got[seed]
            want = ref_e_ids[seed]
            for k, ids in enumerate(runs):
                n = len(ids) if k < len(runs) - 1 else len(want)
                at = next((i for i, (x, y) in enumerate(zip(ids, want)) if x != y), None)
                if at is not None or ids[:n] != want[:n]:
                    contract = False
                    print(f"10e: seed {seed} attempt {k} ({'replay' if k else 'first run'}, matched "
                          f"{matched_by_seed.get(seed, [])[k:k + 1]} positions through the pool; 10a's run matched "
                          f"{ref_e_matched.get(seed)}): first divergence from 10a at token {at} of {len(ids)}")
            if text != ref_e[seed]:
                contract = False
                print(f"10e: seed {seed}: the client's stream differs from 10a's ({len(text)} vs {len(ref_e[seed])} "
                      "chars)")
        victims = [b["seed"] for b in round_e if len(got[b["seed"]]) > 1]
        print(f"10e: the victim's runs matched {[matched_by_seed.get(v) for v in victims]} positions (10a's run "
              f"{[ref_e_matched.get(v) for v in victims]})")
        print(f"10e: preemptions +{pre:g}, requeued +{req:g}; victim seed {victims}; every batch client's stream "
              f"equals 10a's token for token: {contract}; the live request's TTFT {live['first_s'] * 1e3:.1f} ms "
              f"with 4 rows busy, {out['live_ttft_alone_ms']:.1f} ms alone ({smi})")
        check(contract, "10e: the replay contract failed")
        check(len(victims) == 1, f"10e: {len(victims)} victims")
    finally:
        stop(server, state)
    out["10e"] = {"preemptions": pre, "requeued": req, "victims": victims, "replay_contract": contract,
                  "live_ttft_ms": live["first_s"] * 1e3}

    # ---- 10f: deadlines ---------------------------------------------------
    # the SSE writer sleeps DEADLINE_SEND_MS before the deadline request's
    # first event (the site fires for streamed requests only), so its
    # DEADLINE_MS budget runs out between its first and second token; it
    # is sent DEADLINE_LEAD_S ahead of its 3 co-batched requests, so its
    # prefill does not wait behind their decode chunks' launches
    server, state, url, captured, arm = start(plan=f"server.send:kind=delay,delay_ms={DEADLINE_SEND_MS},count=1")
    sched = state.batch
    try:
        warm_up(url, state, arm)
        c0 = counters()
        late: list = []
        t_dl = time.perf_counter()
        lead = threading.Thread(target=lambda: late.append(_post_any(
            url, body("X deadline", 0.0, 41, stream=True, deadline_ms=DEADLINE_MS), t_dl)))
        lead.start()
        time.sleep(DEADLINE_LEAD_S)
        res = _concurrent(url, round_a[1:])
        lead.join()
        res += late
        check(all(r["status"] == 200 for r in res), f"10f: {[(r['status'], r['payload']) for r in res]}")
        text, err = _sse_text(res[-1]["payload"])
        check(err == "deadline_exceeded" and text, f"10f: the deadline request's stream: error {err}, {len(text)} chars")
        got = ids_by_seed(captured)
        check(all(got[b["seed"]][-1] == ref[b["seed"]] for b in round_a[1:]), "10f: a co-batched row diverged")
        for _ in range(4):
            state.admission.acquire("hold")
        try:
            r = _post_any(url, body("Y late", 0.0, 42, deadline_ms=300))
        finally:
            for _ in range(4):
                state.admission.release()
        check(r["status"] == 504 and r["payload"]["error"]["type"] == "deadline_exceeded", f"10f: queued {r}")
        d = moved(c0, counters(), "dllama_deadline_exceeded_total")
        check(d == 2 and state.deadline_exceeded_total == 2, f"10f: deadlines {d}")
        print(f"10f: a {DEADLINE_MS} ms deadline ended its stream with an SSE deadline_exceeded event after "
              f"{len(text)} chars at {res[-1]['end_s']:.2f} s, its 3 co-batched rows equal 10a; a queued one got "
              f"504; dllama_deadline_exceeded_total +{d:g}")
    finally:
        stop(server, state)
    out["10f"] = {"deadline_ms": DEADLINE_MS, "deadlines": d}

    # ---- 10g: the weight checksum -----------------------------------------
    recorded = engine.weights_checksum()
    leaf_bytes = sum(t.numel() * t.element_size() for _, t in integrity._leaves(engine.params))
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = integrity.params_checksum(engine.params)  # ends in a host fetch
        times.append((time.perf_counter() - t0) * 1e3)
    bound_ms = leaf_bytes / HBM_BYTES_PER_S * 1e3
    check(again == recorded, "10g: the checksum is not stable")
    server, state, url, captured, arm = start(plan="engine.sdc:kind=corrupt,count=1")
    try:
        warm_up(url, state, arm)
        r = _post_any(url, round_a[0])
        check(r["status"] == 200, f"10g: the corrupting request: {r['status']}")
        corrupted = integrity.params_checksum(engine.params)
    finally:
        stop(server, state)
    check(corrupted != recorded, "10g: the checksum did not change after engine.sdc corrupted a weight slice")
    print(f"10g: weights_checksum {recorded} over {leaf_bytes / 1e9:.3f} GB of leaves: {min(times):.2f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in times)}), bound {bound_ms:.3f} ms at 3.35 TB/s ({smi}); after one "
          f"engine.sdc corrupt fire: {corrupted}")
    out["10g"] = {"checksum": recorded, "corrupted": corrupted, "ms": min(times), "runs_ms": times,
                  "bound_ms": bound_ms, "leaf_bytes": leaf_bytes}
    out["phase_s"] = time.perf_counter() - t_phase
    telemetry.disable()
    telemetry.reset()
    del engine
    return out


def faults_only(smi: str) -> None:
    """``--faults``: phase 2, phase 5's 7B-width files and phase 10 alone."""
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.ops import attention as attn
    from distributed_llama_tpu_torch.ops import cuda_build, q40
    from distributed_llama_tpu_torch.server import api as server_api

    phase("2. build kernels")
    print(f"nvcc build: {cuda_build.build():.1f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        model, tok = write_7b_files(synthetic, write_tokenizer_file, Path(tmp))
        print(f"wrote the 7B-width files in {time.perf_counter() - t:.1f} s")
        t = phase(f"10. the slice's path: fault containment and fair admission in the API server, {N_LAYERS} layers")
        summary = {"faults": faults_phase(server_api, attn, q40, model, tok, smi)}
        print(f"phase 10: {time.perf_counter() - t:.1f} s")
    (ROOT / "build" / "chip_smoke_faults.json").write_text(json.dumps(summary, indent=1))
    print(f"card: {smi}")


def kernel_paths() -> dict:
    """The registry's ``dllama_kernel_path_total`` as {"kernel/path": count}."""
    from distributed_llama_tpu_torch import telemetry
    from distributed_llama_tpu_torch.loadgen.report import parse_prometheus

    m = parse_prometheus(telemetry.prometheus_text())
    return {k.split("{")[1].rstrip("}").replace('kernel="', "").replace('",path="', "/").rstrip('"'): v
            for k, v in m.items() if k.startswith("dllama_kernel_path_total{")}


def check_kernel_paths(before: dict, label: str, want=("q40_matmul/k1_dp4a",)) -> dict:
    """A sub-phase's kernel-path counts since ``before``: K1 (the tiles in
    ``want``) and K2 served, and no plain path (nor einsum) ran."""
    moved = {k: v - before.get(k, 0.0) for k, v in kernel_paths().items() if v - before.get(k, 0.0) > 0}
    check(all(k in K1_K2_PATHS for k in moved), f"{label}: a path other than K1/K2 served: {moved}")
    check(all(moved.get(k, 0) > 0 for k in want), f"{label}: {want} not all launched: {moved}")
    check(any(k.startswith("paged_attention/k2") for k in moved), f"{label}: K2 not launched: {moved}")
    return moved


def spill_phase(server_api, model: str, tok_path: str, smi: str, workdir: Path, cost: bool = False) -> dict:
    """Phase 11 (see the module docstring): the host spill tier and the
    supervised replica pool in the port's server over the 7B-width model
    (8 layers in the full run, 32 with ``--spill``); ``cost`` adds 11d
    (``--spill`` only)."""
    from distributed_llama_tpu_torch import telemetry
    from distributed_llama_tpu_torch.apps.cli import make_engine
    from distributed_llama_tpu_torch.engine import faults
    from distributed_llama_tpu_torch.telemetry import flight
    from distributed_llama_tpu_torch.tokenizer import ChatItem, Sampler

    t_phase = time.perf_counter()
    base = ["generate", "--model", model, "--tokenizer", tok_path, "--dtype", "q40", "--max-seq-len",
            str(SERVER_SEQ_LEN), "--decode-chunk", "8", "--chat-template", "chatml", "--host", "127.0.0.1",
            "--port", "0", "--temperature", "0", "--admission-queue", "16", "--telemetry"]
    out: dict = {"card": smi}
    paths, check_paths = kernel_paths, check_kernel_paths

    def system_prompt(tokenizer, word: str) -> str:
        text = f"{word} You are a helpful assistant. "
        while len(tokenizer.encode(text, add_bos=False)) < 590:
            text += f"{word} hello world, "
        return text

    def body(system, user="hi", max_tokens=SPILL_TOKENS, seed=1, stream=True):
        return {"messages": [{"role": "system", "content": system}, {"role": "user", "content": user}],
                "max_tokens": max_tokens, "temperature": 0.0, "seed": seed, "stream": stream}

    def rate_body(i):
        # a short prompt: the window measures decode, not prefill
        return {"messages": [{"role": "system", "content": "You are a helpful assistant."},
                             {"role": "user", "content": f"rate {i} tell me a story"}],
                "max_tokens": RATE_TOKENS, "temperature": 0.0, "seed": 60 + i, "stream": True}

    def serve(state, args):
        server, _ = server_api.make_server(args, state=state)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, f"http://127.0.0.1:{server.server_address[1]}"

    def stop(server, state):
        server.shutdown()
        server.server_close()
        state.close()
        gc.collect()
        torch.cuda.empty_cache()

    def idle_lanes(state):
        for slot in state.slots:  # idle lanes drop their page pins
            slot.stream.reset()

    def one(url, state, b, captured, label):
        r = _post_any(url, b)
        check(r["status"] == 200, f"{label}: {r['status']} {r['payload']}")
        _, err = _sse_text(r["payload"])
        check(err is None, f"{label}: SSE error {err}")
        idle_lanes(state)
        return r["first_s"] * 1e3, captured[-1][3]

    def prompt_tokens(state, b) -> list[int]:
        return state.tokenizer.encode(state.template.generate([ChatItem(m["role"], m["content"]) for m in
                                                               b["messages"]], append_generation_prompt=True),
                                      add_bos=True)

    def evict_all(sched) -> tuple[int, float]:
        """Spill every evictable pool page (the LRU leaves first), device
        work fenced: (pages spilled, seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sched._cond:
            n0 = sched._prefix.spills
            while sched._prefix._evict_one():
                pass
            n = sched._prefix.spills - n0
        torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    def reload_timed(sched, toks) -> tuple[int, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sched._cond:
            n = sched._reload_spilled_locked(np.asarray(toks))
        torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    def check_spilled(sched, label: str) -> None:
        """Every eviction spilled: a failed download prints "page spill
        failed" and evicts without a spill (the reference keeps serving so);
        this phase fails on it."""
        pre = sched._prefix
        check(pre.spills == pre.evictions, f"{label}: {pre.evictions} evictions but {pre.spills} spills")

    # ---- 11a: spill and reload, int8 then bf16 -------------------------
    # (the bf16 engine then serves 11b and is replica 0 of 11c)
    for cache in ("i8", "bf16"):
        label = f"11a {cache}"
        extra = ["--parallel", "4", "--kv-pages", str(SPILL_KV_PAGES), "--host-spill-mb", str(SPILL_HOST_MB)]
        if cache == "i8":
            extra += ["--cache-dtype", "i8"]
        args = server_api.build_parser().parse_args(base + extra)
        telemetry.reset()
        telemetry.enable()  # before the engine binds its instruments
        t0 = time.perf_counter()
        engine, tokenizer, _ = make_engine(args)
        state = server_api.ApiState(engine, tokenizer, Sampler(vocab_size=engine.cfg.vocab_size, temperature=0.0,
                                                               topp=0.9, seed=1), args)
        sched = state.batch
        check(sched._prefix is not None and sched._prefix.spill is not None and sched._copy_stream is not None,
              f"{label}: no spill tier on the card")
        captured: list = []
        _capture_streams(state, captured)
        server, url = serve(state, args)
        print(f"{label}: server up in {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} "
              f"GB on the card, pool {SPILL_KV_PAGES} pages of {sched._prefix.page_bytes / 2**20:.1f} MiB")
        try:
            systems = [system_prompt(tokenizer, w) for w in ("Alpha", "Bravo", "Charlie", "Delta")]
            p1 = body(systems[0])
            toks1 = prompt_tokens(state, p1)
            one(url, state, body(systems[3], "warm", max_tokens=2), captured, f"{label} warm-up")
            with sched._cond:  # the warm-up's pages out of the way: the round starts empty of them
                while sched._prefix._evict_one():
                    pass
            sched._prefix.spill.drop_owner(0)
            c0, rel0, sp0, ev0 = paths(), sched._prefix.spill.reloaded_total, sched._prefix.spills, \
                sched._prefix.evictions
            cold_ms, cold_ids = one(url, state, p1, captured, f"{label} cold")
            hit_ms, hit_ids = one(url, state, p1, captured, f"{label} lone hit")
            check(hit_ids == cold_ids, f"{label}: the lone hit's stream differs from the cold one")
            for sysp in systems[1:]:
                one(url, state, body(sysp), captured, f"{label} churn")
            resident = len(sched._prefix.walk(toks1))
            check(resident < len(toks1) // sched._prefix.page, f"{label}: the churn left P1 resident ({resident})")
            spilled_chains = sum(sched._prefix.spill.has(0, tuple(toks1[: (i + 1) * sched._prefix.page]))
                                 for i in range((len(toks1) - 1) // sched._prefix.page))
            check(spilled_chains > 0, f"{label}: none of P1's pages is in the arena")
            up0 = sched.spill_uploads
            reload_ms, reload_ids = one(url, state, p1, captured, f"{label} reloaded")
            check(reload_ids == cold_ids, f"{label}: the reloaded stream differs from the cold one: "
                  f"{reload_ids} vs {cold_ids}")
            reloaded = sched.spill_uploads - up0
            check(reloaded > 0 and sched._prefix.spill.reloaded_total > rel0, f"{label}: no page reloaded")
            check(sched._prefix.evictions > ev0 and sched._prefix.spills > sp0, f"{label}: no eviction or spill")
            moved = check_paths(c0, label, ("q40_matmul/k1_dp4a", "q40_matmul/k1_mma"))
            # the reloaded pages' first-token logits against a cold
            # prefill, and (int8) their bytes against the spilled ones
            row = sched._streams[0]
            row.reset()
            row.prefix_cache_enabled = False
            cold_logits = row.prefill(toks1)
            row.reset()
            row.prefix_cache_enabled = True
            nodes = sched._prefix.walk(toks1)
            before = [[a.copy() for a in sched._download_page(nd.page_id)] for nd in nodes]
            n_spilled, spill_s = evict_all(sched)
            check(sched._prefix.walk(toks1) == [], f"{label}: P1 still resident after the eviction")
            n_reloaded, reload_s = reload_timed(sched, toks1)
            check(n_reloaded == len(nodes), f"{label}: reloaded {n_reloaded} of {len(nodes)} pages")
            hit_logits = row.prefill(toks1)
            matched = row.matched_len
            row.reset()
            diff = float(np.abs(hit_logits - cold_logits).max())
            check(matched == len(nodes) * sched._prefix.page and np.array_equal(hit_logits, cold_logits),
                  f"{label}: reloaded first-token logits differ from a cold prefill's: max diff {diff} "
                  f"({matched} positions from the pool)")
            if cache == "i8":
                for want, nd in zip(before, sched._prefix.walk(toks1)):
                    got = sched._download_page(nd.page_id)
                    check(len(got) == len(want) and all(
                        a.dtype == b.dtype and a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()
                        for a, b in zip(got, want)), f"{label}: a reloaded page's data or scales changed")
            check_spilled(sched, label)
            pre = sched._prefix
            res = {"cold_ttft_ms": cold_ms, "hit_ttft_ms": hit_ms, "reload_ttft_ms": reload_ms,
                   "reloaded_pages_in_request": reloaded, "evictions": pre.evictions - ev0,
                   "spills": pre.spills - sp0,
                   "lock_hold_ms_per_spill": pre.spill_s / max(pre.spills, 1) * 1e3,
                   "download_ms_per_page": sched.spill_download_s / max(sched.spill_downloads, 1) * 1e3,
                   "spill_ms_per_page_fenced": spill_s / max(n_spilled, 1) * 1e3, "spilled_fenced": n_spilled,
                   "reload_ms_per_page_fenced": reload_s / max(n_reloaded, 1) * 1e3,
                   "reloaded_fenced": n_reloaded, "page_mib": pre.page_bytes / 2**20,
                   "logits_max_abs_diff": diff, "paths": moved, "stream_tokens": len(cold_ids)}
            if cache == "bf16":
                # decode rate of one replica at 2 rows (the 11c comparison)
                res["rate_1x2"] = _decode_rate(url, [rate_body(i) for i in range(2)])
                idle_lanes(state)
            out[label] = res
            print(f"{label}: TTFT cold {cold_ms:.1f} ms, lone hit {hit_ms:.1f} ms, reloaded ({reloaded} pages "
                  f"from the arena) {reload_ms:.1f} ms; streams equal ({len(cold_ids)} tokens); evictions "
                  f"{res['evictions']}, spills {res['spills']}; per spilled page: lock hold "
                  f"{res['lock_hold_ms_per_spill']:.2f} ms, download {res['download_ms_per_page']:.2f} ms; "
                  f"fenced: {n_spilled} pages spilled at {res['spill_ms_per_page_fenced']:.2f} ms/page, "
                  f"{n_reloaded} reloaded at {res['reload_ms_per_page_fenced']:.2f} ms/page "
                  f"({res['page_mib']:.1f} MiB pages); reloaded first-token logits equal a cold prefill's "
                  f"bit for bit ({matched} positions from the pool)"
                  f"{'; int8 data and scales byte-equal' if cache == 'i8' else ''}; kernel paths {moved}")
        finally:
            stop(server, state)
            row = state = sched = pre = None  # nothing here may keep a replica's engine alive
            if cache == "i8":
                del engine
            gc.collect()
            torch.cuda.empty_cache()

    # ---- 11b: the disk tier, then a corrupt entry (11a's bf16 engine) ----
    label = "11b"
    disk_dir = workdir / "spill_disk"
    plan = faults.install(faults.parse("engine.spill:kind=corrupt,count=1"))
    plan.rules[0].count = 0  # armed below
    args = server_api.build_parser().parse_args(base + [
        "--parallel", "4", "--kv-pages", str(SPILL_KV_PAGES), "--host-spill-mb", str(SPILL_DISK_HOST_MB),
        "--spill-disk-dir", str(disk_dir), "--spill-disk-mb", str(SPILL_DISK_MB)])
    try:
        state = server_api.ApiState(engine, tokenizer, Sampler(vocab_size=engine.cfg.vocab_size, temperature=0.0,
                                                               topp=0.9, seed=1), args)
    finally:
        faults.clear()
    sched = state.batch
    arena = sched._prefix.spill
    check(arena.disk is not None, f"{label}: no disk tier")
    captured = []
    _capture_streams(state, captured)
    server, url = serve(state, args)
    try:
        systems = [system_prompt(tokenizer, w) for w in ("Echo", "Foxtrot", "Golf", "Hotel")]
        p1 = body(systems[0])
        c0 = paths()
        _, cold_ids = one(url, state, p1, captured, f"{label} cold")
        for sysp in systems[1:]:
            one(url, state, body(sysp), captured, f"{label} churn")
        check(len(arena.disk) > 0, f"{label}: nothing demoted to the disk tier")
        up0, rel0 = sched.spill_uploads, arena.reloaded_total
        demoted = len(arena.disk)
        _, disk_ids = one(url, state, p1, captured, f"{label} reload")
        check(disk_ids == cold_ids, f"{label}: the disk-tier reload's stream differs from the cold one")
        check(sched.spill_uploads > up0 and arena.reloaded_total > rel0, f"{label}: nothing reloaded")
        moved = check_paths(c0, label)
        check_spilled(sched, label)
        # churn P1 out again, then corrupt its arena entry at the reload
        for sysp in systems[1:]:
            one(url, state, body(sysp), captured, f"{label} churn again")
        toks1 = prompt_tokens(state, p1)
        with sched._cond:
            while sched._prefix._evict_one():
                pass
        check(arena.has(0, tuple(toks1[:sched._prefix.page])), f"{label}: P1's first page is not spilled")
        corrupt0, up0 = arena.corrupt_total, sched.spill_uploads
        plan.rules[0].count = 1
        plan.reset()
        _, corrupt_ids = one(url, state, p1, captured, f"{label} corrupt")
        check(corrupt_ids == cold_ids, f"{label}: the stream after a corrupt entry differs from the cold one")
        check(arena.corrupt_total > corrupt0, f"{label}: the CRC gate never fired")
        check(sched.spill_uploads == up0, f"{label}: a corrupt entry's bytes were uploaded")
        out[label] = {"disk_entries": demoted, "disk_reloaded": arena.reloaded_total - rel0,
                      "corrupt_dropped": arena.corrupt_total - corrupt0, "paths": moved}
        print(f"{label}: {demoted} pages on the disk tier ({SPILL_DISK_HOST_MB} MiB host arena); the reload's "
              f"stream equals the cold one; after an engine.spill corrupt fire the CRC dropped "
              f"{arena.corrupt_total - corrupt0} entries and the cold prefill streamed the same tokens; kernel "
              f"paths {moved}")
    finally:
        stop(server, state)
        del state, sched, arena
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(disk_dir, ignore_errors=True)

    if cost:
        out["11d"] = spill_cost(server_api, engine, tokenizer, base, serve, stop, idle_lanes, system_prompt, body,
                                paths, check_paths)

    # ---- 11c: two replicas, a crash, replay, restart ---------------------
    label = "11c"
    plan = faults.install(faults.parse("replica.crash:kind=raise,row=0,count=1"))
    plan.rules[0].count = 0  # armed mid-decode below
    args = server_api.build_parser().parse_args(base + [
        "--replicas", "2", "--parallel", "2", "--replica-restart-backoff-s", "0.1", "--host-spill-mb",
        str(SPILL_HOST_MB), "--flight-dump-dir", str(workdir)])
    flight.RECORDER.clear()
    t0 = time.perf_counter()
    try:
        # replica 0 is the bf16 engine; replica 1 and every rebuild come
        # from the factory
        state = server_api.ApiState(engine, tokenizer, Sampler(vocab_size=engine.cfg.vocab_size, temperature=0.0,
                                                               topp=0.9, seed=1), args,
                                    engine_factory=lambda: make_engine(args)[0])
    finally:
        faults.clear()
    del engine  # the pool's reference only: its restart frees it
    server, url = serve(state, args)
    pool = state.pool
    torch.cuda.synchronize()
    gc.collect()
    mem_boot = torch.cuda.memory_allocated()
    print(f"{label}: 2 replicas x 2 lanes up in {time.perf_counter() - t0:.1f} s, card memory "
          f"{mem_boot / 1e9:.2f} GB allocated after boot")
    captured = []  # (prompt, temperature, seed, ids, replica lanes)
    for rep in pool.replicas:
        _capture_streams(types.SimpleNamespace(slots=rep.slots), captured, tag=f"r{rep.idx}")
    build = pool.build_replica

    def build_and_capture(idx):
        # a rebuilt replica's lanes are recorded too: a victim may replay
        # there, and the last decode recorded for it must be the replay
        built = build(idx)
        _capture_streams(types.SimpleNamespace(slots=built[2]), captured, tag=f"r{idx} rebuilt")
        return built

    pool.build_replica = build_and_capture
    try:
        status, ready = _get_json(url + "/readyz")
        check(status == 200 and [r["replica"] for r in ready["replicas"]] == [0, 1], f"{label}: /readyz {ready}")
        system = system_prompt(state.tokenizer, "India")
        bodies = [body(system, f"{c} tell me a story", max_tokens=REPLICA_TOKENS, seed=40 + i)
                  for i, c in enumerate("WXYZ")]
        # the warm request decodes alone (K1's dp4a tile); the rounds below
        # keep both lanes of a replica busy (its tensor-core tile) unless
        # their timing leaves one row alone
        c0 = paths()
        _post_any(url, body(system, "warm", max_tokens=2))
        idle_lanes(state)
        ref = _concurrent(url, bodies)
        check(all(r["status"] == 200 for r in ref), f"{label}: the reference round: {[r['status'] for r in ref]}")
        ref_text = [_sse_text(r["payload"])[0] for r in ref]
        ref_ids = {seed: ids for _, _, seed, ids, _ in captured}
        n_ref = len(captured)
        idle_lanes(state)
        # the faulted round: 4 streams opened at once, each past its first
        # delta (every lane decoding), then replica 0's next dispatch
        # crashes. Opened one after another, the first streams could end
        # before the last one's first delta: a lane still busy with a
        # finished stream counts as a victim but has nothing to replay.
        sses: list = [None] * len(bodies)
        openers = [threading.Thread(target=lambda i=i: sses.__setitem__(i, _open_sse(url, bodies[i])))
                   for i in range(len(bodies))]
        for t in openers:
            t.start()
        for t in openers:
            t.join()
        check(all(sses), f"{label}: a faulted-round stream did not open")
        firsts = [_read_deltas(sse, 1) for sse in sses]
        plan.rules[0].count = 1
        plan.reset()
        rests = [_read_rest(sse) for sse in sses]
        texts = [f + r[0] for f, r in zip(firsts, rests)]
        check(all(r[1] is None for r in rests), f"{label}: SSE errors {[r[1] for r in rests]}")
        check(texts == ref_text, f"{label}: a client's stream differs from the unfaulted run's")
        runs: dict = {}  # seed -> its decodes in the faulted round: (replica lanes, ids)
        for _, _, seed, ids, where in captured[n_ref:]:
            runs.setdefault(seed, []).append((where, ids))
        # a victim's first decode ended at the crash, a strict prefix of the
        # unfaulted stream; its last is the replay, on the lanes named
        victims = {seed: r for seed, r in runs.items() if len(r) > 1}
        victim_runs = [f"seed {seed}: {len(r[0][1])} tokens on {r[0][0]}, then {len(r[-1][1])} on {r[-1][0]}"
                       for seed, r in sorted(victims.items())]
        check(len(victims) == pool.last_failover_victims
              and all(len(r) == 2 and r[0][0] == "r0" and len(r[0][1]) < len(ref_ids[seed])
                      and r[0][1] == ref_ids[seed][:len(r[0][1])] for seed, r in victims.items()),
              f"{label}: {pool.last_failover_victims} victims, {pool.replayed_total} replays; every decode of "
              f"the faulted round: {[(seed, [(w, len(ids)) for w, ids in r]) for seed, r in sorted(runs.items())]}")
        check(all(runs[b["seed"]][-1][1] == ref_ids[b["seed"]] for b in bodies),
              f"{label}: a replayed stream differs from the unfaulted run token for token: {victim_runs}")
        check(pool.failovers_total == 1 and pool.replayed_total == pool.last_failover_victims > 0,
              f"{label}: failovers {pool.failovers_total}, replays {pool.replayed_total}, victims "
              f"{pool.last_failover_victims}")
        check(pool.wait_state(0, "healthy", timeout_s=300), f"{label}: replica 0 did not come back")
        states = [e for e in flight.RECORDER.snapshot()["replicas"].get("0", []) if e["kind"] == "state"]
        walk = [(e["frm"], e["to"]) for e in states]
        check(("healthy", "dead") in walk and ("dead", "healthy") in walk, f"{label}: replica 0's walk {walk}")
        # dead -> healthy, from the recorder's clock: the release, the
        # rebuild (one engine load) and its checksum
        restart_s = (next(e["t_s"] for e in states if e["to"] == "healthy")
                     - next(e["t_s"] for e in states if e["to"] == "dead"))
        check(pool.sdc_checks_total == 1 and pool.sdc_mismatches_total == 0, f"{label}: rebuild checksum")
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        check(abs(mem_after - mem_boot) <= MEMORY_TOL_REL * mem_boot,
              f"{label}: card memory {mem_after / 1e9:.2f} GB after the restart, {mem_boot / 1e9:.2f} GB after boot")
        status, ready = _get_json(url + "/readyz")
        check(status == 200 and [(r["replica"], r["state"]) for r in ready["replicas"]] == [(0, "healthy"),
                                                                                          (1, "healthy")],
              f"{label}: /readyz after the restart {ready}")
        status, snap = _get_json(url + "/debug/flight")
        events = [e for ring in snap["replicas"].values() for e in ring]
        check(status == 200 and any(e["kind"] == "failover" for e in events)
              and any(e["kind"] == "fault_fire" and e["site"] == "replica.crash" for e in events),
              f"{label}: the flight recorder lacks the failover or the fault fire")
        moved = check_paths(c0, label)
        # aggregate decode rate, 2 replicas x 2 rows
        idle_lanes(state)
        rate = _decode_rate(url, [rate_body(i) for i in range(4)])
        idle_lanes(state)
        # a chain replica 1 spilled reloads into replica 0 by copy
        s0, s1 = pool.replicas[0].scheduler, pool.replicas[1].scheduler
        q = prompt_tokens(state, body(system_prompt(state.tokenizer, "November")))
        lane1 = s1._streams[0]
        lane1.reset()
        lane1.prefill(q)  # publishes Q's pages on replica 1
        lane1.reset()
        evict_all(s1)
        check_spilled(s0, label)
        check_spilled(s1, label)
        arena = s1._prefix.spill
        check(arena.has(1, tuple(q[:s1._prefix.page])), f"{label}: replica 1 did not spill Q")
        depth1, rel0 = arena.depth(1), arena.reloaded_total
        lane0 = s0._streams[0]
        lane0.reset()
        lane0.prefix_cache_enabled = False
        cold0 = lane0.prefill(q)
        lane0.reset()
        lane0.prefix_cache_enabled = True
        peer = lane0.prefill(q)
        matched0 = lane0.matched_len
        lane0.reset()
        check(matched0 > 0 and arena.reloaded_total > rel0 and arena.depth(1) == depth1,
              f"{label}: replica 0 did not reload replica 1's chain by copy ({matched0} positions)")
        check(np.array_equal(peer, cold0), f"{label}: replica 0's logits over replica 1's spilled chain differ "
              f"from its cold prefill's: max diff {float(np.abs(peer - cold0).max())}")
        out[label] = {"boot_gb": mem_boot / 1e9, "after_restart_gb": mem_after / 1e9, "restart_s": restart_s,
                      "victims": pool.last_failover_victims, "replays": pool.replayed_total, "walk": walk,
                      "paths": moved, "rate_2x2": rate, "peer_reload_positions": matched0,
                      "victim_runs": victim_runs}
        r1 = out["11a bf16"]["rate_1x2"]["tok_s"] if "11a bf16" in out else None
        print(f"{label}: card memory {mem_boot / 1e9:.2f} GB after boot, {mem_after / 1e9:.2f} GB after the restart; "
              f"replica.crash on replica 0 mid-decode: {pool.last_failover_victims} victims replayed "
              f"({'; '.join(victim_runs)}), all 4 streams equal the unfaulted run token for token; replica 0 dead -> healthy in "
              f"{restart_s:.1f} s (rebuild checksum ok); /readyz and /debug/flight agree; aggregate decode "
              f"{rate['tok_s']:.1f} tok/s at 2 replicas x 2 rows vs {r1 if r1 is None else round(r1, 1)} at "
              f"1 replica x 2 rows; replica 0 reloaded replica 1's spilled chain ({matched0} positions) with "
              f"first-token logits equal to its cold prefill's; kernel paths {moved}")
    finally:
        server.shutdown()
        server.server_close()
        state.close()
        del state, pool
        gc.collect()
        torch.cuda.empty_cache()
    telemetry.disable()
    telemetry.reset()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def spill_cost(server_api, engine, tokenizer, base, serve, stop, idle_lanes, system_prompt, body, paths,
               check_paths) -> dict:
    """11d: what the default spill arena costs decoding rows while prompts
    churn the pool. Two greedy rows decode (short prompts) while
    ``SPILL_COST_CHURN`` distinct ~600-token prompts arrive one after
    another on a 24-page pool, each evicting about 10 pages; arms at
    ``--host-spill-mb`` 64 (the default: every eviction downloads and CRCs
    its page under the scheduler lock) and 0 (an evicted page vanishes),
    run 64, 0, 0, 64 on one engine. Per arm: the rows' tokens delivered
    inside the churn window, their aggregate tok/s and mean TPOT there,
    the churn prompts' mean TTFT, evictions, spills and the lock held for
    them. A reading: nothing here fails on speed."""
    from distributed_llama_tpu_torch.tokenizer import Sampler

    systems = [system_prompt(tokenizer, f"Churn{i}") for i in range(SPILL_COST_CHURN)]
    arms = []
    for mb in SPILL_COST_ARMS:
        label = f"11d --host-spill-mb {mb}"
        args = server_api.build_parser().parse_args(base + [
            "--parallel", "4", "--kv-pages", str(SPILL_KV_PAGES), "--host-spill-mb", str(mb)])
        state = server_api.ApiState(engine, tokenizer, Sampler(vocab_size=engine.cfg.vocab_size, temperature=0.0,
                                                               topp=0.9, seed=1), args)
        sched = state.batch
        check((sched._prefix.spill is not None) == (mb > 0), f"{label}: arena {sched._prefix.spill}")
        server, url = serve(state, args)
        try:
            _post_any(url, body(system_prompt(tokenizer, "Warm"), "warm", max_tokens=2))
            idle_lanes(state)
            with sched._cond:
                while sched._prefix._evict_one():
                    pass
            c0, ev0, sp0, hold0 = paths(), sched._prefix.evictions, sched._prefix.spills, sched._prefix.spill_s
            stamps: list = [[], []]

            def decode(i):
                sse = _open_sse(url, {"messages": [{"role": "user", "content": f"cost {i} tell me a story"}],
                                      "max_tokens": SPILL_COST_DECODE_TOKENS, "temperature": 0.0, "seed": 70 + i,
                                      "stream": True})
                for e in _sse_events(sse[1]):
                    check("error" not in e, f"{label}: SSE error {e}")
                    if (e["choices"][0].get("delta") or {}).get("content"):
                        stamps[i].append(time.perf_counter())
                sse[0].close()

            threads = [threading.Thread(target=decode, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            while not all(stamps) and all(t.is_alive() for t in threads):
                time.sleep(0.01)
            t_c0 = time.perf_counter()
            ttft = []
            for sysp in systems:
                r = _post_any(url, body(sysp, max_tokens=2))
                check(r["status"] == 200, f"{label}: churn {r['status']}")
                ttft.append(r["first_s"] * 1e3)
            t_c1 = time.perf_counter()
            for t in threads:
                t.join()
            idle_lanes(state)
            inside = [sum(t_c0 <= x <= t_c1 for x in st) for st in stamps]
            check(all(st and st[-1] > t_c1 for st in stamps), f"{label}: a row stopped decoding inside the churn")
            window = t_c1 - t_c0
            pre = sched._prefix
            res = {"host_spill_mb": mb, "churn_window_s": window, "row_tokens_in_window": inside,
                   "tok_s": sum(inside) / window, "tpot_ms": float(np.mean([window / n * 1e3 for n in inside])),
                   "churn_ttft_ms": float(np.mean(ttft)), "evictions": pre.evictions - ev0,
                   "spills": pre.spills - sp0, "lock_hold_s": pre.spill_s - hold0,
                   "paths": check_paths(c0, label, ("q40_matmul/k1_mma",))}  # 2+ rows: the tensor-core tile
            check(res["evictions"] > 0 and res["spills"] == (res["evictions"] if mb > 0 else 0),
                  f"{label}: evictions {res['evictions']}, spills {res['spills']}")
            arms.append(res)
            print(f"{label}: 2 rows decoding through {SPILL_COST_CHURN} churn prompts ({window:.2f} s): "
                  f"{res['tok_s']:.2f} tok/s, TPOT {res['tpot_ms']:.1f} ms, churn TTFT {res['churn_ttft_ms']:.1f} ms; "
                  f"evictions {res['evictions']}, spills {res['spills']}, lock held {res['lock_hold_s'] * 1e3:.1f} "
                  f"ms for them")
        finally:
            stop(server, state)
            del state, sched
    by = {mb: [a for a in arms if a["host_spill_mb"] == mb] for mb in set(SPILL_COST_ARMS)}
    mean = {mb: {k: float(np.mean([a[k] for a in v])) for k in ("tok_s", "tpot_ms", "churn_ttft_ms")}
            for mb, v in by.items()}
    print(f"11d: mean of the arms, --host-spill-mb 64 vs 0: {mean[64]['tok_s']:.2f} vs {mean[0]['tok_s']:.2f} tok/s, "
          f"TPOT {mean[64]['tpot_ms']:.1f} vs {mean[0]['tpot_ms']:.1f} ms, churn TTFT {mean[64]['churn_ttft_ms']:.1f} "
          f"vs {mean[0]['churn_ttft_ms']:.1f} ms")
    return {"arms": arms, "mean": mean}


def _decode_rate(url: str, bodies: list) -> dict:
    """Aggregate decode tokens/s of concurrent streamed requests that run to
    their max_tokens: the tokens after each one's first over the window from
    the first first-token to the last end (host clock)."""
    res = _concurrent(url, bodies)
    check(all(r["status"] == 200 for r in res), f"decode rate: {[r['status'] for r in res]}")
    n = 0
    for b, r in zip(bodies, res):  # a stop before max_tokens counts its content deltas
        if r["payload"][-1]["choices"][0]["finish_reason"] == "length":
            n += b["max_tokens"] - 1
        else:
            n += max(sum(bool((e["choices"][0].get("delta") or {}).get("content")) for e in r["payload"]) - 1, 0)
    window = max(r["end_s"] for r in res) - min(r["first_s"] for r in res)
    return {"streams": len(bodies), "tokens": n, "window_s": window, "tok_s": n / window}


def spill_only(smi: str) -> None:
    """``--spill``: phase 2, phase 5's 7B-width files and phase 11 alone."""
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.ops import cuda_build
    from distributed_llama_tpu_torch.server import api as server_api

    phase("2. build kernels")
    print(f"nvcc build: {cuda_build.build():.1f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        model, tok = write_7b_files(synthetic, write_tokenizer_file, Path(tmp))
        print(f"wrote the 7B-width files in {time.perf_counter() - t:.1f} s")
        t = phase(f"11. the slice's path: the host spill tier and the replica pool in the API server, {N_LAYERS} layers")
        summary = {"spill": spill_phase(server_api, model, tok, smi, Path(tmp), cost=True)}
        print(f"phase 11: {time.perf_counter() - t:.1f} s")
    (ROOT / "build" / "chip_smoke_spill.json").write_text(json.dumps(summary, indent=1, default=str))
    print(f"card: {smi}")


def fleet_phase(server_api, model: str, tok_path: str, smi: str, workdir: Path) -> dict:
    """Phase 12 (see the module docstring): the SDC canary, shadow votes,
    weight versions with blue-green rollout and the fleet controller in the
    port's server, ``--replicas 2 --parallel 2``, over the 7B-width model
    (8 layers in the full run, 32 with ``--fleet``)."""
    import copy
    import weakref

    from distributed_llama_tpu_torch import telemetry
    from distributed_llama_tpu_torch.apps.cli import make_engine
    from distributed_llama_tpu_torch.engine import faults
    from distributed_llama_tpu_torch.telemetry import flight
    from distributed_llama_tpu_torch.tokenizer import Sampler

    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    args = server_api.build_parser().parse_args([
        "generate", "--model", model, "--tokenizer", tok_path, "--dtype", "q40", "--max-seq-len",
        str(SERVER_SEQ_LEN), "--decode-chunk", "8", "--chat-template", "chatml", "--host", "127.0.0.1", "--port",
        "0", "--temperature", "0", "--admission-queue", "16", "--telemetry", "--replicas", "2", "--parallel", "2",
        "--replica-restart-backoff-s", "0.1", "--sdc-shadow-rate", "1.0", "--rollout-drain-s", "120",
        "--fleet-min-replicas", "2",
        "--fleet-max-replicas", "3", "--fleet-queue-high", "2"])
    telemetry.reset()
    telemetry.enable()  # before the engines bind their instruments
    flight.RECORDER.clear()
    # the schedulers and the orchestrator bind the plan once: installed
    # first, every rule at count 0 (never) until armed below
    plan = faults.install(faults.parse("engine.sdc:kind=corrupt,row=1,count=0;"
                                       "server.rollout:kind=corrupt,row=1,count=0"))
    sdc_rule, rollout_rule = plan.rules
    t0 = time.perf_counter()
    engine, tokenizer, _ = make_engine(args)
    state = server_api.ApiState(engine, tokenizer, Sampler(vocab_size=engine.cfg.vocab_size, temperature=0.0,
                                                           topp=0.9, seed=1), args,
                                engine_factory=lambda: make_engine(args)[0])
    del engine  # the pool's reference only

    def factory_for_path(path):  # POST /admin/rollout's "weights", as make_server installs it
        a = copy.copy(args)
        a.model = path
        return lambda: make_engine(a)[0]

    state.make_engine_for_path = factory_for_path
    shadow_rate, state.shadow_rate = state.shadow_rate, 0.0  # --sdc-shadow-rate 1.0: on in 12b only
    server, _ = server_api.make_server(args, state=state)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    pool, adm = state.pool, state.admission
    cublas_ws: list[int] = []  # bytes of cuBLAS workspaces freed at each memory reading

    def replica_memory() -> int:
        """Card memory the replicas hold: collected, and without the cuBLAS
        workspaces, which each new thread that runs a matmul adds and which
        belong to no replica (the level after boot otherwise rises with the
        most threads ever at work: +0.25 GB by 12d, PR 12 call 3)."""
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        m = torch.cuda.memory_allocated()
        cublas_ws.append(before - m)
        return m

    mem_boot = replica_memory()
    print(f"12: 2 replicas x 2 lanes up in {time.perf_counter() - t0:.1f} s, card memory {mem_boot / 1e9:.2f} GB "
          "allocated after boot")
    captured: list = []  # (prompt, temperature, seed, ids, replica) per request decode
    for rep in pool.replicas:
        _capture_streams(types.SimpleNamespace(slots=rep.slots), captured, tag=f"r{rep.idx}")
    build = pool.build_replica

    def build_and_capture(idx):
        built = build(idx)
        _capture_streams(types.SimpleNamespace(slots=built[2]), captured, tag=f"r{idx}")
        return built

    pool.build_replica = build_and_capture
    probe = pool.canary_probe
    canary_s: list[float] = []  # each conclusive canary probe's wall time

    def timed_probe(rep, messages=None, tenant=None):
        t = time.perf_counter()
        res = probe(rep, messages, tenant)
        if res is not None:
            canary_s.append(time.perf_counter() - t)
        return res

    pool.canary_probe = timed_probe

    def mem_back(label: str) -> float:
        m = replica_memory()
        check(abs(m - mem_boot) <= FLEET_MEM_TOL_REL * mem_boot,
              f"{label}: card memory {m / 1e9:.3f} GB, {mem_boot / 1e9:.3f} GB after boot")
        return m / 1e9

    def wait_idle(label: str, timeout_s: float = 300.0) -> None:
        deadline = time.monotonic() + timeout_s
        while any(s.busy for s in state.slots) or adm.free_slots() != adm.n_slots:
            check(time.monotonic() < deadline, f"{label}: lanes still busy {[s.busy for s in state.slots]}")
            time.sleep(0.02)

    def pin(idx: int, busy: bool) -> None:
        """Hold (or free) replica ``idx``'s lanes, so traffic places on the other."""
        with pool._cond:
            for s in pool.replicas[idx].slots:
                s.busy = busy
            pool._cond.notify_all()

    def events(idx: int, kind: str) -> list:
        return [e for e in flight.RECORDER.snapshot()["replicas"].get(str(idx), []) if e["kind"] == kind]

    def walk(idx: int) -> list:
        return [(e["frm"], e["to"]) for e in events(idx, "state")]

    def restart_s(idx: int) -> float:
        ev = events(idx, "state")
        dead = [e["t_s"] for e in ev if e["to"] == "dead"][-1]
        return next(e["t_s"] for e in ev if e["to"] == "healthy" and e["t_s"] > dead) - dead

    def greedy(user: str, max_tokens: int, seed: int, stream: bool = True) -> dict:
        return {"messages": [{"role": "system", "content": "You are a helpful assistant."},
                             {"role": "user", "content": user}], "max_tokens": max_tokens, "temperature": 0.0,
                "seed": seed, "stream": stream}

    two_tiles = ("q40_matmul/k1_dp4a", "q40_matmul/k1_mma")
    c_phase = kernel_paths()
    try:
        # ---- 12a: the canary --------------------------------------------
        label = "12a"
        c0 = kernel_paths()
        check(pool.canary_tick() == 2 and pool.sdc_mismatches_total == 0
              and [r.integrity for r in pool.replicas] == ["ok", "ok"],
              f"{label}: the first tick on a clean pool: {pool.snapshot()}")
        # a long request on replica 1: its row shares every step of the
        # canary's probes there
        pin(0, True)
        long_sse = _open_sse(url, greedy("tell me a very long story about the sea", FLEET_LONG_TOKENS, 7))
        _read_deltas(long_sse, 1)
        pin(0, False)
        check(pool.replicas[1].active() == 1 and pool.replicas[0].active() == 0,
              f"{label}: the long request is not on replica 1: {pool.snapshot()}")
        clean = [pool.canary_tick() for _ in range(3)]
        check(clean == [2, 2, 2] and pool.sdc_mismatches_total == 0,
              f"{label}: ticks beside the long row: conclusive {clean}, {pool.sdc_mismatches_total} mismatches")
        check(pool.replicas[1].active() == 1, f"{label}: the long request ended before the corruption")
        # engine.sdc: every batched dispatch on replica 1 (the long row's
        # chunks, the probes') corrupts its weights in place again, until the
        # canary sees it. One fire (256 of one layer's 4096 norm weights,
        # x -1.73 + 0.125) went unseen by 6 ticks at 32 layers (PR 12 call 1)
        sdc_rule.count = -1
        ticks = 0
        for ticks in range(1, 13):
            pool.canary_tick()
            if pool.failovers_total:
                break
        sdc_rule.count = 0  # disarmed before the rebuilt replica's first dispatch
        ring1 = flight.RECORDER.snapshot()["replicas"].get("1", [])
        first_mismatch = next((e["seq"] for e in ring1 if e["kind"] == "canary" and e["verdict"] == "mismatch"), None)
        fires = sum(1 for e in ring1 if e["kind"] == "fault_fire" and e["site"] == "engine.sdc"
                    and (first_mismatch is None or e["seq"] < first_mismatch))
        long_text, long_err = _read_rest(long_sse)
        lost = events(1, "replica_lost")
        check(pool.failovers_total == 1 and lost and lost[-1].get("corrupt") is True,
              f"{label}: {pool.failovers_total} failovers after {ticks} ticks ({fires} engine.sdc fires before the "
              f"first mismatch), loss events {lost}")
        check(("healthy", "suspect") in walk(1) and any(to == "dead" for _, to in walk(1)),
              f"{label}: replica 1's walk {walk(1)}")
        check(long_err == "replica_corrupt" and pool.replayed_total == 0,
              f"{label}: the long request ended {long_err!r} after {len(long_text)} chars, replays "
              f"{pool.replayed_total}: a victim with deltas sent must end typed, never spliced")
        check(pool.wait_state(1, "healthy", timeout_s=300), f"{label}: replica 1 did not come back")
        first_restart_s = restart_s(1)
        checksums = events(1, "checksum")
        check(checksums and checksums[-1]["verdict"] == "ok", f"{label}: the rebuild's checksum {checksums}")
        check(pool.replicas[1].integrity == "unverified", f"{label}: a rebuilt replica starts unverified")
        mism = pool.sdc_mismatches_total
        check(pool.canary_tick() == 2 and pool.sdc_mismatches_total == mism
              and [r.integrity for r in pool.replicas] == ["ok", "ok"],
              f"{label}: the tick after the rebuild: {pool.snapshot()}")
        # a victim that had streamed nothing (a JSON request) replays: the
        # same corrupt loss, marked as the canary marks it
        body_b = greedy("list the planets of the solar system", FLEET_TOKENS, 8, stream=False)
        ref_b = _post_any(url, body_b)
        check(ref_b["status"] == 200, f"{label}: {ref_b}")
        wait_idle(label)
        pin(0, True)
        res_b: dict = {}
        t_b = threading.Thread(target=lambda: res_b.update(_post_any(url, body_b)))
        t_b.start()
        deadline = time.monotonic() + 120
        while not any(s.busy and s.stream.pos > 40 for s in pool.replicas[1].slots):
            check(time.monotonic() < deadline and t_b.is_alive(), f"{label}: the JSON victim never decoded")
            time.sleep(0.005)
        replays0 = pool.replayed_total
        pool.replicas[1].scheduler.mark_lost("a corrupt loss marked as the canary marks it", corrupt=True)
        pin(0, False)
        t_b.join(timeout=300)
        check(res_b.get("status") == 200 and res_b["payload"]["choices"][0]["message"]["content"]
              == ref_b["payload"]["choices"][0]["message"]["content"] and pool.replayed_total == replays0 + 1,
              f"{label}: the victim without deltas: {res_b.get('status')}, replays {pool.replayed_total}")
        check(pool.wait_state(1, "healthy", timeout_s=300), f"{label}: replica 1 did not come back")
        wait_idle(label)
        check(pool.canary_tick() == 2 and pool.sdc_mismatches_total == mism,
              f"{label}: the tick after the second rebuild: {pool.snapshot()}")
        mem_a = mem_back(label)
        moved_a = check_kernel_paths(c0, label, two_tiles)
        out[label] = {"ticks_to_dead": ticks, "fires_before_mismatch": fires, "walk": walk(1),
                      "restart_s": first_restart_s,
                      "second_restart_s": restart_s(1), "long_ended_chars": len(long_text), "mem_gb": mem_a,
                      "paths": moved_a}
        print(f"{label}: golden set; 3 ticks beside the {FLEET_LONG_TOKENS}-token row on replica 1 matched "
              f"(0 mismatches); engine.sdc on replica 1 ({fires} fires before the first mismatch): dead as corrupt "
              f"after {ticks} ticks, walk {walk(1)}; the "
              f"streaming victim ended replica_corrupt (0 replays), the JSON victim replayed equal to its "
              f"reference; rebuilds {first_restart_s:.1f} / {restart_s(1):.1f} s behind the checksum, the next "
              f"ticks matched; card memory {mem_a:.3f} GB; kernel paths {moved_a}")

        # ---- 12b: shadow votes ------------------------------------------
        label = "12b"
        state.shadow_rate = shadow_rate

        def vote_after(body) -> None:
            r = _post_any(url, body)
            check(r["status"] == 200, f"{label}: {r['status']}")
            deadline = time.monotonic() + 120
            while not state._shadow_gate.acquire(blocking=False):  # the vote in flight
                check(time.monotonic() < deadline, f"{label}: the shadow vote never ended")
                time.sleep(0.01)
            state._shadow_gate.release()

        checks0, mism = pool.sdc_checks_total, pool.sdc_mismatches_total
        for i in range(2):
            vote_after(greedy(f"shadow {i}: name three colours", 16, 20 + i, stream=False))
        check(pool.sdc_checks_total == checks0 + 2 and pool.sdc_mismatches_total == mism
              and pool.states() == ["healthy", "healthy"],
              f"{label}: votes on a clean pool: checks +{pool.sdc_checks_total - checks0}, mismatches "
              f"+{pool.sdc_mismatches_total - mism}, {pool.states()}")
        # engine.sdc again on every dispatch of replica 1, until a vote
        # diverges (~2 fires a vote; 12a's canary needed 10-14) and on until
        # the canary has seen it too: a vote's prompt may change where the
        # canary's does not yet (PR 12 call 5), and a matching probe clears
        # the suspect replica
        sdc_rule.count = -1
        votes = 0
        for votes in range(1, 17):
            vote_after(greedy(f"shadow {votes + 1}: name three colours", 16, 21 + votes, stream=False))
            if pool.sdc_mismatches_total > mism:
                break
        state.shadow_rate = 0.0
        shadows = events(0, "shadow") + events(1, "shadow")
        check(pool.sdc_mismatches_total == mism + 1 and pool.states() == ["suspect", "suspect"] and len(shadows) == 2,
              f"{label}: {votes} votes after engine.sdc: mismatches +{pool.sdc_mismatches_total - mism}, "
              f"{pool.states()}, shadow events {shadows}")
        fo = pool.failovers_total
        for ticks in range(1, 13):
            pool.canary_tick()
            if pool.failovers_total > fo:
                break
        sdc_rule.count = 0
        check(pool.failovers_total == fo + 1 and pool.replicas[0].state == "healthy"
              and pool.replicas[0].integrity == "ok", f"{label}: the canary did not resolve the vote: {pool.snapshot()}")
        check(pool.wait_state(1, "healthy", timeout_s=300), f"{label}: replica 1 did not come back")
        mism = pool.sdc_mismatches_total
        check(pool.canary_tick() == 2 and pool.sdc_mismatches_total == mism, f"{label}: the tick after the rebuild")
        mem_b = mem_back(label)
        out[label] = {"votes_to_diverge": votes, "resolve_ticks": ticks, "restart_s": restart_s(1), "mem_gb": mem_b}
        print(f"{label}: 2 greedy requests, 2 shadow votes agreed; with engine.sdc on replica 1 vote {votes} "
              f"diverged and both turned suspect; the canary cleared replica 0 and killed replica 1 in {ticks} ticks; "
              f"rebuilt in {restart_s(1):.1f} s; card memory {mem_b:.3f} GB")

        # ---- 12c: rollout, then a corrupt rollout -----------------------
        label = "12c"
        c0 = kernel_paths()
        v1, v2 = workdir / "fleet_v1.m", workdir / "fleet_v2.m"
        os.link(model, v1)  # the same bytes under a new version, no 3.9 GB write
        os.link(model, v2)
        bodies = [greedy(f"{c} rollout: tell me a story", FLEET_TOKENS, 70 + i) for i, c in enumerate("ABCD")]
        n0 = len(captured)
        ref = _concurrent(url, bodies)
        check(all(r["status"] == 200 and _sse_text(r["payload"])[1] is None for r in ref),
              f"{label}: the reference round {[r['status'] for r in ref]}")
        ref_ids = {c[2]: c[3] for c in captured[n0:]}
        wait_idle(label)
        n1 = len(captured)
        sses: list = [None] * len(bodies)
        openers = [threading.Thread(target=lambda i=i: sses.__setitem__(i, _open_sse(url, bodies[i])))
                   for i in range(len(bodies))]
        for t in openers:
            t.start()
        for t in openers:
            t.join()
        check(all(sses), f"{label}: a stream did not open")
        firsts = [_read_deltas(sse, 1) for sse in sses]
        torch.cuda.reset_peak_memory_stats()
        res_r: dict = {}
        t_r = threading.Thread(target=lambda: res_r.update(r=_post_admin(url, {"version": "v1", "weights": str(v1)})))
        t_r.start()
        rests = [_read_rest(sse) for sse in sses]
        t_r.join(timeout=900)
        peak = torch.cuda.max_memory_allocated()
        status, resp = res_r["r"]
        check(status == 200 and resp.get("moved") == 2, f"{label}: POST /admin/rollout {status} {resp}")
        check(all(r[1] is None for r in rests) and [f + r[0] for f, r in zip(firsts, rests)]
              == [_sse_text(r["payload"])[0] for r in ref], f"{label}: a stream failed or changed across the rollout")
        runs: dict = {}
        for c in captured[n1:]:
            runs.setdefault(c[2], []).append(c[3])
        check(all(runs.get(b["seed"], [None])[-1] == ref_ids[b["seed"]] for b in bodies),
              f"{label}: a stream's tokens differ from its pre-rollout run")
        moves = [dict(m) for m in state.rollout.last_moves]
        metrics = _scrape(url)
        gauge = {k: v for k, v in metrics.items() if k.startswith("dllama_weights_version")}
        check(gauge.get('dllama_weights_version{version="v1"}') == 1.0
              and gauge.get('dllama_weights_version{version="v0"}') == 0.0
              and [r.weights_version for r in pool.replicas] == ["v1", "v1"]
              and [r.integrity for r in pool.replicas] == ["ok", "ok"] and pool.rollout_moves_total == 2,
              f"{label}: after the rollout: {pool.snapshot()}, gauge {gauge}")
        mem_r = mem_back(label + " rollout")
        wait_idle(label)
        # the corrupt rollout: replica 0 moves, replica 1's new engine is
        # perturbed before the checksum gate, everything rolls back to v1
        rollout_rule.count = 1
        torch.cuda.reset_peak_memory_stats()
        status, resp = _post_admin(url, {"version": "v2", "weights": str(v2)})
        peak_abort = torch.cuda.max_memory_allocated()
        check(status == 500 and resp["error"]["type"] == "rollout_aborted" and resp.get("rollout") == {"active": False},
              f"{label}: the corrupt rollout answered {status} {resp}")
        check(pool.weights_version == "v1" and [r.weights_version for r in pool.replicas] == ["v1", "v1"]
              and pool.rollout_aborts_total == 1 and "v2" not in pool.weights_reference
              and "v2" not in pool._canary_goldens, f"{label}: after the abort: {pool.snapshot()}")
        abort_moves = [dict(m) for m in state.rollout.last_moves]
        mem_abort = mem_back(label + " rollback")
        mism = pool.sdc_mismatches_total
        check(pool.canary_tick() == 2 and pool.sdc_mismatches_total == mism, f"{label}: the tick after the rollback")
        moved_c = check_kernel_paths(c0, label, two_tiles)
        out[label] = {"moves": moves, "peak_gb": peak / 1e9, "mem_gb": mem_r, "abort_moves": abort_moves,
                      "abort_peak_gb": peak_abort / 1e9, "abort_mem_gb": mem_abort, "paths": moved_c}
        per_move = "; ".join(f"replica {m['replica']}: drain {m.get('drain_s', 0):.2f} s, rebuild "
                             f"{m.get('rebuild_s', 0):.2f} s, certify {m.get('certify_s', 0):.2f} s" for m in moves)
        print(f"{label}: rollout to v1 (a hard link of the boot file) under 4 streams: 200, both replicas moved "
              f"({per_move}), 0 failed requests, every stream equal to its pre-rollout run token for token; "
              f"dllama_weights_version v1=1 v0=0; peak card memory {peak / 1e9:.2f} GB during the moves, "
              f"{mem_r:.3f} GB after (boot {mem_boot / 1e9:.3f}); the server.rollout corrupt rollout to v2: 500 "
              f"rollout_aborted, moves {abort_moves}, both replicas back on v1, peak {peak_abort / 1e9:.2f} GB, "
              f"{mem_abort:.3f} GB after; kernel paths {moved_c}")

        # ---- 12d: the fleet controller ----------------------------------
        label = "12d"
        c0 = kernel_paths()
        ctl = state.fleet
        check(ctl.min_replicas == 2 and ctl.max_replicas == 3 and adm.n_slots == 4, f"{label}: controller {vars(ctl)}")

        def rate_body(i):
            return greedy(f"rate {i} tell me a story", RATE_TOKENS, 60 + i)

        rate2 = _decode_rate(url, [rate_body(i) for i in range(4)])
        wait_idle(label)
        burst = [greedy(f"burst {i}: tell me a story", FLEET_TOKENS, 90 + i) for i in range(FLEET_BURST)]
        res_burst: list = []
        t_burst = threading.Thread(target=lambda: res_burst.extend(_concurrent(url, burst)))
        t_burst.start()
        deadline = time.monotonic() + 120
        while adm.waiting() < ctl.queue_high:
            check(time.monotonic() < deadline, f"{label}: the burst never queued")
            time.sleep(0.005)
        tick1 = ctl.tick()
        t_grow = time.perf_counter()
        tick2 = ctl.tick()
        grow_s = time.perf_counter() - t_grow
        check(tick1 is None and tick2 == "up" and len(pool.replicas) == 3 and adm.n_slots == 6,
              f"{label}: ticks {tick1}, {tick2}: {len(pool.replicas)} replicas, {adm.n_slots} permits")
        t_burst.join(timeout=900)
        check(len(res_burst) == FLEET_BURST and all(r["status"] == 200 for r in res_burst),
              f"{label}: the burst {[r['status'] for r in res_burst]}")
        on_grown = sum(1 for c in captured if c[4] == "r2")
        wait_idle(label)
        rate3 = _decode_rate(url, [rate_body(i) for i in range(6)])
        wait_idle(label)
        grown = weakref.ref(pool.replicas[2].engine)
        ticks = [ctl.tick() for _ in range(ctl.down_ticks)]
        check(ticks == [None] * (ctl.down_ticks - 1) + ["down"] and len(pool.replicas) == 2 and adm.n_slots == 4
              and adm.free_slots() == 4, f"{label}: idle ticks {ticks}: {len(pool.replicas)} replicas, "
              f"{adm.n_slots} permits, {adm.free_slots()} free")
        check(all(ctl.tick() is None for _ in range(ctl.down_ticks + 1)) and len(pool.replicas) == 2,
              f"{label}: shrank below --fleet-min-replicas")
        gc.collect()
        check(grown() is None, f"{label}: the retired replica's engine is still referenced")
        mem_d = mem_back(label)
        moved_d = check_kernel_paths(c0, label, two_tiles)
        out[label] = {"grow_s": grow_s, "rate_2x2": rate2, "rate_3x2": rate3, "burst_on_grown": on_grown,
                      "scale_events": dict(ctl.scale_events), "mem_gb": mem_d, "paths": moved_d}
        print(f"{label}: a burst of {FLEET_BURST} queued; the second pressure tick grew replica 2 in {grow_s:.1f} s "
              f"(permits 4 -> 6; {on_grown} burst requests decoded on it); {ctl.down_ticks} idle ticks retired it "
              f"(permits 6 -> 4, its engine freed); aggregate decode {rate2['tok_s']:.1f} tok/s at 2 replicas x 2 "
              f"rows, {rate3['tok_s']:.1f} at 3 x 2; card memory {mem_d:.3f} GB; kernel paths {moved_d}")

        moved = check_kernel_paths(c_phase, "12", two_tiles)
        lat_p50 = statistics.median(canary_s)
        hist = _scrape(url)
        out.update(boot_gb=mem_boot / 1e9, cublas_workspace_gb=[b / 1e9 for b in cublas_ws],
                   canary_p50_s=lat_p50, canary_probes=len(canary_s),
                   canary_hist_count=hist.get("dllama_canary_latency_seconds_count"), paths=moved)
        print(f"12: {len(canary_s)} conclusive canary probes, dllama_canary_latency_seconds p50 {lat_p50 * 1e3:.1f} "
              f"ms (histogram count {hist.get('dllama_canary_latency_seconds_count')}); cuBLAS workspaces freed at "
              f"each memory reading {[round(b / 2**20) for b in cublas_ws]} MiB; kernel paths over the phase {moved}")
    finally:
        faults.clear()
        server.shutdown()
        server.server_close()
        state.close()
        del state, pool
        gc.collect()
        torch.cuda.empty_cache()
        telemetry.disable()
        telemetry.reset()
        for f in (workdir / "fleet_v1.m", workdir / "fleet_v2.m"):
            if f.exists():
                f.unlink()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _post_admin(url: str, body: dict) -> tuple[int, dict]:
    """POST /admin/rollout: (status, the JSON body)."""
    req = urllib.request.Request(url + "/admin/rollout", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def fleet_only(smi: str) -> None:
    """``--fleet``: phase 2, phase 5's 7B-width files and phase 12 alone."""
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.ops import cuda_build
    from distributed_llama_tpu_torch.server import api as server_api

    phase("2. build kernels")
    print(f"nvcc build: {cuda_build.build():.1f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = time.perf_counter()
        model, tok = write_7b_files(synthetic, write_tokenizer_file, Path(tmp))
        print(f"wrote the 7B-width files in {time.perf_counter() - t:.1f} s")
        t = phase(f"12. the slice's path: the SDC canary, shadow votes, rollout and the fleet controller in the API "
                  f"server, {N_LAYERS} layers")
        summary = {"fleet": fleet_phase(server_api, model, tok, smi, Path(tmp))}
        print(f"phase 12: {time.perf_counter() - t:.1f} s")
    (ROOT / "build" / "chip_smoke_fleet.json").write_text(json.dumps(summary, indent=1, default=str))
    print(f"card: {smi}")


def write_7b_files(synthetic, write_tokenizer_file, workdir: Path, n_layers: int = N_LAYERS) -> tuple[str, str]:
    """A random-Q40 `.m` at Llama-2-7B width (``n_layers`` layers, blocks
    from seed 0) and a tokenizer padded to its vocab."""
    spec = synthetic.llama2_7b_spec(n_layers=n_layers, seq_len=4096)
    model = str(workdir / "llama2_7b_width.m")
    synthetic.write_random_q40_model(model, spec, seed=0)
    tok = str(workdir / "tok.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=spec.vocab_size))
    return model, tok


def moe_phases(cli, moe, q40, attn, kvc, llama, server_api, synthetic, write_tokenizer_file, workdir: Path,
               summary: dict, after_8c=None) -> None:
    """Phase 8: K1 and K3 at the expert shapes, then the CLI and the
    batched server over Mixtral-8x7B widths and the CLI over Grok-1 widths,
    each `.m` written under ``workdir`` and deleted at the end of its phase
    (``after_8c(model, tok)`` runs over the Mixtral-width files first).
    Results go into ``summary``."""
    t = phase("8a. K1 and K3 vs their plain versions at the Mixtral-8x7B and Grok-1 expert shapes")
    k1_rows = k1_checks(q40, shapes=MOE_SHAPES, ts=MOE_TS)
    k3_rows = k3_checks(q40, shapes=MOE_SHAPES, ts=MOE_TS)
    summary.update(moe_kernel_rows=k1_rows + k3_rows)
    print(f"phase 8a: {time.perf_counter() - t:.1f} s")

    t = phase(f"8b. the slice's path: CLI generate at Mixtral-8x7B width, {MIXTRAL_LAYERS} layers")
    spec = synthetic.mixtral_8x7b_spec(n_layers=MIXTRAL_LAYERS, seq_len=4096)
    model = str(workdir / "mixtral_8x7b_width.m")
    synthetic.write_random_q40_model(model, spec, seed=0)
    tok = str(workdir / "tok_mixtral.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=spec.vocab_size))
    print(f"wrote {os.path.getsize(model) / 1e9:.2f} GB .m in {time.perf_counter() - t:.1f} s")
    greedy = ["--prompt", "hello world, hello", "--temperature", "0", "--seed", "1"]
    sampled = ["--prompt", "hello hello world", "--temperature", "0.8", "--topp", "0.9", "--seed", "42"]
    summary["mixtral_cli"] = moe_cli(cli, moe, q40, model, tok, [
        ("greedy", "int8", greedy), ("greedy again", "int8", greedy),
        ("sampled", "int8", sampled), ("sampled again", "int8", sampled),
        ("greedy f32 path", "f32", greedy), ("greedy spec 4", "int8", greedy + ["--spec-draft", "4"]),
    ], capacity_prompt="the quick brown fox jumps over the lazy dog, " * 2)
    print(f"phase 8b: {time.perf_counter() - t:.1f} s")

    t = phase(f"8c. the slice's path: the API server over Mixtral-8x7B width, --parallel 4, prefix cache, "
              f"{MIXTRAL_LAYERS} layers (bf16, then int8 cache)")
    for key, extra in (("mixtral_server", ()), ("mixtral_server_i8", ("--cache-dtype", "i8"))):
        summary[key] = server_run(server_api, attn, kvc, llama, model, tok, q40, extra=extra, single_stream=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 8c: {time.perf_counter() - t:.1f} s")
    if after_8c is not None:
        after_8c(model, tok)
    os.remove(model)

    t = phase(f"8d. the slice's path: CLI generate at Grok-1 width, {GROK_LAYERS} layers")
    spec = synthetic.grok1_spec(n_layers=GROK_LAYERS, seq_len=4096)
    model = str(workdir / "grok1_width.m")
    synthetic.write_random_q40_model(model, spec, seed=0)
    tok = str(workdir / "tok_grok.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=spec.vocab_size))
    print(f"wrote {os.path.getsize(model) / 1e9:.2f} GB .m in {time.perf_counter() - t:.1f} s")
    summary["grok_cli"] = moe_cli(cli, moe, q40, model, tok, [
        ("greedy", "int8", greedy), ("greedy again", "int8", greedy), ("sampled", "int8", sampled),
        ("greedy f32 path", "f32", greedy),
    ])
    os.remove(model)
    print(f"phase 8d: {time.perf_counter() - t:.1f} s")


def moe_only(smi: str) -> None:
    """``--moe``: phase 2, phase 4's MoE part and phase 8 alone."""
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.engine import InferenceEngine
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.models import llama, moe
    from distributed_llama_tpu_torch.ops import attention as attn
    from distributed_llama_tpu_torch.ops import cuda_build, q40
    from distributed_llama_tpu_torch.ops import kv_cache as kvc
    from distributed_llama_tpu_torch.server import api as server_api

    t = phase("2. build kernels")
    print(f"nvcc build: {cuda_build.build():.1f} s")
    summary: dict = {"card": smi}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t = phase("4. small MoE models: card vs CPU")
        summary["small_moe"] = small_moe_check(synthetic, InferenceEngine, moe, q40, Path(tmp))
        print(f"phase 4 (MoE): {time.perf_counter() - t:.1f} s")
        moe_phases(cli, moe, q40, attn, kvc, llama, server_api, synthetic, write_tokenizer_file, Path(tmp), summary)
    out = ROOT / "build" / "chip_smoke_moe.json"
    out.write_text(json.dumps(summary, indent=1))
    print(f"card: {smi}")


# ----------------------------------------------------------------------
# Phase 13: a Hugging Face checkpoint converted on the card machine, chat
# on it, and Mixtral-8x7B width under --tp
# ----------------------------------------------------------------------


def convert_phase(synthetic, workdir: Path) -> dict:
    """Phase 13a: a synthetic F16 Hugging Face checkpoint at Llama-2-7B width
    (LLAMA2_7B_HF_CONFIG cut to CHAT_LAYERS layers, two safetensors files
    with an index) and a 32000-token ``tokenizer.json``, converted by the
    port's converter programs (``python -m ...converter.hf`` to Q40, and
    ``...converter.tokenizers hf``); the `.m` must equal, byte for byte,
    the file ``ModelFileWriter`` writes directly from the `.m`-layout
    tensors the checkpoint was made from (written meanwhile, in this
    process)."""
    from distributed_llama_tpu_torch.converter import hf as conv_hf
    from distributed_llama_tpu_torch.formats.model_file import ModelFileWriter
    from distributed_llama_tpu_torch.quants import FloatType
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    config = {**LLAMA2_7B_HF_CONFIG, "num_hidden_layers": CHAT_LAYERS}
    spec = conv_hf.spec_from_hf_config(config, FloatType.Q40)
    tensors = synthetic.random_f16_tensors(spec, seed=0)
    ckpt = workdir / "hf_llama2_7b_width"
    files = synthetic.write_hf_checkpoint(str(ckpt), spec, tensors, config, n_files=2)
    synthetic.write_hf_tokenizer(str(ckpt), spec.vocab_size)
    ckpt_bytes = sum(os.path.getsize(f) for f in files)
    write_s = time.perf_counter() - t0
    print(f"wrote a {ckpt_bytes / 1e9:.3f} GB F16 checkpoint ({len(files)} safetensors files + index, "
          f"{CHAT_LAYERS} layers at Llama-2-7B width) and a {spec.vocab_size}-token tokenizer.json in {write_s:.1f} s")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    name = "llama2_7b_width"
    ended: dict = {}  # converter -> (seconds, output)

    def run(kind: str, argv: list) -> threading.Thread:
        """The converter program ``kind`` started; its thread ends with it."""
        started = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", f"distributed_llama_tpu_torch.converter.{kind}", *argv],
                                cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def wait():
            output = proc.communicate(timeout=900)[0]
            ended[kind] = (time.perf_counter() - started, output, proc.returncode)

        waiter = threading.Thread(target=wait, daemon=True)
        waiter.start()
        return waiter

    waiters = {"hf": run("hf", [str(ckpt), "q40", name]), "tokenizers": run("tokenizers", ["hf", str(ckpt), name])}
    # meanwhile the same tensors written directly
    direct = workdir / "direct.m"
    t_direct = time.perf_counter()
    with open(direct, "wb") as f:
        writer = ModelFileWriter(f, spec)
        for e in list(writer.remaining()):
            writer.write_tensor(tensors[e.name].astype(np.float32), e.name)
        writer.finish()
    direct_s = time.perf_counter() - t_direct
    del tensors
    for kind, waiter in waiters.items():
        waiter.join()
        check(ended[kind][2] == 0, f"the {kind} converter failed:\n{ended[kind][1][-2000:]}")
    seconds = {kind: e[0] for kind, e in ended.items()}
    model, tok = workdir / f"dllama_model_{name}_q40.m", workdir / f"dllama_tokenizer_{name}.t"
    model_bytes = os.path.getsize(model)
    same = filecmp.cmp(model, direct, shallow=False)
    check(same, "13a: the converted .m differs from ModelFileWriter's direct write of the same tensors")
    tokenizer = Tokenizer.from_file(str(tok), spec.vocab_size)
    print(f"converter.hf: {seconds['hf']:.1f} s for {ckpt_bytes / 1e9:.3f} GB of F16 in "
          f"({ckpt_bytes / 1e9 / seconds['hf']:.3f} GB/s) and {model_bytes / 1e9:.3f} GB of .m out "
          f"({model_bytes / 1e9 / seconds['hf']:.3f} GB/s); the direct write {direct_s:.1f} s; "
          f"converter.tokenizers: {seconds['tokenizers']:.1f} s ({tokenizer.vocab_size} tokens, chat eos "
          f"{tokenizer.chat_eos_id}); the .m equals the direct write byte for byte")
    os.remove(direct)
    for f in files:
        os.remove(f)  # the tokenizer files stay: 13b converts them again
    return dict(checkpoint_bytes=ckpt_bytes, model_bytes=model_bytes, write_s=write_s, convert_s=seconds["hf"],
                convert_in_gb_per_s=ckpt_bytes / 1e9 / seconds["hf"],
                convert_out_gb_per_s=model_bytes / 1e9 / seconds["hf"], direct_write_s=direct_s,
                tokenizer_s=seconds["tokenizers"], byte_equal=same, model=str(model), tok=str(tok),
                tokenizer_dir=str(ckpt))


def kv_divergence_explained(chat_cache: list, ref_cache: list, n: int, fed: range) -> bool:
    """Whether a chat's KV cache and one written by a single prefill of the
    same n tokens part only as the decode/prefill attention order predicts
    (ROADMAP Queue 3): one query row and a bucket of rows sum the full-S
    attention's einsums in another order, and an ulp there can move one Q80
    rounding of the next layer's input at a row the chat's decode steps
    wrote (``fed``). So: layer 0's rows are all equal (its input is the
    embedding); no layer differs before the first differing layer's first
    row; that layer is layer 1 or later and differs only at ``fed`` rows;
    and there every 32-element block of the row differs from the
    reference's by at most one Q80 step of that block (its max |value| /
    127). A wrong KV row fails one of these."""
    first, first_bad = None, None
    for l, (a, b) in enumerate(zip(chat_cache, ref_cache)):
        d = (a[:, :n].float() - b[:, :n].float()).abs().amax(dim=(0, 2, 3))
        bad = torch.nonzero(d).flatten().tolist()
        print(f"  layer {l}: KV rows differ at {len(bad)} of {n} positions, the first {bad[:1]} "
              f"(the chat's decode steps wrote {fed.start}-{fed.stop - 1}), max abs diff {float(d.max()):.3e}")
        if bad and first is None:
            first, first_bad = l, bad
    if first is None:
        return False
    lowest = min(first_bad)
    earlier = [l for l, b in enumerate(ref_cache)
               if not torch.equal(chat_cache[l][:, :lowest], b[:, :lowest])]
    a, b = chat_cache[first][:, first_bad].float(), ref_cache[first][:, first_bad].float()
    hd = b.shape[-1]
    blocks = (-1, 32) if hd % 32 == 0 else (-1, hd)
    diff = (a - b).abs().reshape(*b.shape[:-1], *blocks)
    step = b.abs().reshape(*b.shape[:-1], *blocks).amax(dim=-1, keepdim=True) / 127
    ratio = float((diff / step.clamp(min=torch.finfo(torch.float32).tiny)).max())
    ok = first >= 1 and not earlier and all(p_ in fed for p_ in first_bad) and ratio <= 1.0
    print(f"  first differing layer {first} at rows {first_bad}; layers differing before row {lowest}: "
          f"{earlier}; largest diff there {ratio:.3e} of its block's Q80 step: "
          f"{'the decode/prefill order' if ok else 'NOT the decode/prefill order'}")
    return ok


def chat_phase(cli, q40, telemetry, conv: dict, workdir: Path) -> dict:
    """Phase 13b: ``chat`` on the converted model. A greedy probe of the
    first turn picks the EOS token (a token of the reply from CHAT_STOP_AT
    on: random weights emit no EOS of their own) and the tokenizer is
    converted again with it; then the CLI's ``chat`` reads CHAT_LINES from stdin,
    greedy, under ``--decode device``, ``--decode device --spec-draft 4`` and
    ``--decode host``. Gates: every mode gives the same turns; turn 2's
    reply equals one prefill of its whole token history followed by the
    plain chunked decode; ``generate_on_device`` equals ``generate_chunks``
    for the same first token and seed; K1 launched in both tiles and no
    ``plain`` path."""
    import contextlib
    import io

    from distributed_llama_tpu_torch.converter.tokenizers import convert_hf_tokenizer
    from distributed_llama_tpu_torch.tokenizer import ChatItem, ChatTemplate, Sampler, Tokenizer, chat_stops

    def args(*extra):
        return cli.build_parser().parse_args([
            "chat", "--model", conv["model"], "--tokenizer", conv["tok"], "--dtype", "q40",
            "--max-seq-len", str(CHAT_SEQ_LEN), "--temperature", "0", "--seed", "1", "--decode-chunk", "16",
            *extra])

    t_load = time.perf_counter()
    engine, tok, _ = cli.make_engine(args())
    torch.cuda.synchronize()
    out: dict = {"load_s": time.perf_counter() - t_load}
    template = ChatTemplate("unknown", tok.chat_template, chat_stops(tok)[0])
    prompt = tok.encode(template.generate([ChatItem("system", CHAT_LINES[0]), ChatItem("user", CHAT_LINES[1])]),
                        add_bos=True)
    engine.reset()
    first = int(engine.prefill(prompt).argmax())
    greedy = [first] + engine.generate_on_device(first, 4 * CHAT_STOP_AT).tolist()
    # generate_on_device (one dispatch) against generate_chunks, sampled
    got = {}
    for run in ("on_device", "chunks"):
        s = engine.new_stream()
        s.prefill(prompt)
        if run == "on_device":
            got[run] = s.generate_on_device(first, 16, 0.8, seed=5).tolist()
        else:
            gen = s.generate_chunks(first, 0.8, 0.9, seed=5, chunk=4, limit=s.pos + 16)
            got[run] = [next(gen) for _ in range(16)]
            gen.close()
        del s
    check(got["on_device"] == got["chunks"],
          f"13b: generate_on_device {got['on_device']} != generate_chunks {got['chunks']}")
    print(f"generate_on_device == generate_chunks for 16 sampled tokens (temperature 0.8, seed 5): {got['on_device']}")
    # random weights emit no EOS: the checkpoint's EOS becomes the first
    # token id of the first turn's greedy reply, from CHAT_STOP_AT on, that
    # the reply has not emitted before (else the one at CHAT_STOP_AT), so
    # that turn ends there; the tokenizer is converted again with it
    i = next((j for j in range(CHAT_STOP_AT, len(greedy)) if greedy[j] not in greedy[:j]), CHAT_STOP_AT)
    eos = tok.vocab[greedy[i]].decode("utf-8")
    cfg_path = Path(conv["tokenizer_dir"]) / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg_path.write_text(json.dumps({**cfg, "eos_token": eos}))
    chat_tok = str(workdir / "chat.t")
    data = convert_hf_tokenizer(conv["tokenizer_dir"], chat_tok)
    check(data.chat_eos_id == greedy[i], f"13b: the converted chat eos {data.chat_eos_id} != {greedy[i]}")
    print(f"first turn's greedy reply {greedy}; the tokenizer converted again with eos_token {eos!r} "
          f"(id {greedy[i]}, reply token {i})")

    telemetry.reset()
    telemetry.enable()
    q40.reset_launches()
    sessions = {}
    try:
        for label, extra in (("device", []), ("device --spec-draft 4", ["--spec-draft", "4"]),
                             ("host", ["--decode", "host"])):
            engine.reset()
            built = (engine, Tokenizer.from_file(chat_tok, engine.cfg.vocab_size),
                     Sampler(vocab_size=engine.cfg.vocab_size, temperature=0.0, topp=0.9, seed=1))
            stdin, sys.stdin = sys.stdin, io.StringIO("\n".join(CHAT_LINES) + "\n")
            printed = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(printed):
                    session = cli.chat(args(*extra), built=built)
            finally:
                sys.stdin = stdin
            wall_s = time.perf_counter() - t0
            turns = session["turns"]
            sessions[label] = session
            check(len(turns) >= 2 and turns[0]["end"] == "eos",
                  f"13b {label}: {len(turns)} turns, the first ended {turns[0]['end'] if turns else None}")
            print(f"chat {label}: {len(turns)} turns in {wall_s:.2f} s; " + "; ".join(
                f"turn {j + 1}: {len(t['prompt_tokens'])} prompt tokens, {len(t['tokens'])} reply tokens, "
                f"{t['ms']:.0f} ms ({t['end']})" for j, t in enumerate(turns))
                + f"; printed {printed.getvalue().count(chr(10))} lines")
        paths = kernel_paths()
    finally:
        telemetry.disable()
        telemetry.reset()
    key = [[(t["prompt_tokens"], t["tokens"], t["end"]) for t in s["turns"]] for s in sessions.values()]
    check(all(k == key[0] for k in key), "13b: the decode modes gave different turns")
    tiles = dict(q40.tile_launches)
    print(f"K1 launches over the three chats by tile {tiles}; kernel paths {paths}")
    check(tiles["dp4a"] > 0 and tiles["mma"] > 0, f"13b: a K1 tile was not launched: {tiles}")
    check(not any(k.endswith("/plain") for k in paths), f"13b: a plain path ran: {paths}")
    # turn 2 against one prefill of its whole token history
    t1, t2 = sessions["device"]["turns"][:2]
    history = t1["prompt_tokens"] + t1["tokens"][:-1] + t2["prompt_tokens"]
    s = engine.new_stream()
    first_dev = s.prefill_device(history, 0.0, 0.9, seed=1)
    want = []
    s.stream_decode(first_dev, lambda p, t: want.append(t) or len(want) < len(t2["tokens"]), 0.0, 0.9, seed=1,
                    chunk=16, limit=CHAT_SEQ_LEN, first_prev=history[-1])
    same = next((j for j, (a, b) in enumerate(zip(want, t2["tokens"])) if a != b), min(len(want), len(t2["tokens"])))
    print(f"turn 2 ({len(history)} tokens of history, {len(t2['tokens'])} reply tokens): {same} equal to one "
          f"prefill of the history + stream_decode before the first difference")
    explained = None
    if want != t2["tokens"]:
        explained = kv_divergence_explained(engine.default_stream.cache, s.cache, len(history), range(
            len(t1["prompt_tokens"]), len(t1["prompt_tokens"]) + len(t1["tokens"]) - 1))
        lg = engine.new_stream().forward(history + want[:same])[-1]
        top2 = np.sort(lg)[-2:]
        gap = float((top2[1] - top2[0]) / np.abs(lg).max())
        print(f"  the reference's top-2 logit gap at token {same}: {gap:.3e} of max |logit| "
              f"({'a near-tie' if gap < TP_LOGIT_TOL else 'NOT a near-tie'}: the bound is {TP_LOGIT_TOL})")
        explained = explained and gap < TP_LOGIT_TOL
        print(f"  {'explained' if explained else 'NOT explained'}")
    check(want == t2["tokens"] or explained,
          f"13b: turn 2's reply {t2['tokens']} != one prefill + stream_decode {want}")
    out.update(turn2_equal_tokens=same, turn2_divergence_explained=explained, eos_id=greedy[i],
               greedy_probe=greedy, generate_on_device=got["on_device"], k1_tiles=tiles,
               kernel_paths=paths, turns={lab: [{k: v for k, v in t.items() if k != "prompt_tokens"}
                                                for t in s_["turns"]] for lab, s_ in sessions.items()})
    del engine, s
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_tp_phase(cli, moe, q40, coll, llama, telemetry, model: str, tok: str) -> dict:
    """Phase 13c: the Mixtral-8x7B-width `.m` (MIXTRAL_LAYERS layers) through
    the CLI at ``--tp 1``, then ``--tp 2`` and ``--tp 4`` with the ranks on
    the card, each under ``--allreduce psum`` and ``ring``, ``--moe-capacity
    2.0``. Gates, per run against tp = 1: the expert ids of every layer and
    step (compared first), then MOE_TP_TOKENS greedy tokens; one expert-id
    host read per layer per decoded token; K1's dp4a tile launched, under
    ring K4 (the expert sum) and K5 (wo), and no plain path; every rank's
    residual stream byte-identical after the prompt; the bucketed prefill of
    a long prompt on every rank of every layer, its logits within
    TP_LOGIT_TOL of max |logit| of tp = 1's. Then
    ms/token and device busy ms/token per tp."""
    prompt = "hello world, hello"
    long_prompt = "the quick brown fox jumps over the lazy dog, " * 2

    def args(tp, impl):
        return cli.build_parser().parse_args([
            "generate", "--model", model, "--tokenizer", tok, "--dtype", "q40", "--decode", "device",
            "--max-seq-len", str(SEQ_LEN), "--steps", str(MOE_TP_TOKENS + 16), "--decode-chunk", "8",
            "--temperature", "0", "--seed", "1", "--prompt", prompt, "--tp", str(tp), "--allreduce", impl,
            "--moe-capacity", "2.0"])

    out: dict = {}
    ref = ref_long = None
    orig_route, orig_mix = moe._route_topk, moe._mix_buckets
    telemetry.reset()
    telemetry.enable()
    try:
        for tp in (1, *TP_SIZES):
            t_load = time.perf_counter()
            built = cli.make_engine(args(tp, "psum"))
            engine = built[0]
            torch.cuda.synchronize()
            L = engine.cfg.n_layers
            row = dict(tp=tp, load_s=time.perf_counter() - t_load, card_gb=torch.cuda.memory_allocated() / 1e9)
            prompt_tokens = built[1].encode(prompt, add_bos=True)
            for impl in ("psum",) if tp == 1 else ("psum", "ring"):
                if engine.tp_backend is not None:
                    engine.tp_backend.allreduce = impl
                label = f"tp={tp} {impl}"
                engine.reset()
                coll.reset_launches()
                q40.reset_launches()
                moe.reset_host_reads()
                paths0 = kernel_paths()
                ids: list = []
                margins: list = []

                def spy(cfg, xn, router):
                    vals, got = orig_route(cfg, xn, router)
                    ids.append(got)
                    p = torch.sort(moe.router_probs(cfg, xn, router)[0], descending=True).values
                    k = cfg.n_active_experts
                    margins.append(float(p[k - 1] - p[k]))
                    return vals, got

                moe._route_topk = spy
                stream = engine.default_stream
                f0 = stream.forwards
                try:
                    res = cli.generate(args(tp, impl), benchmark=False, built=built)
                finally:
                    moe._route_topk = orig_route
                torch.cuda.synchronize()
                forwards = stream.forwards - f0
                tokens = res["tokens"][:MOE_TP_TOKENS]
                launches = {**coll.launches, **q40.tile_launches}
                moved = {k: v - paths0.get(k, 0.0) for k, v in kernel_paths().items() if v - paths0.get(k, 0.0) > 0}
                reads = moe.host_reads["expert_ids"]
                print(f"{label}: {len(res['tokens'])} tokens in {forwards} forwards; launches {launches}; "
                      f"expert-id host reads {reads} ({L} per decode step); paths {moved}")
                check(len(tokens) == MOE_TP_TOKENS, f"13c {label}: {len(tokens)} tokens")
                check(reads == L * (forwards - 1), f"13c {label}: {reads} expert-id reads, want {L * (forwards - 1)}")
                check(launches["dp4a"] > 0, f"13c {label}: K1's dp4a tile was not launched")
                check(not any(k.endswith("/plain") for k in moved), f"13c {label}: a plain path ran: {moved}")
                if impl == "ring":
                    check(launches["ring_all_reduce"] > 0 and launches["fused_matmul_ring"] > 0,
                          f"13c {label}: K4/K5 not launched: {launches}")
                if ref is None:
                    # each greedy token's top-2 logit gap, teacher-forced, for
                    # a divergence's report
                    engine.reset()
                    lg = engine.forward(prompt_tokens + tokens[:-1])[len(prompt_tokens) - 1:]
                    top2 = -np.sort(-lg, axis=-1)[:, :2]
                    gaps = (top2[:, 0] - top2[:, 1]) / np.abs(lg).max(axis=-1)
                    ref = (ids, tokens, margins, gaps)
                    print(f"{label}: {len(ids)} router calls, smallest top-k margin {min(margins):.3e} "
                          f"(k-th minus (k+1)-th probability); smallest top-2 logit gap of the {len(tokens)} greedy "
                          f"tokens {gaps.min():.3e} of max |logit|")
                else:
                    diverged = next((j for j, (a, b) in enumerate(zip(tokens, ref[1])) if a != b), None)
                    if diverged is not None:
                        print(f"{label}: greedy token {diverged} differs from tp=1's ({tokens[diverged]} vs "
                              f"{ref[1][diverged]}); tp=1's top-2 logit gap there {ref[3][diverged]:.3e} of max "
                              f"|logit|")
                    first_id = next((j for j, (a, b) in enumerate(zip(ids, ref[0])) if a != b), None)
                    if first_id is not None:
                        print(f"{label}: expert ids differ from tp=1's first at router call {first_id} (layer "
                              f"{first_id % L}, decode step {first_id // L}): {ids[first_id]} vs {ref[0][first_id]}; "
                              f"top-k margin there {margins[first_id]:.3e} (tp=1: {ref[2][first_id]:.3e})")
                    check(len(ids) == len(ref[0]) and first_id is None,
                          f"13c {label}: expert ids differ from tp=1's at router call {first_id}")
                    check(tokens == ref[1], f"13c {label}: greedy tokens {tokens} != tp=1's {ref[1]}")
                    print(f"{label}: the expert ids of all {len(ids)} router calls and the {MOE_TP_TOKENS} greedy "
                          f"tokens equal tp=1's")
                row[impl] = dict(tokens=tokens, forwards=forwards, launches=launches, host_reads=reads,
                                 kernel_paths=moved, router_calls=len(ids))
            if tp > 1:
                caches = engine.tp_backend.init_cache(engine.cache_dtype)
                toks = torch.tensor(prompt_tokens, dtype=torch.int64, device=engine.device)
                xs, _ = llama.forward_hidden_tp(engine.cfg, engine.params, toks, caches, 0, "int8", "ring")
                check(all(torch.equal(x, xs[0]) for x in xs), f"13c tp={tp}: rank residual streams differ")
                print(f"tp={tp}: every rank's residual stream byte-identical after the prompt (ring)")
                del caches, xs
            # the capacity-bucketed prefill on every rank of every layer,
            # held against tp=1's under each all-reduce
            long_tokens = built[1].encode(long_prompt, add_bos=True)
            check(len(long_tokens) >= moe.MOE_BUCKETED_MIN_T, f"13c: the long prompt has {len(long_tokens)} tokens")
            for impl in ("psum",) if tp == 1 else ("psum", "ring"):
                if engine.tp_backend is not None:
                    engine.tp_backend.allreduce = impl
                mixed = []
                moe._mix_buckets = lambda *a, **kw: mixed.append(1) or orig_mix(*a, **kw)
                try:
                    engine.reset()
                    logits = engine.prefill(long_tokens)
                finally:
                    moe._mix_buckets = orig_mix
                check(bool(np.isfinite(logits).all()) and len(mixed) == tp * L,
                      f"13c tp={tp} {impl}: bucketed prefill ran {len(mixed)} rank-layers, want {tp * L}")
                if tp == 1:
                    ref_long = logits
                    print(f"tp=1: --moe-capacity 2.0 prefill of {len(long_tokens)} tokens bucketed on {len(mixed)} "
                          f"rank-layers, logits finite")
                    continue
                scale = float(np.abs(ref_long).max())
                err = float(np.abs(logits - ref_long).max())
                check(err <= TP_LOGIT_TOL * scale, f"13c tp={tp} {impl}: bucketed prefill logits {err:.4g} from "
                      f"tp=1's (tolerance {TP_LOGIT_TOL * scale:.4g})")
                print(f"tp={tp} {impl}: --moe-capacity 2.0 prefill of {len(long_tokens)} tokens bucketed on "
                      f"{len(mixed)} rank-layers; last-row logits {err:.3e} from tp=1's ({err / scale:.3e} of max "
                      f"|logit|, tolerance {TP_LOGIT_TOL}); argmax {int(logits.argmax())} (tp=1: "
                      f"{int(ref_long.argmax())})")
                row[impl]["bucketed_prefill_err_rel"] = err / scale
            # decode timing of the same engine, fenced by synchronize
            engine.reset()
            first = int(engine.prefill(prompt_tokens).argmax())
            engine.decode_chunk(first, 4, 0.0, 0.9)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.decode_chunk(first, 8, 0.0, 0.9)
            row["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / 8
            print(f"tp={tp} ({engine.tp_backend.allreduce if engine.tp_backend else 'one rank'}): decode "
                  f"{row['decode_ms_per_token']:.2f} ms/token over 8 greedy tokens; engine load {row['load_s']:.1f} s, "
                  f"{row['card_gb']:.2f} GB on the card")
            row.update(device_profile(engine, first, row["decode_ms_per_token"], steps=4))
            out[f"tp{tp}"] = row
            del engine, built
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        moe._route_topk, moe._mix_buckets = orig_route, orig_mix
        telemetry.disable()
        telemetry.reset()
    return out


def chat_phases(cli, q40, synthetic, workdir: Path, summary: dict) -> None:
    """Phases 13a and 13b; results go into ``summary``."""
    from distributed_llama_tpu_torch import telemetry

    t = phase(f"13a. the slice's path: convert a Hugging Face checkpoint at Llama-2-7B width, {CHAT_LAYERS} layers")
    conv = convert_phase(synthetic, workdir)
    summary["convert"] = conv
    print(f"phase 13a: {time.perf_counter() - t:.1f} s")
    t = phase("13b. the slice's path: chat on the converted model")
    summary["chat"] = chat_phase(cli, q40, telemetry, conv, workdir)
    os.remove(conv["model"])
    print(f"phase 13b: {time.perf_counter() - t:.1f} s")


def moe_tp_phases(cli, moe, q40, coll, llama, synthetic, write_tokenizer_file, workdir: Path, summary: dict,
                  mixtral: tuple | None = None) -> None:
    """K1 at the Mixtral expert shard shapes, then phase 13c over
    ``mixtral`` = (model, tok), phase 8's Mixtral-width files, or over
    files written here; results go into ``summary``."""
    from distributed_llama_tpu_torch import telemetry

    t = phase(f"13c. the slice's path: Mixtral-8x7B width under --tp 2 and 4, {MIXTRAL_LAYERS} layers")
    summary["moe_tp_kernel_rows"] = k1_checks(q40, shapes=MOE_TP_SHAPES, ts=(1,))
    written = mixtral is None
    if written:
        spec = synthetic.mixtral_8x7b_spec(n_layers=MIXTRAL_LAYERS, seq_len=4096)
        mixtral = (str(workdir / "mixtral_8x7b_width.m"), str(workdir / "tok_mixtral.t"))
        synthetic.write_random_q40_model(mixtral[0], spec, seed=0)
        with open(mixtral[1], "wb") as f:
            write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=spec.vocab_size))
    summary["moe_tp"] = moe_tp_phase(cli, moe, q40, coll, llama, telemetry, *mixtral)
    if written:
        os.remove(mixtral[0])
    print(f"phase 13c: {time.perf_counter() - t:.1f} s")


def chat_only(smi: str) -> None:
    """``--chat``: phase 2, 7a's K4 rows at the MoE sum's payload, and phase
    13 alone (its own Mixtral-width file)."""
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.models import llama, moe
    from distributed_llama_tpu_torch.ops import collectives as coll
    from distributed_llama_tpu_torch.ops import cuda_build, q40

    t = phase("2. build kernels")
    print(f"nvcc build: {cuda_build.build():.1f} s")
    summary: dict = {"card": smi}
    t = phase("7a. K4 at the MoE expert sum's payload")
    summary["k4_rows"] = k4_checks(coll, (1,))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        chat_phases(cli, q40, synthetic, Path(tmp), summary)
        moe_tp_phases(cli, moe, q40, coll, llama, synthetic, write_tokenizer_file, Path(tmp), summary)
    summary["total_s"] = time.perf_counter() - t
    out = ROOT / "build" / "chip_smoke_chat.json"
    out.write_text(json.dumps(summary, indent=1))
    print(f"phase 13 with its set-up: {summary['total_s']:.1f} s; details in {out}")
    print(f"card: {smi}")


def _import_port(root: Path, name: str):
    """The port's ``ops`` module ``name`` from the tree under ``root``."""
    sys.path.insert(0, str(root))
    import importlib

    mod = importlib.import_module(f"distributed_llama_tpu_torch.ops.{name}")
    check(Path(mod.__file__).resolve().is_relative_to(root.resolve()), f"imported {mod.__file__}, not {root}")
    return mod


def _build_alone(cuda_build, name: str, root: Path) -> None:
    phase(f"2. build {name} from {root}")
    print(f"nvcc build: {cuda_build.build([name]):.1f} s")
    for line in cuda_build.build_log.get(name, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")


def k1_only(root: Path, smi: str) -> None:
    """``--k1``: phase 3's K1 part alone, the port under ``root`` (another
    tree, e.g. an unpacked earlier commit, to time two designs in one call:
    its wrapper only, against the plain version). Rows go to
    build/chip_smoke_k1.json under this script's tree."""
    q40 = _import_port(root, "q40")
    _build_alone(_import_port(root, "cuda_build"), "q40_int8", root)
    t = phase("3. K1 vs its plain version at the Llama-2-7B shapes")
    rows = k1_checks(q40, strict=root.resolve() == ROOT)
    forwards = k1_forward_rows(rows)
    print(f"phase 3 (K1): {time.perf_counter() - t:.1f} s")
    out = ROOT / "build" / "chip_smoke_k1.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"root": str(root), "card": smi, "rows": rows, "per_forward": forwards}, indent=1))
    print(f"card: {smi}")
    print(json.dumps({"k1": forwards}))


def k3_only(root: Path, smi: str) -> None:
    """``--k3``: phase 3's K3 part alone, the port under ``root`` (another
    tree, e.g. an unpacked earlier commit, to time two designs in one call:
    its failed checks are printed, not fatal). Rows go to
    build/chip_smoke_k3.json under this script's tree."""
    q40 = _import_port(root, "q40")
    _build_alone(_import_port(root, "cuda_build"), "q40_dequant", root)
    t = phase("3. K3 vs its plain version at the Llama-2-7B shapes")
    rows = k3_checks(q40, strict=root.resolve() == ROOT)
    forwards = k1_forward_rows(rows, "K3")
    print(f"phase 3 (K3): {time.perf_counter() - t:.1f} s")
    out = ROOT / "build" / "chip_smoke_k3.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"root": str(root), "card": smi, "rows": rows, "per_forward": forwards}, indent=1))
    print(f"card: {smi}")
    print(json.dumps({"k3": forwards}))


def k5_only(root: Path, smi: str) -> None:
    """``--k5``: phase 7b alone, K5 of the port under ``root`` (another
    tree, e.g. an unpacked earlier commit, to time two designs in one call:
    its failed checks are printed, not fatal). Rows go to
    build/chip_smoke_k5.json under this script's tree."""
    q40 = _import_port(root, "q40")
    coll = _import_port(root, "collectives")
    cuda_build = _import_port(root, "cuda_build")
    _build_alone(cuda_build, "fused_matmul_ring", root)
    cuda_build.build(["q40_int8", "ring_all_reduce"])  # the unfused chain it is held against
    t = phase("7b. K5 fused int8 matmul + ring vs K1 + correction + K4, at the 7B wo/down shards")
    rows = k5_checks(q40, coll, strict=root.resolve() == ROOT)
    print(f"phase 7b: {time.perf_counter() - t:.1f} s")
    out = ROOT / "build" / "chip_smoke_k5.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"root": str(root), "card": smi, "rows": rows}, indent=1))
    print(f"card: {smi}")
    print(json.dumps({"k5": [{k: r[k] for k in ("shape", "tp", "T", "cluster", "ms", "bound_ms", "plain_ms",
                                                 "library_ms", "max_rel_err")} for r in rows]}))


def k2_only(root: Path, smi: str) -> None:
    """``--k2``: phase 6a alone, K2 of the port under ``root`` (another
    tree, e.g. an unpacked earlier commit, to time two designs in one
    call); the contract and per-pass checks run where the port has the
    passes. Rows go to build/chip_smoke_k2.json under this script's tree."""
    attn = _import_port(root, "attention")
    kvc = _import_port(root, "kv_cache")
    _build_alone(_import_port(root, "cuda_build"), "paged_attention", root)
    t = phase("6a. K2 paged attention vs its plain version at the Llama-2-7B heads")
    own = root.resolve() == ROOT
    rows = k2_checks(attn, kvc, contracts=hasattr(attn, "paged_attention_partials"), strict=own)
    print(f"phase 6a: {time.perf_counter() - t:.1f} s")
    out = ROOT / "build" / "chip_smoke_k2.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"root": str(root), "card": smi, "rows": rows}, indent=1))
    print(f"card: {smi}")
    print(json.dumps({"k2": [{k: r[k] for k in ("kernel", "case", "T", "dtype", "ms", "bound_ms", "plain_ms",
                                                 "library_ms", "sdpa_only_ms", "max_rel_err")} for r in rows]}))


def main() -> None:
    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port on one NVIDIA GPU")
    parser.add_argument("--k1", action="store_true", help="phase 3's K1 part alone (K1 checked and timed)")
    parser.add_argument("--k2", action="store_true", help="phase 6a alone (K2 checked and timed)")
    parser.add_argument("--k3", action="store_true", help="phase 3's K3 part alone (K3 checked and timed)")
    parser.add_argument("--k5", action="store_true", help="phase 7b alone (K5 checked and timed)")
    parser.add_argument("--moe", action="store_true", help="phase 4's MoE part and phase 8 alone")
    parser.add_argument("--loadgen", action="store_true",
                        help="phase 9 alone (the load generator against the 7B-width server with --telemetry)")
    parser.add_argument("--faults", action="store_true",
                        help="phase 10 alone (fault containment and fair admission in the 7B-width server)")
    parser.add_argument("--spill", action="store_true",
                        help="phase 11 alone (the host spill tier and the replica pool in the 7B-width server)")
    parser.add_argument("--fleet", action="store_true",
                        help="phase 12 alone (the SDC canary, shadow votes, rollout and the fleet controller in the "
                        "7B-width server)")
    parser.add_argument("--chat", action="store_true",
                        help="phase 13 alone (convert a Hugging Face checkpoint, chat on it, and Mixtral-8x7B width "
                        "under --tp 2 and 4)")
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="with --k1, --k2, --k3 or --k5: the tree whose port is imported")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke test needs a GPU", flush=True)
        sys.exit(2)
    alone = [f for f, on in ((k1_only, opts.k1), (k2_only, opts.k2), (k3_only, opts.k3), (k5_only, opts.k5),
                             (lambda root, smi: moe_only(smi), opts.moe),
                             (lambda root, smi: loadgen_only(smi), opts.loadgen),
                             (lambda root, smi: faults_only(smi), opts.faults),
                             (lambda root, smi: spill_only(smi), opts.spill),
                             (lambda root, smi: fleet_only(smi), opts.fleet),
                             (lambda root, smi: chat_only(smi), opts.chat)) if on]
    if len(alone) > 1:
        parser.error("at most one of --k1, --k2, --k3, --k5, --moe, --loadgen, --faults, --spill, --fleet, --chat")
    if alone:
        phase("1. card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"nvidia-smi: {smi}; torch: {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
        alone[0](opts.root, smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.engine import InferenceEngine
    from distributed_llama_tpu_torch.formats import synthetic
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
    from distributed_llama_tpu_torch.models import llama, moe
    from distributed_llama_tpu_torch.ops import attention as attn
    from distributed_llama_tpu_torch.ops import collectives as coll
    from distributed_llama_tpu_torch.ops import cuda_build, q40
    from distributed_llama_tpu_torch.ops import kv_cache as kvc
    from distributed_llama_tpu_torch.server import api as server_api
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
    k1_rows = k1_checks(q40)
    k1_forward = k1_forward_rows(k1_rows)
    k3_rows = k3_checks(q40)
    k3_forward = k1_forward_rows(k3_rows, "K3")
    summary.update(kernel_rows=k1_rows + k3_rows, k1_per_forward=k1_forward, k3_per_forward=k3_forward,
                   row_blocks=row_block_cost(q40))
    print(f"phase 3: {time.perf_counter() - t:.1f} s")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        t = phase("4. small model: card vs CPU")
        small_reference_check(synthetic, InferenceEngine, FloatType, workdir)
        summary["small_moe"] = small_moe_check(synthetic, InferenceEngine, moe, q40, workdir)
        print(f"phase 4: {time.perf_counter() - t:.1f} s")

        t = phase(f"5. main path: CLI generate at Llama-2-7B width, {MAIN_LAYERS} layers")
        model, tok = write_7b_files(synthetic, write_tokenizer_file, workdir, MAIN_LAYERS)
        spec = synthetic.llama2_7b_spec(n_layers=MAIN_LAYERS, seq_len=4096)
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
            ("greedy spec 4", "int8", ["--prompt", "hello world, hello", "--temperature", "0", "--seed", "1",
                                       "--spec-draft", "4"]),
            ("greedy f32 spec 4", "f32", ["--prompt", "hello world, hello", "--temperature", "0", "--seed", "1",
                                          "--spec-draft", "4"]),
        ]
        streams = {}
        q40.reset_launches()  # the main path's counts start here
        for label, path, extra in runs:
            tiles0 = dict(q40.tile_launches)
            engine.reset()
            stream = engine.default_stream
            f0, l0 = stream.forwards, dict(q40.launches)
            print(f"--- {label} (--q40-path {path})")
            res = cli.generate(args("--q40-path", path, *extra), benchmark=True, built=built)
            torch.cuda.synchronize()
            forwards = stream.forwards - f0
            d_int8 = q40.launches["q40_int8"] - l0["q40_int8"]
            d_deq = q40.launches["q40_dequant"] - l0["q40_dequant"]
            tiles = {k: v - tiles0[k] for k, v in q40.tile_launches.items()}
            print(f"{label}: {len(res['tokens'])} tokens, {forwards} forwards, launches int8 {d_int8} "
                  f"(by tile {tiles}) dequant {d_deq} (expected {per_forward} per forward on the {path} path)")
            check(len(res["tokens"]) > 0, f"{label}: no tokens generated")
            check(all(0 <= t_ < spec.vocab_size for t_ in res["tokens"]), f"{label}: token out of range")
            if path == "int8":
                check(d_int8 == per_forward * forwards and d_deq == 0, f"{label}: launch count")
            else:
                check(d_deq == per_forward * forwards and d_int8 == 0, f"{label}: launch count")
            streams[label] = res["tokens"]
        main_launches = dict(q40.launches)
        main_tiles = dict(q40.tile_launches)
        # decode steps take the dp4a tile; prefills (T >= 8) and the spec-4
        # verify windows the tensor-core tile
        check(all(v > 0 for v in main_tiles.values()), f"a K1 tile was never launched: {main_tiles}")
        summary["main_path_k1_tiles"] = main_tiles
        check(streams["greedy"] == streams["greedy again"], "greedy streams differ between runs")
        check(streams["sampled"] == streams["sampled again"], "sampled streams differ for one seed")
        check(streams["greedy spec 4"] == streams["greedy"],
              "greedy --spec-draft 4 differs from --spec-draft 0: "
              f"{streams['greedy spec 4']} vs {streams['greedy']}")
        print(f"greedy --spec-draft 4 equals --spec-draft 0 token for token ({len(streams['greedy'])} tokens)")
        # K3's rows equal its T=1 launches, so the f32 path's verify windows
        # give what its decode steps give
        check(streams["greedy f32 spec 4"] == streams["greedy f32 path"],
              "greedy --q40-path f32 --spec-draft 4 differs from --spec-draft 0: "
              f"{streams['greedy f32 spec 4']} vs {streams['greedy f32 path']}")
        print(f"greedy --q40-path f32 --spec-draft 4 equals --spec-draft 0 token for token "
              f"({len(streams['greedy f32 path'])} tokens)")
        summary["spec_window"] = spec_window_check(engine, llama, built[1].encode("hello world, hello", add_bos=True))
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
        engine.q40_path = "int8"
        print("chunk delivery (chunks of 8 greedy tokens):")
        summary["chunk_delivery"] = chunk_delivery(engine, first)
        print(f"phase 5: {time.perf_counter() - t:.1f} s")
        del engine, built
        torch.cuda.empty_cache()

        t = phase("6a. K2 paged attention vs its plain version at the Llama-2-7B heads")
        k2_rows = k2_checks(attn, kvc)
        summary["k2_rows"] = k2_rows
        print(f"phase 6a: {time.perf_counter() - t:.1f} s")

        # phase 7c's 8-layer file, written now: 6c's 16-row server and
        # phases 9 to 12 run over it in the full run (their depth cut to keep
        # the run inside its time limit; --loadgen, --faults, --spill and
        # --fleet alone keep all 32 layers)
        model_tp = str(workdir / "llama2_7b_width_tp.m")
        synthetic.write_random_q40_model(model_tp, synthetic.llama2_7b_spec(n_layers=TP_LAYERS, seq_len=4096),
                                         seed=0)

        t = phase(f"6b. main path: the API server, --parallel 4, prefix cache, {MAIN_LAYERS} layers")
        summary["server"] = server_run(server_api, attn, kvc, llama, model, tok, q40)
        main_launches["paged_attention"] = summary["server"]["main_path_launches"]
        print(f"phase 6b: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        t = phase(f"6c. the slice's path: the API server, --cache-dtype i8 --spec-draft 4, {MAIN_LAYERS} layers")
        summary["server_i8_spec"] = server_run(server_api, attn, kvc, llama, model, tok, q40,
                                               extra=("--cache-dtype", "i8", "--spec-draft", "4"), spec=True)
        main_launches["paged_attention_i8"] = summary["server_i8_spec"]["main_path_launches"]
        main_launches["q40_int8_mma"] = summary["server_i8_spec"]["k1_tile_launches"]["mma"]
        gc.collect()
        torch.cuda.empty_cache()
        summary["server_wide"] = wide_spec_run(server_api, q40, model_tp, tok)
        print(f"phase 6c: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        t = phase("7a. K4 ring all-reduce vs its plain version")
        summary["launch_floor_ms"] = launch_floor_ms()
        print(f"launch floor (one-element add, in a CUDA graph): {summary['launch_floor_ms']:.4f} ms")
        from distributed_llama_tpu_torch.engine.engine import _prefill_bucket
        from distributed_llama_tpu_torch.tokenizer import Tokenizer

        tp_prefill_rows = _prefill_bucket(len(Tokenizer.from_file(tok, 32000).encode(TP_PROMPT, add_bos=True)))
        print(f"phase 7c's --tp 2 prefill launches K4 on [{tp_prefill_rows}, {DIM}] (its bucket-padded prompt)")
        k4_rows = k4_checks(coll, (1, 16, tp_prefill_rows))
        summary["k4_rows"] = k4_rows
        t = phase("7b. K5 fused int8 matmul + ring vs K1 + correction + K4, at the 7B wo/down shards")
        k5_rows = k5_checks(q40, coll)
        summary["k5_rows"] = k5_rows
        print(f"phases 7a-7b: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        t = phase(f"9. the slice's path: the load generator against the API server with --telemetry, "
                  f"{TP_LAYERS} layers")
        summary["loadgen"] = loadgen_phase(server_api, attn, q40, model_tp, tok, smi)
        print(f"phase 9: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        t = phase(f"10. the slice's path: fault containment and fair admission in the API server, {TP_LAYERS} "
                  "layers")
        summary["faults"] = faults_phase(server_api, attn, q40, model_tp, tok, smi)
        print(f"phase 10: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        t = phase(f"11. the slice's path: the host spill tier and the replica pool in the API server, "
                  f"{TP_LAYERS} layers")
        summary["spill"] = spill_phase(server_api, model_tp, tok, smi, workdir)
        print(f"phase 11: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        t = phase(f"12. the slice's path: the SDC canary, shadow votes, rollout and the fleet controller in the API "
                  f"server, {TP_LAYERS} layers")
        summary["fleet"] = fleet_phase(server_api, model_tp, tok, smi, workdir)
        print(f"phase 12: {time.perf_counter() - t:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        os.remove(model)  # room on the disk for phase 7c's and phase 8's files
        t = phase(f"7c. the slice's path: CLI generate --tp 2/4 --allreduce ring, Llama-2-7B width, "
                  f"{TP_LAYERS} layers")
        summary["tp"] = tp_runs(cli, llama, coll, q40, model_tp, tok)
        for name in ("ring_all_reduce", "fused_matmul_ring"):
            main_launches[name] = summary["tp"]["tp2"]["launches"][name]
        os.remove(model_tp)
        print(f"phase 7c: {time.perf_counter() - t:.1f} s")

        moe_phases(cli, moe, q40, attn, kvc, llama, server_api, synthetic, write_tokenizer_file, workdir, summary,
                   after_8c=lambda m, t_: moe_tp_phases(cli, moe, q40, coll, llama, synthetic, write_tokenizer_file,
                                                        workdir, summary, (m, t_)))
        chat_phases(cli, q40, synthetic, workdir, summary)

    kernels = []
    # K2 on the servers' steps: 4 rows, 32 kv heads, one launch per layer
    # per batched forward; a decode step (T=1) over the bf16 cache in 6b, a
    # verify step (T=5) over the int8 cache in 6c
    k2_entries = []
    for name, dtype, T in (("paged_attention", "torch.bfloat16", 1), ("paged_attention_i8", "i8", 5)):
        k2 = next(r for r in k2_rows if r["case"] == "B4 K32 M1" and r["T"] == T and r["dtype"] == dtype)
        src, replaces = KERNEL_INFO[name]
        k2_entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in k2_rows if r["kernel"] == name),
            **{k: k2[k] * N_LAYERS for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            bound_by=k2["bound_by"],
        ))
    # K1's dp4a tile and K3: one decoded token at 32 layers (T=1, each shape
    # weighted by its launches per token); K1's tensor-core tile: one verify
    # forward of 6c's 4-row --spec-draft 4 windows (T=20)
    for name, rows_, T in (("q40_int8", k1_rows, 1), ("q40_int8_mma", k1_rows, 20), ("q40_dequant", k3_rows, 1)):
        src, replaces = KERNEL_INFO[name]
        mine = [r for r in rows_ if r["T"] == T]
        tot = {k: sum(r[k] * r["per_token"] for r in mine) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main_tiles["dp4a"] if name == "q40_int8" else main_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows_),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine) else "operations",
            library_ms=tot["library_ms"],
        ))
    kernels.extend(k2_entries)
    # phase 8's path (8b's CLI runs over the Mixtral-width model): K1's dp4a
    # tile and K3 over one decoded token's expert launches (k = 2 experts'
    # gate_up and down in each layer, T=1); K1's tensor-core tile over
    # one 64-row prefill forward's expert launches (all 8 experts' gate_up
    # and down in each layer)
    moe_rows = [r for r in summary["moe_kernel_rows"] if r["shape"].startswith("mixtral")]
    mixtral = summary["mixtral_cli"]
    for name, kernel, T, scale, launches in (
            ("q40_int8_moe", "q40_int8", 1, None, mixtral["tile_launches"]["dp4a"]),
            ("q40_int8_mma_moe", "q40_int8", 64, 8 * MIXTRAL_LAYERS, mixtral["tile_launches"]["mma"]),
            ("q40_dequant_moe", "q40_dequant", 1, None, mixtral["launches"]["q40_dequant"])):
        src, replaces = KERNEL_INFO[name.removesuffix("_moe")]
        mine = [r for r in moe_rows if r["kernel"] == kernel and r["T"] == T]
        tot = {k: sum(r[k] * (scale or r["per_token"]) for r in mine)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in summary["moe_kernel_rows"] if r["kernel"] == kernel),
            ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine) else "operations",
            library_ms=tot["library_ms"]))
    # K4: one call at the decode payload [1, 4096], 2 ranks; K5: one decoded
    # token's launches at tp=2 (wo and down at T=1 in each of 32 layers)
    k4 = next(r for r in k4_rows if r["n"] == 2 and r["R"] == 1)
    k5 = [r for r in k5_rows if r["tp"] == 2 and r["T"] == 1]
    for name, rows_, scale_ in (("ring_all_reduce", [k4], 1), ("fused_matmul_ring", k5, N_LAYERS)):
        src, replaces = KERNEL_INFO[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=main_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in (k4_rows if name == "ring_all_reduce" else k5_rows)),
            **{k: sum(r[k] for r in rows_) * scale_ for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows_) else "operations",
        ))
    # phase 13c's path (--tp 2 --allreduce ring over the Mixtral-width
    # model): K1's dp4a tile over one decoded token's expert shard launches
    # (2 experts x gate_up and down x MIXTRAL_LAYERS layers x 2 ranks, T=1); K4 over one
    # expert sum, [1, 4096] f32 over 2 ranks
    ring2 = summary["moe_tp"]["tp2"]["ring"]["launches"]
    tp_rows = [r for r in summary["moe_tp_kernel_rows"] if r["shape"].startswith("mixtral_tp2_")]
    src, replaces = KERNEL_INFO["q40_int8"]
    kernels.append(dict(
        name="q40_int8_moe_tp", route="cuda", source=src, replaces=replaces, launches=ring2["dp4a"],
        max_abs_err=max(r["max_abs_err"] for r in summary["moe_tp_kernel_rows"]),
        **{k: sum(r[k] * r["per_token"] for r in tp_rows) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in tp_rows) else "operations"))
    src, replaces = KERNEL_INFO["ring_all_reduce"]
    kernels.append(dict(name="ring_all_reduce_moe_tp", route="cuda", source=src, replaces=replaces,
                        launches=ring2["ring_all_reduce"], max_abs_err=k4["max_abs_err"],
                        **{k: k4[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by")}))
    summary["kernels"] = kernels
    end = time.perf_counter()
    summary["total_s"] = end - t_all
    summary["phase_s"] = phase_seconds(end)
    OUT_FILE.parent.mkdir(exist_ok=True)
    OUT_FILE.write_text(json.dumps(summary, indent=1))
    print(f"\nseconds by phase (from its start to the next phase's): {summary['phase_s']}")
    print(f"total {summary['total_s']:.1f} s; details in {OUT_FILE}")
    print("kernel numbers: ms/plain_ms/bound_ms/library_ms are one decoded token's worth of "
          "launches at 32 layers (T=1, each shape times its launches per token; q40_int8_mma: one verify "
          "forward at T=20 likewise, its launches phase 6c's; paged_attention: "
          "one batched decode step of 4 rows at the phase-6a positions, 32 launches; paged_attention_i8: "
          "one batched verify step, T=5, of 4 rows there); launches are the main path's, each counted in a run "
          f"of the depth named: phase 5 ({MAIN_LAYERS} layers) for the Q40 kernels, phase 6b ({MAIN_LAYERS}) for "
          f"paged_attention, phase 6c ({MAIN_LAYERS}) for paged_attention_i8, phase 7c's --tp 2 run ({TP_LAYERS} "
          "layers) for ring_all_reduce and fused_matmul_ring; ring_all_reduce: one call at [1, 4096] over 2 "
          f"ranks; fused_matmul_ring: one decoded token's wo and down launches at --tp 2 (T=1) at {N_LAYERS} "
          "layers, not at the depth of its launch count; the _moe entries: phase 8b's Mixtral-width path "
          f"({MIXTRAL_LAYERS} layers; q40_int8_moe and q40_dequant_moe: one decoded token's expert launches, 2 "
          "experts x gate_up and down per layer at T=1; q40_int8_mma_moe: one 64-row prefill forward's, 8 "
          "experts x gate_up and down per layer), launches are phase 8b's; q40_int8_moe_tp: one decoded token's "
          f"expert shard launches at --tp 2 ({MIXTRAL_LAYERS} layers, 2 experts x gate_up 4096->14336 and down "
          "7168->4096 x 2 ranks, T=1), ring_all_reduce_moe_tp: one expert sum [1, 4096] over 2 ranks, their launches "
          "phase 13c's --tp 2 --allreduce ring run")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
