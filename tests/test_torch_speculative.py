"""The port's self-speculative decoding held against the JAX package's and
against its own plain decode.

* The prompt-lookup drafter proposes what the JAX package's does, on
  seeded and periodic histories.
* The on-device accept/reject (``sampling.spec_accept_rows``) gives the
  JAX ``_spec_accept_row``'s n_emit and tokens for the same logits, drafts
  and coin keys, greedy and sampled.
* Greedy speculative streams equal the port's plain streams: single-stream
  and batched, bf16 and int8 caches, and spec and plain rows sharing one
  slab.
* The port's speculative streams equal the JAX package's on the same
  f32-weight synthetic model (the cases of tests/test_speculative.py):
  token ids must be identical, since on f32 weights the two packages'
  logits differ by ulps, far below these random models' top-2 gaps.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.engine.batch import BatchScheduler as JaxScheduler
from distributed_llama_tpu.engine.speculative import PromptLookupDrafter as JaxDrafter
from distributed_llama_tpu.models.sampling import _spec_accept_row

from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.engine.speculative import PromptLookupDrafter
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.models import sampling

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512)
PROMPTS = [[1, 5, 9], [2, 4, 6, 8], [3, 7]]
N_TOKENS = 10
K = 3  # draft length under test (T = 4 verify windows)


def plain_stream(stream, prompt, temp, seed, n, topp=0.9):
    """The non-speculative reference: prefill_device, then the chunked decode."""
    stream.reset()
    first = stream.prefill_device(prompt, temp, topp, seed)
    got = []

    def on_token(prev, tok):
        got.append(tok)
        return len(got) < n

    stream.stream_decode(first, on_token, temp, topp, seed=seed, chunk=4, limit=stream.pos + n,
                         first_prev=prompt[-1])
    return got


def spec_stream(stream, prompt, temp, seed, n, spec_draft=K, topp=0.9):
    """The same request through the speculative path."""
    stream.reset()
    first = stream.prefill_device(prompt, temp, topp, seed)
    got = []

    def on_token(prev, tok):
        got.append(tok)
        return len(got) < n

    stream.stream_decode(first, on_token, temp, topp, seed=seed, limit=stream.pos + n, first_prev=prompt[-1],
                         spec_draft=spec_draft, prompt_tokens=prompt)
    return got


def run_rows(sched, jobs):
    """Run ``jobs`` [(prompt, temp, seed, spec_draft)] concurrently, one per
    scheduler row; returns their token lists in order."""
    streams = [sched.new_stream() for _ in jobs]
    outs, errors = [None] * len(jobs), []

    def run(i):
        try:
            p, temp, seed, k = jobs[i]
            outs[i] = spec_stream(streams[i], p, temp, seed, N_TOKENS, spec_draft=k)
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    return outs


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """seq_len -> model path: 96 takes the full-S attention, 1024 the
    blocked scan (and K2's plain version on batched steps)."""
    d = tmp_path_factory.mktemp("torch_spec")
    out = {}
    for seq_len in (96, 1024):
        out[seq_len] = str(d / f"m{seq_len}.m")
        tsyn.write_synthetic_model(out[seq_len], tsyn.tiny_spec(**SPEC, seq_len=seq_len), seed=seq_len)
    return out


def torch_engine(models, seq_len=96, cache_dtype=None):
    return TorchEngine(models[seq_len], dtype=torch.float32, device="cpu", cache_dtype=cache_dtype)


def jax_engine(models, seq_len=96, cache_dtype=None):
    return JaxEngine(models[seq_len], dtype=jnp.float32, cache_dtype=cache_dtype)


# ---------------------------------------------------------------------------
# Drafter and accept/reject, unit level
# ---------------------------------------------------------------------------


def test_drafter_matches_jax_on_seeded_and_periodic_histories():
    rng = np.random.RandomState(0)
    histories = [list(rng.randint(0, v, n)) for v, n in ((4, 40), (8, 200), (30, 500), (3, 5))]
    histories += [[1, 2, 1, 2, 1, 2], [5, 6, 7] * 30 + [5], list(range(20)), [7], []]
    for k, ngram in ((1, 1), (3, 3), (4, 2), (6, 4)):
        ours, theirs = PromptLookupDrafter(k, max_ngram=ngram), JaxDrafter(k, max_ngram=ngram)
        for h in histories:
            for limit in (None, 0, 2):
                assert ours.draft(h, limit=limit) == theirs.draft(h, limit=limit)
        # an append-only history, the serving loops' use: the mirror grows
        grown, ref = [], []
        for t in rng.randint(0, 5, 120):
            grown.append(int(t))
            ref.append(int(t))
            assert ours.draft(grown) == theirs.draft(list(ref))
        assert ours.drafted_total == theirs.drafted_total


def test_spec_accept_rows_match_jax():
    """Random logits, drafts (some the argmax, some not), draft lengths
    0..k and greedy, sampled, top-k and top-p rows: each row's n_emit and
    tokens equal the JAX package's for the same coin keys."""
    rng = np.random.RandomState(3)
    B, T, V = 8, 4, 40
    logits = (rng.randn(B, T, V) * 2).astype(np.float32)
    draft = rng.randint(0, V, (B, T - 1)).astype(np.int32)
    for b in range(0, B, 2):  # half the rows draft the argmax prefix
        draft[b] = logits[b, :-1].argmax(-1)
    draft_len = np.array([3, 3, 2, 0, 1, 3, 3, 2], np.int32)
    seeds = rng.randint(0, 2**32, B).astype(np.uint32)
    pos = rng.randint(0, 500, B).astype(np.int32)
    settings = [  # (temperature, topp, topk)
        (0.0, 0.9, 0), (0.0, 0.9, 0), (0.8, 0.9, 0), (1.0, 1.0, 0),
        (0.7, 0.5, 5), (1.2, 0.95, 0), (0.9, 0.0, 3), (0.0, 0.9, 0),
    ]
    temp, topp, topk = (np.array(c, dt) for c, dt in zip(zip(*settings), (np.float32, np.float32, np.int32)))
    want = [_spec_accept_row(jnp.asarray(logits[b]), jnp.asarray(draft[b]), jnp.int32(draft_len[b]),
                             jnp.uint32(seeds[b]), jnp.int32(pos[b]), jnp.float32(temp[b]), jnp.float32(topp[b]),
                             jnp.int32(topk[b])) for b in range(B)]
    n_emit, toks = sampling.spec_accept_rows(
        torch.from_numpy(logits), torch.from_numpy(draft), torch.from_numpy(draft_len).long(),
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(pos).long(), torch.from_numpy(temp),
        torch.from_numpy(topp), torch.from_numpy(topk).long())
    for b in range(B):
        assert int(n_emit[b]) == int(want[b][0]), b
        np.testing.assert_array_equal(toks[b].numpy(), np.asarray(want[b][1]))
    assert int(n_emit[0]) == 4 and int(n_emit[3]) == 1  # a full accept with bonus; a zero draft
    # all-greedy rows may skip the filtered distribution: the same result
    g = [0, 1, 7]
    n_g, t_g = sampling.spec_accept_rows(
        torch.from_numpy(logits[g]), torch.from_numpy(draft[g]), torch.from_numpy(draft_len[g]).long(),
        torch.from_numpy(seeds[g].astype(np.int64)), torch.from_numpy(pos[g]).long(), torch.from_numpy(temp[g]),
        torch.from_numpy(topp[g]), torch.from_numpy(topk[g]).long(), sampled=False)
    assert n_g.tolist() == n_emit[g].tolist() and t_g.tolist() == toks[g].tolist()


# ---------------------------------------------------------------------------
# Greedy speculative == plain, within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "i8"])
def test_greedy_spec_equals_plain(models, cache_dtype):
    """Single-stream (full-S and blocked attention) and batched rows, one of
    them a plain row (spec_draft 0) riding the verify steps, with the prefix
    cache on; every stream equals the plain decode of its request."""
    for seq_len in (96, 1024):
        engine = torch_engine(models, seq_len, cache_dtype)
        ref = engine.new_stream()
        want = [plain_stream(ref, p, 0.0, 11 + i, N_TOKENS) for i, p in enumerate(PROMPTS)]
        single = engine.new_stream()
        assert [spec_stream(single, p, 0.0, 11 + i, N_TOKENS) for i, p in enumerate(PROMPTS)] == want
    sched = BatchScheduler(engine, n_rows=3, chunk=4, spec_draft=K, prefix_cache=True, page_size=64)
    jobs = [(p, 0.0, 11 + i, 0 if i == 1 else K) for i, p in enumerate(PROMPTS)]
    assert run_rows(sched, jobs) == want
    assert sched.spec_row_steps > 0 and sched.spec_emitted >= sched.spec_row_steps
    assert sched.decode_forwards < 3 * N_TOKENS  # rows stepped together, some steps emitting several tokens
    sched.check_prefix()


@pytest.mark.parametrize("seq_len,cache_dtype", [(96, None), (1024, None), (1024, "i8")])
def test_verify_window_equals_per_position_decode(models, seq_len, cache_dtype):
    """The single-stream verify window (``spec_verify_step``'s forward, each
    query row attending on its own) gives, bit for bit, the logits of the
    same tokens fed as T=1 decode steps: full-S and blocked attention, bf16
    and int8 caches."""
    from distributed_llama_tpu_torch.models import llama

    engine = torch_engine(models, seq_len, cache_dtype)
    stream = engine.default_stream
    engine.reset()
    logits = engine.prefill([1, 5, 9, 13, 2])
    start, feed, rows = engine.pos, [int(logits.argmax())], []
    for _ in range(K + 1):
        rows.append(engine.decode_step(feed[-1]))
        feed.append(int(rows[-1].argmax()))
    stream.rollback(start)
    window, stream.cache = llama.forward_tokens(engine.cfg, engine.params, torch.tensor(feed[: K + 1]),
                                                stream.cache, start, per_position=True)
    assert torch.equal(window, torch.from_numpy(np.stack(rows)))


# ---------------------------------------------------------------------------
# The port against the JAX package (tests/test_speculative.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,cache_dtype", [(96, None), (96, "i8"), (1024, None)])
def test_single_stream_matches_jax(models, seq_len, cache_dtype):
    want = spec_stream(jax_engine(models, seq_len, cache_dtype).new_stream(), [1, 5, 9], 0.0, 7, N_TOKENS)
    engine = torch_engine(models, seq_len, cache_dtype)
    s = engine.new_stream()
    assert spec_stream(s, [1, 5, 9], 0.0, 7, N_TOKENS) == want
    assert want == plain_stream(engine.new_stream(), [1, 5, 9], 0.0, 7, N_TOKENS)
    if seq_len == 96 and cache_dtype is None:
        # sampled: the same coins give the same stream, and the position
        # rolls back to the prompt plus the fed tokens
        want = spec_stream(jax_engine(models).new_stream(), [1, 5, 9], 0.8, 11, N_TOKENS)
        assert spec_stream(s, [1, 5, 9], 0.8, 11, N_TOKENS) == want
        assert s.pos == 3 + N_TOKENS - 1


def test_context_tail_matches_jax(tmp_path):
    """Near seq_len the verify window shrinks instead of writing past the
    cache; the stream still reaches the context limit."""
    path = str(tmp_path / "tail.m")
    tsyn.write_synthetic_model(path, tsyn.tiny_spec(**SPEC, seq_len=24), seed=4)
    want = spec_stream(JaxEngine(path, dtype=jnp.float32).new_stream(), [1, 5, 9], 0.0, 3, 24)
    engine = TorchEngine(path, dtype=torch.float32, device="cpu")
    assert spec_stream(engine.new_stream(), [1, 5, 9], 0.0, 3, 24) == want
    assert len(want) == 24 - 3 + 1


@pytest.mark.parametrize("cache_dtype", [None, "i8"])
def test_batched_rows_match_jax(monkeypatch, models, cache_dtype):
    """Batched speculative rows (greedy, a sampled row, and a plain row with
    spec_draft 0) through both packages' schedulers, then a row reused for a
    second request: identical streams."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jobs = [(PROMPTS[0], 0.0, 21, K), (PROMPTS[1], 0.0, 23, 0), (PROMPTS[2], 0.8, 5, K)]
    jsched = JaxScheduler(jax_engine(models, 1024, cache_dtype), n_rows=3, chunk=4, spec_draft=K)
    sched = BatchScheduler(torch_engine(models, 1024, cache_dtype), n_rows=3, chunk=4, spec_draft=K)
    assert sched.spec_draft == K
    want = run_rows(jsched, jobs)
    assert run_rows(sched, jobs) == want
    again = sched._streams[0]
    assert spec_stream(again, PROMPTS[0], 0.0, 21, N_TOKENS) == want[0]


def test_cli_i8_spec_generate_equals_plain(tmp_path, models):
    """``generate --cache-dtype i8 --spec-draft 3`` prints the tokens the
    plain int8 run prints, greedy."""
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file

    tok = str(tmp_path / "t.t")
    with open(tok, "wb") as f:
        write_tokenizer_file(f, tsyn.synthetic_tokenizer_data(vocab_size=SPEC["vocab_size"]))
    base = ["generate", "--model", models[96], "--tokenizer", tok, "--prompt", "hello world hello", "--device",
            "cpu", "--dtype", "f32", "--cache-dtype", "i8", "--steps", "40", "--temperature", "0"]
    plain = cli.main(base)
    spec = cli.main(base + ["--spec-draft", "3"])
    assert spec["tokens"] == plain["tokens"] and len(plain["tokens"]) > 0
