"""The port's batched serving core held against the JAX package's: the
``BatchScheduler`` with the paged prefix cache, and the radix tree.

One synthetic f32 model (dim 64, 2 layers, 4 heads, 2 kv heads, vocab 512,
seq_len 1024: decode takes the blocked paged scan) is loaded by both
packages. The JAX scheduler's decode runs its XLA segmented scan
(``DLT_FUSED_PAGED=0``, which its own tests hold bit-identical to the
fused kernel) to keep the test short. Token streams must be identical: on
f32 weights the two packages' logits differ by ulps, far below the top-2
gaps of these random models.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.engine.batch import BatchScheduler as JaxScheduler
from distributed_llama_tpu.models import llama as jllama

from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine.batch import BatchScheduler, decode_bucket
from distributed_llama_tpu_torch.engine.prefix_cache import PrefixCache
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.models import llama as tllama

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=1024)
PAGE = 64
PROMPT = [int(t) for t in np.random.RandomState(0).randint(3, 500, 70)]  # one full page + 6
SCHED = dict(n_rows=3, chunk=4, prefix_cache=True, page_size=PAGE, prefill_chunk=32)
N = 10  # decoded tokens per request


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_batch") / "model.m"
    tsyn.write_synthetic_model(str(path), tsyn.tiny_spec(**SPEC), seed=1)
    return str(path)


@pytest.fixture(scope="module")
def torch_engine(model_path):
    return TorchEngine(model_path, dtype=torch.float32, device="cpu")


def decode_tokens(stream, prompt, temp, seed, n=N):
    """One request through the fused serving flow on a stream."""
    stream.reset()
    first = stream.prefill_device(prompt, temp, 0.9, seed)
    got = []

    def on_token(prev, tok):
        got.append(tok)
        return len(got) < n

    stream.stream_decode(first, on_token, temp, 0.9, seed=seed, limit=stream.pos + n, first_prev=prompt[-1])
    return got


# (row, prompt, temperature, seed): a cold greedy request, then three
# co-batched ones: its prefix hit, a sampled miss and a longer prompt hit
COLD = (0, PROMPT, 0.0, 7)
ROUND = [(0, PROMPT, 0.0, 7), (1, PROMPT[:20], 0.8, 3), (2, PROMPT + [5, 6, 9], 0.0, 11)]


def run_round(sched):
    streams = [sched.new_stream() for _ in range(3)]
    out = {"cold": decode_tokens(streams[0], *COLD[1:])}

    def run(row, prompt, temp, seed):
        out[row] = decode_tokens(streams[row], prompt, temp, seed)

    threads = [threading.Thread(target=run, args=r) for r in ROUND]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sched.check_prefix()
    return out


def test_scheduler_streams_match_jax(monkeypatch, model_path, torch_engine):
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    want = run_round(JaxScheduler(JaxEngine(model_path, dtype=jnp.float32), **SCHED))
    sched = BatchScheduler(torch_engine, **SCHED)
    got = run_round(sched)
    assert got == want
    assert sched._prefix.hits == 2 and sched._prefix.misses == 2  # rows 0 and 2 hit the cold run's page
    assert sched.decode_forwards > 0


def test_hit_equals_cold_and_single_stream(torch_engine, monkeypatch):
    """Within the port: a prefix hit streams what the cold run streamed, a
    batched row streams what the single-stream decode does for its seed,
    and the hit prefilled only the suffix past the matched page."""
    sched = BatchScheduler(torch_engine, **SCHED)
    suffix_lens = []
    orig = sched._dispatch_prefill_chunks
    monkeypatch.setattr(sched, "_dispatch_prefill_chunks",
                        lambda stream, toks: (suffix_lens.append(toks.shape[0]), orig(stream, toks))[1])
    got = run_round(sched)
    assert got[0] == got["cold"]
    assert suffix_lens[0] == len(PROMPT) and sorted(suffix_lens[1:]) == [
        len(PROMPT) - PAGE, len(PROMPT) + 3 - PAGE, 20]
    single = torch_engine.new_stream()
    for row, prompt, temp, seed in ROUND:
        assert got[row] == decode_tokens(single, prompt, temp, seed)
    # without the prefix cache the same rows decode the same streams
    plain = run_round(BatchScheduler(torch_engine, n_rows=3, chunk=4, prefill_chunk=32))
    assert plain == got


def test_batched_forward_step_matches_jax(monkeypatch, model_path, torch_engine):
    """One batched decode step with paged rows, inactive rows and a bucket
    row, on identical slab and pool contents: logits and the written slab
    agree with the JAX package's."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng = JaxEngine(model_path, dtype=jnp.float32)
    cfg_j, cfg_t = jeng.cfg, torch_engine.cfg
    rng = np.random.RandomState(5)
    B, P = 4, 12
    slab = [rng.randn(2, B, 1024, 2, 16).astype(np.float32) for _ in range(2)]
    pool = [[rng.randn(P, PAGE, 2, 16).astype(np.float32) for _ in range(2)] for _ in range(2)]
    tables = np.zeros((B, 1024 // PAGE), np.int32)
    tables[0, :9] = rng.permutation(P)[:9]
    tables[2, :2] = [3, 7]
    pos, active, matched = [600, 300, 130, 0], [True, False, True, False], [576, 0, 128, 0]
    tokens = np.array([5, 9, 400, 0], np.int32)

    jlogits, jcache = jllama.forward_step_batched(
        cfg_j, jeng.params, jnp.asarray(tokens), [jnp.asarray(s) for s in slab], jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), paged=([tuple(map(jnp.asarray, p)) for p in pool], jnp.asarray(tables),
                                    jnp.asarray(matched, jnp.int32)))
    tcache = [torch.from_numpy(s.copy()) for s in slab]
    tlogits, tcache = tllama.forward_step_batched(
        cfg_t, torch_engine.params, torch.from_numpy(tokens).long(), tcache, pos, active,
        paged=([tuple(map(torch.from_numpy, p)) for p in pool], torch.from_numpy(tables), torch.tensor(matched)))
    want = np.asarray(jlogits)
    np.testing.assert_allclose(tlogits.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for t, j in zip(tcache, jcache):  # written K/V: ulps of the projections apart
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max())


def test_decode_bucket():
    assert [decode_bucket(n, 3) for n in (1, 2, 3)] == [1, 2, 3]
    assert [decode_bucket(n, 8) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]


# ---------------------------------------------------------------------------
# Radix tree (host only): the JAX package's tree tests, on the port's copy
# ---------------------------------------------------------------------------

P4 = 4


def test_match_is_strictly_shorter_than_prompt():
    tree = PrefixCache(8, P4)
    toks = list(range(1, 9))
    ids, blocks = tree.publish(toks, len(toks), [])
    assert blocks == [0, 1] and len(ids) == 2
    chain = tree.match(toks)
    assert len(chain) == 1  # the last token must prefill to produce logits
    tree.release(chain)
    chain = tree.match(toks + [99])
    assert [nd.page_id for nd in chain] == ids
    tree.release(chain)
    tree.check()


def test_divergent_suffixes_share_prefix_pages():
    tree = PrefixCache(8, P4)
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 9, 9, 9, 9]
    tree.publish(a, len(a), [])
    chain_b = tree.match(b + [0])
    assert len(chain_b) == 1
    tree.release(chain_b)
    tree.publish(b, len(b), chain_b)
    assert tree.pages_in_use() == 3
    tree.check()


def test_refcounted_pages_survive_eviction_pressure():
    tree = PrefixCache(2, P4)
    held = [1, 2, 3, 4]
    tree.publish(held, P4, [])
    chain = tree.match(held + [9])
    assert len(chain) == 1
    for i in range(4):
        ids, _ = tree.publish([10 + i] * P4, P4, [])
        assert len(ids) <= 1
        tree.check(row_pages=[[nd.page_id for nd in chain]])
    assert tree.match(held + [9])
    tree.release(chain)


def test_publish_stops_when_everything_pinned():
    tree = PrefixCache(1, P4)
    tree.publish([1] * P4, P4, [])
    chain = tree.match([1] * P4 + [2])
    assert tree.publish([5] * P4, P4, []) == ([], [])
    tree.release(chain)
    ids, _ = tree.publish([5] * P4, P4, [])
    assert len(ids) == 1 and tree.evictions == 1
    tree.check()


def test_lru_evicts_least_recently_used_leaf_first():
    tree = PrefixCache(2, P4)
    a, b = [1] * P4, [2] * P4
    tree.publish(a, P4, [])
    tree.publish(b, P4, [])
    tree.release(tree.match(a + [0]))  # touch a: b becomes the LRU leaf
    tree.publish([3] * P4, P4, [])
    assert tree.match(a + [0])
    assert not tree.match(b + [0])
    tree.check()


def test_publish_never_evicts_its_own_growing_chain():
    tree = PrefixCache(1, P4)
    ids, blocks = tree.publish(list(range(8)), 8, [])
    assert ids == [0] and blocks == [0]
    tree.check()
    assert all(nd.refs == 0 for nd in tree._walk())
    assert len(tree.match(list(range(8)) + [99])) == 1


def test_interior_pages_never_evicted_under_leaves():
    tree = PrefixCache(3, P4)
    tree.publish([1, 2, 3, 4, 5, 6, 7, 8], 8, [])
    tree.publish([9] * P4, P4, [])
    tree.publish([8] * P4, P4, [])
    tree.check()
    for node in tree._walk():
        if node.children:
            assert node.page_id not in tree.free


def test_unpublish_frees_the_inserted_tail():
    tree = PrefixCache(4, P4)
    toks = list(range(12))
    chain = tree.match(toks)
    ids, blocks = tree.publish(toks, 12, chain)
    assert blocks == [0, 1, 2]
    tree.unpublish(toks, ids[1:], blocks[1:])
    assert tree.pages_in_use() == 1 and len(tree.match(toks + [1])) == 1
    tree.check()
