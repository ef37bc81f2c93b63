"""The port's host spill tier and shared prefix index held against the JAX
package's.

* :class:`HostArena` / :class:`DiskTier`: the same seeded scripts of puts,
  takes, peeks, drops, corruptions and owner drops run on both packages'
  arenas (numpy arrays in, numpy arrays out); CRCs, byte counts, depths,
  LRU drops, disk demotions and every read's bytes are equal. Exact. The
  JAX package's unit cases (tests/test_prefix_spill.py ``TestHostArena``,
  ``TestDiskTier``) then run on the port.
* :class:`SharedPrefixIndex`: seeded scripts of publish, withdraw and
  ``drop_owner`` answer every ``match`` as JAX's does; the JAX unit cases.
* A bf16 page survives the host round trip (raw 16-bit words in the
  ``BF16_WORDS`` dtype) bit for bit, NaN payloads included.
* Entry layout: for bf16, f32 and i8 caches the port's spill entry has
  the JAX scheduler's array count, shapes, dtypes and order (``_slice_page``).
* The scheduler (one synthetic f32 model, dim 64, 2 layers, hd 16, seq_len
  96, 4-token pages, a 6-page pool, one row): a churned-then-reloaded
  prompt streams what the cold prompt streamed, with the reload counted,
  for bf16, f32 and i8 caches, and both equal the JAX scheduler's streams
  in the same scenario (greedy token ids, exact); i8 data and scales are
  byte-equal after a reload; a pinned page never has an arena entry; an
  ``engine.spill`` raise or corrupt CRC falls back to a cold prefill with
  an unchanged stream; the disk tier reloads.
* Two schedulers over one arena and one index (replicas 0 and 1): a peer
  reloads replica 0's spilled chain by copy, the owner's reload moves it.
* Routing (fake replicas): placement follows the index to the chain's
  owner, chat affinity still wins, a dead replica's chains leave the index
  and the arena; the /readyz cache read of a real scheduler.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.engine import batch as jbatch
from distributed_llama_tpu.engine import faults as jfaults
from distributed_llama_tpu.engine import prefix_cache as jprefix
from distributed_llama_tpu.engine import spill as jspill

from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import faults
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.engine.prefix_cache import SharedPrefixIndex
from distributed_llama_tpu_torch.engine.spill import DiskTier, HostArena, SpillCorrupt, _crc
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.ops import kv_cache as kvc
from distributed_llama_tpu_torch.server import replicas as reps

from tests.test_torch_replicas import FakeCache, fake_pool

PAGE = 4
PROMPT = [1, 5, 9, 2, 7, 3, 11, 4, 6, 8]  # 10 tokens = 2 full pages + 2
SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=96)
CACHE = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16), "i8": ("i8", "i8")}


@pytest.fixture(autouse=True)
def _clear_fault_plans():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_spill") / "model.m"
    tsyn.write_synthetic_model(str(path), tsyn.tiny_spec(**SPEC), seed=4)
    return str(path)


def torch_engine(model_path, cache="f32"):
    return TorchEngine(model_path, dtype=torch.float32, device="cpu", cache_dtype=CACHE[cache][0])


def build_sched(engine, kv_pages=6, spill_mb=32, arena=None, cls=BatchScheduler, **kw):
    """One row over a ``kv_pages`` pool; without ``arena``, its own arena of
    ``spill_mb`` MiB from the scheduler's package."""
    if arena is None:
        arena = (jspill.HostArena if cls is jbatch.BatchScheduler else HostArena)(spill_mb << 20)
    return cls(engine, n_rows=1, chunk=4, prefix_cache=True, kv_pages=kv_pages, page_size=PAGE,
               spill_arena=arena, **kw)


def decode_tokens(stream, prompt, n=6, seed=3):
    stream.reset()
    first = stream.prefill_device(prompt, 0.0, 0.9, seed)
    got = []

    def on_token(prev, tok):
        got.append(tok)
        return len(got) < n

    stream.stream_decode(first, on_token, 0.0, 0.9, seed=seed, limit=stream.pos + n, first_prev=prompt[-1])
    return got


def churn(stream, base, rounds=3):
    """Publish ``rounds`` fresh 2-page prefixes: evicts (and spills)
    everything unpinned in a 6-page pool."""
    for k in range(rounds):
        decode_tokens(stream, [base + 10 * k + j for j in range(10)])
    stream.reset()


def arrays_like(seed=0, n=3, ro=False):
    rng = np.random.RandomState(seed)
    out = [rng.randn(2, PAGE, 3).astype(np.float32) for _ in range(n)]
    if ro:
        for a in out:
            a.setflags(write=False)
    return out


# ----------------------------------------------------------------------
# Arena and disk tier against the JAX package's
# ----------------------------------------------------------------------


def _arena_state(arena):
    return (arena.depth(), arena.depth(0), arena.depth(1), arena.resident_bytes, arena.spilled_total,
            arena.reloaded_total, arena.dropped_total, arena.corrupt_total,
            None if arena.disk is None else (len(arena.disk), arena.disk.dropped_total, arena.disk.entry_bytes))


def _read(fn):
    try:
        got = fn()
    except (SpillCorrupt, jspill.SpillCorrupt):
        return "corrupt"
    return None if got is None else [np.ascontiguousarray(a).tobytes() for a in got]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("disk", [False, True], ids=["host", "disk"])
def test_arena_script_matches_jax(tmp_path, seed, disk):
    """A seeded script of 60 arena operations over 6 chains and 2 owners,
    with a host budget of ~3 entries (and an 8-slot disk tier): every read
    returns the same bytes (or the same CRC verdict) and the arenas' byte
    counts, depths, totals, LRU drops and demotions stay equal."""
    entry = sum(a.nbytes for a in arrays_like())
    kw = dict(disk_budget_bytes=8 * entry) if disk else {}
    mine = HostArena(3 * entry + 7, disk_path=str(tmp_path / "t.bin") if disk else None, **kw)
    ref = jspill.HostArena(3 * entry + 7, disk_path=str(tmp_path / "j.bin") if disk else None, **kw)
    rng = random.Random(seed)
    chains = [tuple(range(c, c + 4 * (1 + c % 2))) for c in range(6)]
    for step in range(60):
        op, owner, chain = rng.choice(("put", "put", "take", "peek", "drop", "corrupt", "drop_owner", "has")), \
            rng.randrange(2), rng.choice(chains)
        if op == "put":
            arrays = arrays_like(rng.randrange(1000))
            assert _crc(arrays) == jspill._crc(arrays)
            mine.put(owner, chain, arrays)
            ref.put(owner, chain, arrays)
        elif op == "take":
            assert _read(lambda: mine.take(owner, chain)) == _read(lambda: ref.take(owner, chain)), step
        elif op == "peek":
            assert _read(lambda: mine.peek_shared(chain, owner)) == _read(lambda: ref.peek_shared(chain, owner))
        elif op == "drop":
            mine.drop(owner, chain)
            ref.drop(owner, chain)
        elif op == "corrupt":
            mine.corrupt(chain)
            ref.corrupt(chain)
        elif op == "drop_owner":
            mine.drop_owner(owner)
            ref.drop_owner(owner)
        else:
            assert mine.has(owner, chain) == ref.has(owner, chain)
        assert _arena_state(mine) == _arena_state(ref), (step, op)


def test_disk_tier_matches_jax(tmp_path):
    arrays = arrays_like()
    nbytes = sum(a.nbytes for a in arrays)
    mine, ref = DiskTier(str(tmp_path / "a.bin"), 2 * nbytes), jspill.DiskTier(str(tmp_path / "b.bin"), 2 * nbytes)
    crc = _crc(arrays)
    for key in ((0, (1,)), (0, (2,)), (1, (3,))):  # the third overflows: LRU drop
        assert mine.put(key, arrays, crc) == ref.put(key, arrays, crc)
    assert (mine.keys(), mine.dropped_total, mine.entry_bytes) == (ref.keys(), ref.dropped_total, ref.entry_bytes)
    assert _read(lambda: mine.take((1, (3,)))) == _read(lambda: ref.take((1, (3,))))
    other = [np.zeros((5,), np.int8)]
    assert mine.put((0, (9,)), other, 0) is ref.put((0, (9,)), other, 0) is False


def test_bf16_page_round_trips_bit_for_bit(tmp_path):
    """Every 16-bit pattern, NaN payloads and infinities included, through
    to_host_array, the arena (host and disk) and from_host_array."""
    words = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16).reshape(2, PAGE, -1)
    page = words.view(torch.bfloat16)
    host = kvc.to_host_array(page.clone())
    assert host.dtype == kvc.BF16_WORDS and host.nbytes == page.numel() * 2
    arena = HostArena(host.nbytes, disk_path=str(tmp_path / "s.bin"), disk_budget_bytes=4 * host.nbytes)
    arena.put(0, (1,), [host])
    arena.put(0, (2,), [host.copy()])  # demotes (1,) to the disk tier
    assert len(arena.disk) == 1
    for chain in ((1,), (2,)):
        back = kvc.from_host_array(arena.take(0, chain)[0])
        assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), words)
    # the dtype tag is in the template: an int16 entry is not a bf16 one
    disk = DiskTier(str(tmp_path / "t.bin"), 4 * host.nbytes)
    assert disk.put((0, (1,)), [host], _crc([host]))
    assert not disk.put((0, (2,)), [host.view(np.int16)], 0)


# ----------------------------------------------------------------------
# The JAX package's arena, disk and index unit cases, on the port
# ----------------------------------------------------------------------


class TestHostArena:
    def test_put_take_roundtrip_verbatim(self):
        arena = HostArena(1 << 20)
        arrays = arrays_like(ro=True)
        arena.put(0, (1, 2, 3, 4), arrays)
        assert arena.depth() == 1 and arena.depth(0) == 1
        got = arena.take(0, (1, 2, 3, 4))
        for a, b in zip(got, arrays):
            np.testing.assert_array_equal(a, b)
        assert arena.take(0, (1, 2, 3, 4)) is None  # take MOVES
        assert arena.depth() == 0 and arena.reloaded_total == 1

    def test_peek_shared_copies_and_leaves_the_owner_entry(self):
        arena = HostArena(1 << 20)
        arrays = arrays_like()
        arena.put(0, (1, 2, 3, 4), arrays)
        got = arena.peek_shared((1, 2, 3, 4), exclude_owner=1)
        for a, b in zip(got, arrays):
            np.testing.assert_array_equal(a, b)
        assert arena.depth(0) == 1
        assert arena.peek_shared((1, 2, 3, 4), exclude_owner=0) is None

    def test_budget_lru_eviction_counts_drops(self):
        arrays = arrays_like()
        arena = HostArena(2 * sum(a.nbytes for a in arrays))
        arena.put(0, (1,), arrays_like(1))
        arena.put(0, (2,), arrays_like(2))
        arena.take(0, (1,))
        arena.put(0, (1,), arrays_like(1))
        arena.put(0, (3,), arrays_like(3))  # over budget: (2,) is LRU
        assert arena.dropped_total == 1
        assert arena.take(0, (2,)) is None
        assert arena.take(0, (1,)) is not None
        assert arena.take(0, (3,)) is not None

    def test_crc_mismatch_raises_and_drops(self):
        arena = HostArena(1 << 20)
        arena.put(0, (9, 9, 9, 9), arrays_like(ro=True))
        arena.corrupt((9, 9, 9, 9))
        with pytest.raises(SpillCorrupt):
            arena.take(0, (9, 9, 9, 9))
        assert arena.corrupt_total == 1
        assert arena.take(0, (9, 9, 9, 9)) is None

    def test_drop_owner_removes_only_that_owner(self):
        arena = HostArena(1 << 20)
        arena.put(0, (1, 2), arrays_like(1))
        arena.put(1, (1, 2), arrays_like(1))
        arena.put(1, (3, 4), arrays_like(2))
        arena.drop_owner(1)
        assert arena.depth(1) == 0 and arena.depth(0) == 1
        assert arena.peek_shared((1, 2), exclude_owner=1) is not None

    def test_disk_demotion_and_reload(self, tmp_path):
        nbytes = sum(a.nbytes for a in arrays_like())
        arena = HostArena(nbytes, disk_path=str(tmp_path / "spill.bin"), disk_budget_bytes=8 * nbytes)
        arena.put(0, (1,), arrays_like(1))
        arena.put(0, (2,), arrays_like(2))  # (1,) demotes to disk
        assert arena.dropped_total == 0 and len(arena.disk) == 1 and arena.depth(0) == 2
        for a, b in zip(arena.take(0, (1,)), arrays_like(1)):
            np.testing.assert_array_equal(a, b)
        assert arena.take(0, (1,)) is None

    def test_disk_corruption_detected(self, tmp_path):
        nbytes = sum(a.nbytes for a in arrays_like())
        arena = HostArena(nbytes, disk_path=str(tmp_path / "spill.bin"), disk_budget_bytes=8 * nbytes)
        arena.put(0, (1,), arrays_like(1))
        arena.put(0, (2,), arrays_like(2))
        arena.corrupt((1,))
        with pytest.raises(SpillCorrupt):
            arena.take(0, (1,))
        assert arena.take(0, (1,)) is None

    def test_disk_lru_overflow_counts_drops(self, tmp_path):
        nbytes = sum(a.nbytes for a in arrays_like())
        arena = HostArena(nbytes, disk_path=str(tmp_path / "spill.bin"), disk_budget_bytes=nbytes)
        arena.put(0, (1,), arrays_like(1))
        arena.put(0, (2,), arrays_like(2))
        arena.put(0, (3,), arrays_like(3))  # (2,) to disk, (1,) dropped
        assert arena.dropped_total == 1
        assert arena.take(0, (1,)) is None
        assert arena.take(0, (2,)) is not None


class TestDiskTier:
    def test_roundtrip_and_slot_reuse(self, tmp_path):
        arrays = arrays_like()
        disk = DiskTier(str(tmp_path / "t2.bin"), 2 * sum(a.nbytes for a in arrays))
        crc = _crc(arrays)
        assert disk.put((0, (1,)), arrays, crc)
        for a, b in zip(disk.take((0, (1,))), arrays):
            np.testing.assert_array_equal(a, b)
        assert len(disk) == 0
        assert disk.put((0, (2,)), arrays, crc) and disk.put((0, (3,)), arrays, crc)

    def test_template_mismatch_rejected(self, tmp_path):
        arrays = arrays_like()
        disk = DiskTier(str(tmp_path / "t.bin"), 4 * sum(a.nbytes for a in arrays))
        assert disk.put((0, (1,)), arrays, 0)
        assert not disk.put((0, (2,)), [np.zeros((5,), np.int8)], 0)


class TestSharedPrefixIndex:
    def test_match_longest_contiguous_chain_per_owner(self):
        idx = SharedPrefixIndex(PAGE)
        t = list(range(1, 13))
        idx.publish(0, tuple(t[:4]))
        idx.publish(1, tuple(t[:4]))
        idx.publish(1, tuple(t[:8]))
        assert idx.match(t) == {0: 1, 1: 2}
        idx.withdraw(1, tuple(t[:4]))
        assert idx.match(t) == {0: 1}

    def test_match_strictly_shorter_than_prompt(self):
        idx = SharedPrefixIndex(PAGE)
        t = list(range(1, 9))
        idx.publish(0, tuple(t[:4]))
        idx.publish(0, tuple(t[:8]))
        assert idx.match(t) == {0: 1}

    def test_drop_owner_is_total(self):
        idx = SharedPrefixIndex(PAGE)
        t = list(range(1, 13))
        idx.publish(0, tuple(t[:4]))
        idx.publish(1, tuple(t[:4]))
        idx.publish(1, tuple(t[:8]))
        idx.drop_owner(1)
        assert idx.match(t) == {0: 1}
        assert idx.owners(tuple(t[:8])) == set()


@pytest.mark.parametrize("seed", range(3))
def test_index_script_matches_jax(seed):
    """80 seeded publish / withdraw / drop_owner calls over 3 owners and the
    prefixes of 3 prompts: every ``match`` (and ``owners``, ``len``) equals
    the JAX index's."""
    mine, ref = SharedPrefixIndex(PAGE), jprefix.SharedPrefixIndex(PAGE)
    rng = random.Random(seed)
    prompts = [[rng.randrange(50) for _ in range(17)] for _ in range(3)]
    prompts[1][:8] = prompts[0][:8]  # a shared head
    for _ in range(80):
        op, owner, p = rng.choice(("publish", "publish", "withdraw", "drop_owner")), rng.randrange(3), \
            rng.choice(prompts)
        chain = tuple(p[: PAGE * rng.randint(1, 4)])
        if op == "publish":
            mine.publish(owner, chain)
            ref.publish(owner, chain)
        elif op == "withdraw":
            mine.withdraw(owner, chain)
            ref.withdraw(owner, chain)
        else:
            mine.drop_owner(owner)
            ref.drop_owner(owner)
        for q in prompts:
            assert mine.match(q) == ref.match(q)
        assert mine.owners(chain) == ref.owners(chain) and len(mine) == len(ref)


# ----------------------------------------------------------------------
# The scheduler: entry layout, spill -> reload, faults, disk
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["bf16", "f32", "i8"])
def test_entry_layout_matches_jax(model_path, cache):
    """The port's spill entry of one published page has the JAX entry's
    array count, shapes and order, dtypes mapped (bf16 -> BF16_WORDS); on
    the f32 cache the values agree to 1e-5 of their scale."""
    jeng = JaxEngine(model_path, dtype=jnp.float32, cache_dtype=CACHE[cache][1])
    jsched = build_sched(jeng, cls=jbatch.BatchScheduler)
    decode_tokens(jsched.new_stream(), PROMPT)
    sched = build_sched(torch_engine(model_path, cache))
    decode_tokens(sched.new_stream(), PROMPT)
    jpid = jsched._prefix.walk(PROMPT)[0].page_id
    pid = sched._prefix.walk(PROMPT)[0].page_id
    want = [np.asarray(a) for a in jbatch._slice_page(jsched._pool, jnp.int32(jpid))]
    got = sched._download_page(pid)
    assert len(got) == len(want) == 2 * len(sched._pool) * kvc.pool_page_arrays_per_half(sched._pool[0][0])
    # the fused download is the per-half downloads, layer by layer, k then v
    halves = [a for pk, pv in sched._pool for h in (pk, pv) for a in kvc.download_pool_page(h, pid)]
    assert [a.tobytes() for a in got] == [a.tobytes() for a in halves]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype == (kvc.BF16_WORDS if w.dtype == jnp.bfloat16 else w.dtype)
        if cache == "f32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0))


def _spill_scenario(sched):
    """Cold prompt, churn (evicts and spills it), the prompt again: returns
    (cold, warm, pages reloaded)."""
    s = sched.new_stream()
    cold = decode_tokens(s, PROMPT)
    prefix = sched._prefix
    churn(s, 100)
    assert prefix.spill.spilled_total >= 2, "eviction did not spill"
    assert prefix.walk(PROMPT) == []
    rel0 = prefix.spill.reloaded_total
    warm = decode_tokens(s, PROMPT)
    reloaded = prefix.spill.reloaded_total - rel0
    assert len(prefix.walk(PROMPT)) == 2
    s.reset()
    sched.check_prefix()
    return cold, warm, reloaded


@pytest.mark.parametrize("cache", ["bf16", "f32", "i8"])
def test_reload_parity_and_jax_streams(model_path, cache):
    """Cold stream == host-reloaded stream with the reload counted (2 pages
    and the spill counters moved), and both equal the JAX scheduler's in
    the same scenario, token for token."""
    sched = build_sched(torch_engine(model_path, cache))
    cold, warm, reloaded = _spill_scenario(sched)
    assert warm == cold, "host-reloaded stream diverged from cold"
    assert reloaded >= 2 and sched.spill_uploads >= 2 and sched.spill_downloads >= 2
    assert sched._prefix.evictions >= 2
    jsched = build_sched(JaxEngine(model_path, dtype=jnp.float32, cache_dtype=CACHE[cache][1]),
                         cls=jbatch.BatchScheduler)
    jcold, jwarm, jreloaded = _spill_scenario(jsched)
    assert (cold, warm) == (jcold, jwarm) and jreloaded == reloaded


def test_i8_spill_reload_byte_parity_data_and_scales(model_path):
    sched = build_sched(torch_engine(model_path, "i8"))
    s = sched.new_stream()
    decode_tokens(s, PROMPT)
    s.reset()
    prefix = sched._prefix
    nodes = prefix.walk(PROMPT)
    assert len(nodes) == 2
    before = [[a.copy() for a in sched._download_page(nd.page_id)] for nd in nodes]
    assert len(before[0]) == 2 * 2 * len(sched._pool)  # data and scales, k and v, per layer
    churn(s, 200)
    assert prefix.walk(PROMPT) == []
    decode_tokens(s, PROMPT)  # reload
    s.reset()
    nodes = prefix.walk(PROMPT)
    assert len(nodes) == 2
    for want, nd in zip(before, nodes):
        got = sched._download_page(nd.page_id)
        assert [a.dtype for a in got] == [a.dtype for a in want]
        for a, b in zip(got, want):
            assert a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()
    sched.check_prefix()


def test_pinned_pages_never_resident_in_arena(model_path):
    sched = build_sched(torch_engine(model_path))
    s = sched.new_stream()
    decode_tokens(s, PROMPT)
    decode_tokens(s, PROMPT)  # a hit: the row pins the chain for its lifetime
    prefix = sched._prefix
    sched.check_prefix()
    nodes = prefix.walk(PROMPT)
    assert nodes and nodes[0].refs > 0
    key = prefix.chain_key(nodes[0])
    prefix.spill.put(prefix.owner_id, key, [np.zeros(3, np.float32)])
    with pytest.raises(AssertionError, match="spill arena"):
        sched.check_prefix()
    prefix.spill.drop(prefix.owner_id, key)
    sched.check_prefix()
    s.reset()


@pytest.mark.parametrize("kind", ["raise", "corrupt"])
def test_reload_fault_falls_back_cold(model_path, kind):
    """engine.spill: a raise aborts the reload, a corrupt fire flips the
    arena's bytes and the CRC gate drops them; either way the request
    prefills cold and streams what the cold run streamed."""
    engine = torch_engine(model_path)
    faults.install(faults.parse(f"engine.spill:kind={kind},count=-1", seed=0))
    sched = build_sched(engine)
    s = sched.new_stream()
    cold = decode_tokens(s, PROMPT)
    prefix = sched._prefix
    churn(s, 100)
    rel0, corrupt0 = prefix.spill.reloaded_total, prefix.spill.corrupt_total
    assert decode_tokens(s, PROMPT) == cold
    assert prefix.spill.reloaded_total == rel0, "a faulted reload uploaded bytes"
    if kind == "corrupt":
        assert prefix.spill.corrupt_total > corrupt0, "the CRC gate never fired"
    s.reset()
    sched.check_prefix()


def test_disk_tier_reload_through_scheduler(model_path, tmp_path):
    engine = torch_engine(model_path)
    probe = build_sched(engine)
    ps = probe.new_stream()
    decode_tokens(ps, PROMPT)
    ps.reset()
    churn(ps, 300, rounds=2)
    entry_bytes = probe._prefix.spill.resident_bytes // max(probe._prefix.spill.depth(), 1)
    arena = HostArena(int(entry_bytes * 1.5), disk_path=str(tmp_path / "disk" / "spill.bin"),
                      disk_budget_bytes=64 << 20)
    sched = build_sched(engine, arena=arena)
    s = sched.new_stream()
    cold = decode_tokens(s, PROMPT)
    churn(s, 100)
    assert len(arena.disk) >= 1, "nothing demoted to the disk tier"
    assert decode_tokens(s, PROMPT) == cold
    s.reset()
    sched.check_prefix()


# ----------------------------------------------------------------------
# Cross-replica: two schedulers, one arena and one index
# ----------------------------------------------------------------------


class TestCrossReplica:
    def test_peer_reloads_a_spilled_chain_by_copy(self, model_path):
        engine = torch_engine(model_path)
        idx, arena = SharedPrefixIndex(PAGE), HostArena(32 << 20)
        sched0 = build_sched(engine, arena=arena, shared_index=idx, replica_id=0)
        sched1 = build_sched(engine, arena=arena, shared_index=idx, replica_id=1)
        s0, s1 = sched0.new_stream(), sched1.new_stream()
        cold = decode_tokens(s0, PROMPT)
        assert idx.match(PROMPT) == {0: 2}
        churn(s0, 100)
        assert arena.depth(0) >= 2 and idx.match(PROMPT) == {}
        rel0 = arena.reloaded_total
        assert decode_tokens(s1, PROMPT) == cold  # replica 1 reloads by COPY
        assert arena.reloaded_total - rel0 >= 2
        assert arena.depth(0) >= 2, "a peer reload must not take replica 0's entry"
        assert idx.match(PROMPT) == {1: 2}
        s1.reset()
        sched0.check_prefix()
        sched1.check_prefix()

    def test_own_reload_moves_the_entry_out(self, model_path):
        arena = HostArena(32 << 20)
        sched = build_sched(torch_engine(model_path), arena=arena)
        s = sched.new_stream()
        decode_tokens(s, PROMPT)
        churn(s, 100)
        chains = (tuple(PROMPT[:4]), tuple(PROMPT[:8]))
        assert all(arena.has(0, c) for c in chains)
        decode_tokens(s, PROMPT)
        assert not any(arena.has(0, c) for c in chains)
        s.reset()
        sched.check_prefix()


class TestSharedRouting:
    def route_tokens(self):
        return list(range(1, 13))

    def test_place_routes_to_the_chain_owner(self):
        idx = SharedPrefixIndex(PAGE)
        pool = fake_pool(n_replicas=2, shared_index=idx)
        t = self.route_tokens()
        idx.publish(1, tuple(t[:4]))
        assert pool.place([], route_tokens=t) in pool.replicas[1].slots
        assert pool.shared_hits_total == 1
        assert pool.place([], route_tokens=list(range(50, 62))) in pool.replicas[0].slots
        assert pool.shared_hits_total == 1

    def test_chat_affinity_still_beats_shared_routing(self):
        idx = SharedPrefixIndex(PAGE)
        pool = fake_pool(n_replicas=2, shared_index=idx)
        t = self.route_tokens()
        idx.publish(1, tuple(t[:4]))
        pool.replicas[0].slots[0].cache = FakeCache(match=2, items=["x"])
        assert pool.place([{"role": "user", "content": "x"}], route_tokens=t) is pool.replicas[0].slots[0]
        idx2 = SharedPrefixIndex(PAGE)
        pool2 = fake_pool(n_replicas=2, shared_index=idx2)
        idx2.publish(0, tuple(t[:4]))
        pool2.replicas[0].slots[0].cache = FakeCache(match=2, items=["x"])
        assert pool2.place([{"role": "user", "content": "x"}], route_tokens=t) is pool2.replicas[0].slots[0]
        assert pool2.shared_hits_total == 0

    def test_dead_replica_chains_leave_index_and_arena(self):
        idx, arena = SharedPrefixIndex(PAGE), HostArena(1 << 20)
        pool = fake_pool(n_replicas=2, shared_index=idx, spill_arena=arena)
        t = self.route_tokens()
        idx.publish(1, tuple(t[:4]))
        arena.put(1, tuple(t[:4]), [np.zeros(4, np.float32)])
        pool._on_event(1, pool.replicas[1].generation, "lost", 0.0)
        assert pool.replicas[1].state == reps.DEAD
        assert idx.match(t) == {} and arena.depth(1) == 0
        assert pool.place([], route_tokens=t) in pool.replicas[0].slots
        assert pool.shared_hits_total == 0

    def test_readyz_snapshot_carries_cache_occupancy(self, model_path):
        engine = torch_engine(model_path)
        sched = build_sched(engine)
        s = sched.new_stream()
        decode_tokens(s, PROMPT)
        churn(s, 100)
        pool = reps.ReplicaPool(lambda i: None, [reps.Replica(0, engine, sched, [])], supervise=False)
        cache = pool.snapshot()[0]["cache"]
        assert cache["pages"] == sched._prefix.pages_in_use()
        assert cache["pinned"] == sched._prefix.pinned_pages()
        assert cache["spill_depth"] >= 2
        s.reset()


def test_foreign_entry_is_refused_before_upload(model_path):
    """An arena entry from another configuration (another dtype, shape or
    array count) raises ValueError at the upload: the reload aborts and the
    prompt prefills cold with the same stream."""
    sched = build_sched(torch_engine(model_path, "bf16"))
    s = sched.new_stream()
    cold = decode_tokens(s, PROMPT)
    entry = sched._download_page(sched._prefix.walk(PROMPT)[0].page_id)
    with sched._cond:  # the upload runs under the scheduler lock
        with pytest.raises(ValueError, match="layout"):
            sched._upload_page_locked(0, entry[:-1])
        with pytest.raises(ValueError):
            sched._upload_page_locked(0, [a.view(np.int16).astype(np.float32) for a in entry])
        with pytest.raises(ValueError):
            sched._upload_page_locked(0, [a[:, :1] for a in entry])
    churn(s, 100)
    prefix = sched._prefix
    chain = tuple(PROMPT[:PAGE])
    assert prefix.spill.has(0, chain)
    prefix.spill.put(0, chain, [np.zeros(3, np.float32)])  # a foreign entry for the first block
    rel0 = sched.spill_uploads
    assert decode_tokens(s, PROMPT) == cold
    assert sched.spill_uploads == rel0
    s.reset()
    sched.check_prefix()
