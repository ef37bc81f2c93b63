"""The port's C++ host library (``distributed_llama_tpu_torch/native.py``,
``csrc/host/``) held against its plain versions and the JAX package.

``Tokenizer.encode`` (the native merge) against ``Tokenizer.encode_plain``
and the JAX ``Tokenizer.encode`` on seeded random UTF-8 text over a vocab
from the port's synthetic tokenizer widened with merge pieces; the Q40 f32
dequant against ``dequantize_q40`` and the JAX ``deserialize_tensor`` byte
for byte; a build with a broken compiler raises on every path.
"""

import threading

import numpy as np
import pytest

from distributed_llama_tpu import native as jnative
from distributed_llama_tpu import quants as jquants
from distributed_llama_tpu.formats.tokenizer_file import TokenizerData as JaxTokenizerData
from distributed_llama_tpu.tokenizer import Tokenizer as JaxTokenizer

from distributed_llama_tpu_torch import native, quants
from distributed_llama_tpu_torch.formats import synthetic
from distributed_llama_tpu_torch.formats.model_file import ModelFileReader
from distributed_llama_tpu_torch.formats.tokenizer_file import TokenizerData
from distributed_llama_tpu_torch.tokenizer import Tokenizer

# characters the widened vocab holds as pieces, and characters it lacks
# (their UTF-8 bytes take the byte fallback)
KNOWN = list("abcdefghijklmnopqrstuvwxyz ABCDEFGHIJ0123456789.,!?'\n") + ["é", "ö", "日", "本", "🙂"]
UNKNOWN = ["ß", "ж", "語", "🚀", "\x00", "\x7f", "\t"]


def _vocab(seed: int):
    """The synthetic vocab plus every KNOWN character and seeded merge
    pieces (bigrams, trigrams, words, one duplicate) with random scores,
    some of them tied."""
    base = synthetic.synthetic_tokenizer_data()
    rng = np.random.default_rng(seed)
    vocab, scores = list(base.vocab), list(base.scores)
    pieces = [c.encode() for c in KNOWN]
    for n in (2, 2, 2, 3, 3, 5):
        for _ in range(40):
            pieces.append("".join(rng.choice(KNOWN[:30], n)).encode())
    pieces += [b" the", b"the", b" hello world", "日本".encode(), "é!".encode(), b"he"]  # b"he" duplicates
    for p in pieces:
        vocab.append(p)
        scores.append(float(rng.integers(-40, 0)) / 4)  # quarter steps: ties happen
    fields = dict(vocab=vocab, scores=scores, bos_id=1, eos_id=2, chat_eos_id=2)
    return Tokenizer(TokenizerData(**fields)), JaxTokenizer(JaxTokenizerData(**fields))


def _texts(seed: int, n: int = 12) -> list[str]:
    rng = np.random.default_rng(seed)
    alphabet = KNOWN + UNKNOWN
    out = ["", " ", "hello world", "日本語 🙂 ß"]
    for _ in range(n):
        out.append("".join(rng.choice(alphabet, int(rng.integers(1, 120)))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_encode_equals_plain_and_jax(seed):
    ours, theirs = _vocab(seed)
    native.reset_launches()
    n = 0
    for text in _texts(seed):
        for bos, eos in ((False, False), (True, False), (True, True)):
            got = ours.encode(text, add_bos=bos, add_eos=eos)
            assert got == ours.encode_plain(text, add_bos=bos, add_eos=eos), repr(text)
            assert got == theirs.encode(text, add_bos=bos, add_eos=eos), repr(text)
            n += 1
        # bytes in, and invalid UTF-8 (a lone continuation byte, a cut
        # sequence); a text that begins with a continuation byte against
        # the JAX package's Python encode (its native one glues the dummy
        # space to that byte: test_jax_native_glues_the_dummy_space_on)
        raw = text.encode() + b"\x80\xe6\x97"
        assert ours.encode(raw) == ours.encode_plain(raw) == _jax_plain(theirs, raw)
        n += 1
    assert native.launches["bpe_encode_after"] == n  # every encode ran the library


@pytest.mark.parametrize("seed", [3, 4])
def test_native_encode_of_a_long_text_equals_plain(seed):
    """~1500 characters: hundreds of merges, many of them at tied scores,
    in the order the plain scan makes them."""
    ours, _ = _vocab(seed)
    rng = np.random.default_rng(seed)
    text = "".join(rng.choice(KNOWN[:30] + UNKNOWN[:2], 1500))
    assert ours.encode(text, add_bos=True) == ours.encode_plain(text, add_bos=True)


def _jax_plain(tok: JaxTokenizer, text: bytes) -> list[int]:
    """The JAX package's Python encode (its native handle set aside)."""
    saved, tok._native = tok._native, None
    try:
        return tok.encode(text)
    finally:
        tok._native = saved


def test_jax_native_glues_the_dummy_space_on():
    """The reference's native encode prefixes a literal space to the text,
    which glues the space to a leading UTF-8 continuation byte: its ids for
    such a text differ from its Python encode's. The port's library starts
    from the space token, as both Python encodes do."""
    ours, theirs = _vocab(0)
    assert theirs._native is not None  # the reference's library is built
    for raw in (b"\x80abc", b"\xbf\xbf hello", b"\x80" + "日本".encode()):
        assert ours.encode(raw) == ours.encode_plain(raw) == _jax_plain(theirs, raw)
    raw = b"\x80abc"
    assert theirs.encode(raw)[0] == ord(" ") + 3 != ours.encode(raw)[0] == ours.vocab.index(b" ")


def test_synthetic_tokenizer_merges_like_plain():
    """The plain synthetic vocab the servers' tests use, with its greedy
    " hello"/" world" merges."""
    tok = Tokenizer(synthetic.synthetic_tokenizer_data(vocab_size=512))
    for text in ("hello world", "hello hello world, hello", "worldhello", ""):
        assert tok.encode(text, add_bos=True) == tok.encode_plain(text, add_bos=True)
    assert tok.encode("hello world") == [tok.vocab.index(b" hello"), tok.vocab.index(b" world")]


def test_native_refuses_what_it_cannot_read():
    """A byte fallback past a vocab without the byte pieces raises (the
    plain merge raises IndexError there too); a Q40 buffer shorter than its
    values raises before the library reads it."""
    tok = Tokenizer(TokenizerData(vocab=[b"<unk>", b"<s>", b"</s>", b"a", b"b"], scores=[0.0] * 5, bos_id=1,
                                  eos_id=2))
    with pytest.raises(IndexError):
        tok.encode_plain("zz")
    with pytest.raises(IndexError):
        tok.encode("zz")
    with pytest.raises(ValueError):
        native.q40_dequant_f32(np.zeros(17, np.uint8), 32)
    with pytest.raises(ValueError):
        native.q40_dequant_f32(np.zeros(18, np.uint8), 33)


def _q40_bytes(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return np.frombuffer(quants.q40_to_bytes(*quants.quantize_q40(x)), np.uint8), x.size


@pytest.mark.parametrize("shape", [(32,), (4096,), (96, 512)])
def test_native_dequant_equals_numpy_and_jax(shape):
    raw, n = _q40_bytes(shape, 3)
    native.reset_launches()
    got = quants.deserialize_tensor(raw, quants.FloatType.Q40, n)
    assert native.launches["q40_dequant_f32"] == 1
    plain = quants.dequantize_q40(*quants.q40_from_bytes(raw, n))
    jax_got = jquants.deserialize_tensor(raw.tobytes(), jquants.FloatType.Q40, n)
    assert got.dtype == np.float32 and got.shape == (n,)
    assert got.tobytes() == plain.tobytes() == jax_got.tobytes()


def test_native_dequant_every_f16_scale():
    """Every f16 bit pattern as a block scale (subnormals, infinities and
    NaNs included), random nibbles: byte for byte the numpy version."""
    blocks = np.zeros((1 << 16, quants.Q40_BLOCK_BYTES), np.uint8)
    blocks[:, :2] = np.arange(1 << 16, dtype=np.uint16).view(np.uint8).reshape(-1, 2)
    blocks[:, 2:] = np.random.default_rng(4).integers(0, 256, (1 << 16, 16))
    n = blocks.shape[0] * quants.QK
    got = quants.deserialize_tensor(blocks.reshape(-1), quants.FloatType.Q40, n)
    with np.errstate(invalid="ignore"):
        plain = quants.dequantize_q40(*quants.q40_from_bytes(blocks.reshape(-1), n))
    assert got.tobytes() == plain.tobytes()


def test_jax_native_halves_subnormal_scales():
    """The reference's native dequant (``native/q40_native.cpp``
    ``f16_to_f32``) writes a subnormal f16 scale with a biased exponent one
    short, half its value; the JAX package's numpy version and the port's
    library give the exact value. Blocks with normal scales agree."""
    assert jnative.available()
    scales = np.array([1, 0x3FF, 0x8001, 0x200, 0x3C00, 0x1234], np.uint16)  # 4 subnormal, 2 normal
    blocks = np.zeros((scales.size, quants.Q40_BLOCK_BYTES), np.uint8)
    blocks[:, :2] = scales.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:] = np.random.default_rng(5).integers(0, 256, (scales.size, 16))
    raw, n = blocks.reshape(-1), scales.size * quants.QK
    ours = quants.deserialize_tensor(raw, quants.FloatType.Q40, n).reshape(-1, quants.QK)
    theirs = jnative.q40_dequant_f32(raw, n).reshape(-1, quants.QK)
    np.testing.assert_array_equal(ours, jquants.dequantize_q40(*jquants.q40_from_bytes(raw, n)).reshape(-1, quants.QK))
    np.testing.assert_array_equal(theirs[:4] * 2, ours[:4])
    np.testing.assert_array_equal(theirs[4:], ours[4:])


def test_model_reader_reads_q40_through_the_library(tmp_path):
    spec = synthetic.tiny_spec(dim=64, hidden_dim=128, vocab_size=512, seq_len=32,
                               weights_float_type=quants.FloatType.Q40)
    path = synthetic.write_synthetic_model(str(tmp_path / "m.m"), spec)
    reader = ModelFileReader(path)
    entry = next(e for e in reader.entries.values() if e.float_type == quants.FloatType.Q40)
    native.reset_launches()
    got = reader.tensor(entry.name)
    assert native.launches["q40_dequant_f32"] == 1
    want = quants.dequantize_q40(*quants.q40_from_bytes(reader.raw(entry.name), entry.n_values)).reshape(entry.shape)
    assert got.tobytes() == want.tobytes()


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "host"


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_broken_compiler_raises_on_every_path(fresh_build, monkeypatch, cxx):
    monkeypatch.setattr(native, "CXX", cxx)
    tok = Tokenizer(synthetic.synthetic_tokenizer_data())
    raw, n = _q40_bytes((64,), 6)
    with pytest.raises(RuntimeError, match="not found" if cxx.startswith("/") else "failed"):
        tok.encode("hello")
    with pytest.raises(RuntimeError):
        quants.deserialize_tensor(raw, quants.FloatType.Q40, n)
    with pytest.raises(RuntimeError):
        native.NativeBpe([b"a"], [0.0])
    assert native._lib is None
    assert not list(fresh_build.glob("*.so")) if fresh_build.exists() else True


def test_concurrent_builds_leave_one_whole_library(fresh_build):
    """Builds started at once each write aside and rename: one library,
    every caller's path loads, no temporary file is left."""
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in fresh_build.iterdir()] == [paths[0].name]
    assert native.load_library().q40_dequant_f32 is not None
