"""The port's ``chat`` mode and ``generate_on_device`` held against the JAX
package's.

* ``chat``: both packages' CLIs run on the same tiny `.m` (f32 and Q40
  weights) and `.t` (a chatml template), greedy, with the same scripted
  ``input()`` lines: a system prompt and user turns. The tokenizer's chat
  EOS is set to a token the model's greedy reply to the first turn emits,
  so the first turn ends on it and later ones run until it or the end of
  the context. Both print the same text (replies, turn headers, the
  context-limit flush and ``(end of context)``), under ``--decode device``
  (also with ``--spec-draft 2``) and ``--decode host``. The JAX package's
  chat raises EOFError when its input ends; the port ends the session and
  returns it. The port's turns feed exactly the tokens the text implies:
  turn 2's reply equals one prefill of the whole history followed by the
  plain decode.
* ``generate_on_device``: greedy tokens equal the stepwise decode's
  (``tests/test_sampling.py``'s pattern) and the JAX package's; sampled
  tokens equal the JAX package's for the same seed (counter coins) and the
  port's own chunked stream; it advances the position, keeps the stats and
  the device-sampled counter, refuses a context overflow like JAX; over the
  int8 cache (``tests/test_kv_cache.py``'s pattern) it equals the chunked
  stream.
"""

import builtins
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.apps import cli as jcli
from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.formats import synthetic as jsyn
from distributed_llama_tpu.quants import FloatType as JaxFloatType

from distributed_llama_tpu_torch import telemetry as ttel
from distributed_llama_tpu_torch.apps import cli as tcli
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.tokenizer import ChatItem, ChatTemplate, Tokenizer

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=320, seq_len=256)
LINES = ["You are terse.", "hello world", "", "hello hello world"]  # an empty line is asked again
EOS_AT = 3  # the first turn's greedy reply token that becomes the chat EOS


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{"f32": path, "q40": path} of one tiny llama, and the chat `.t`
    whose EOS is the f32 model's 4th greedy reply token to the first turn."""
    d = tmp_path_factory.mktemp("torch_chat")
    out = {}
    for wt, ft in (("f32", JaxFloatType.F32), ("q40", JaxFloatType.Q40)):
        out[wt] = str(d / f"{wt}.m")
        jsyn.write_synthetic_model(out[wt], jsyn.tiny_spec(**SPEC, weights_float_type=ft), seed=5)
    data = dataclasses.replace(tsyn.synthetic_tokenizer_data(vocab_size=SPEC["vocab_size"]),
                               chat_template=tsyn.CHATML_TEMPLATE)
    tok = Tokenizer(data)
    prompt = ChatTemplate("unknown", tok.chat_template, "").generate(
        [ChatItem("system", LINES[0]), ChatItem("user", LINES[1])])
    engine = TorchEngine(out["f32"], dtype=torch.float32, device="cpu")
    first = int(np.argmax(engine.prefill(tok.encode(prompt, add_bos=True))))
    reply = [first] + engine.generate_on_device(first, EOS_AT).tolist()
    data.chat_eos_id = reply[EOS_AT]
    out["tok"] = str(d / "chat.t")
    with open(out["tok"], "wb") as f:
        write_tokenizer_file(f, data)
    return out


def _scripted(monkeypatch, lines):
    feed = list(lines)

    def fake_input(prompt=""):
        if not feed:
            raise EOFError
        return feed.pop(0)

    monkeypatch.setattr(builtins, "input", fake_input)


def _args(files, wt, extra):
    return ["chat", "--model", files[wt], "--tokenizer", files["tok"], "--dtype", wt, "--temperature", "0",
            "--seed", "1", "--decode-chunk", "4", *extra]


def _run_both(monkeypatch, capsys, files, wt, extra):
    """(JAX printed text, whether the JAX chat ended on EOFError, port
    printed text, port session)."""
    _scripted(monkeypatch, LINES)
    try:
        jcli.chat(jcli.build_parser().parse_args(_args(files, wt, extra)))
        j_eof = False
    except EOFError:
        j_eof = True
    jtext = capsys.readouterr().out
    _scripted(monkeypatch, LINES)
    session = tcli.chat(tcli.build_parser().parse_args(_args(files, wt, [*extra, "--device", "cpu"])))
    return jtext, j_eof, capsys.readouterr().out, session


@pytest.mark.parametrize("wt,extra", [
    ("f32", []), ("f32", ["--decode", "host"]), ("f32", ["--spec-draft", "2"]),
    ("f32", ["--max-seq-len", "128"]), ("q40", []), ("q40", ["--decode", "host"]),
], ids=["f32-device", "f32-host", "f32-spec2", "f32-context-end", "q40-device", "q40-host"])
def test_chat_prints_what_jax_prints(monkeypatch, capsys, files, wt, extra):
    jtext, j_eof, ttext, session = _run_both(monkeypatch, capsys, files, wt, extra)
    assert ttext == jtext
    turns = session["turns"]
    assert len(turns) >= 2 and turns[0]["end"] == "eos" and turns[0]["tokens"][-1] == Tokenizer.from_file(
        files["tok"]).chat_eos_id
    assert ttext.count("🤖 Assistant") == len(turns)
    seq_len = 128 if "--max-seq-len" in extra else SPEC["seq_len"]
    if turns[-1]["end"] == "context":  # both ended at the full cache
        assert session["pos"] == seq_len and ttext.endswith("(end of context)\n") and not j_eof
    else:  # both ended when the input did
        assert j_eof and "(end of context)" not in ttext
    if "--max-seq-len" in extra:
        assert turns[-1]["end"] == "context"


def test_chat_feeds_only_the_new_turn(monkeypatch, capsys, files):
    """BOS only at position 0; each later turn feeds only its own rendered
    tokens after the previous reply (its last token, the EOS, unfed); turn
    2's greedy reply equals one prefill of that whole history followed by
    the plain chunked decode; the three decode modes give the same turns."""
    sessions = []
    for extra in ([], ["--decode", "host"], ["--spec-draft", "2"]):
        _scripted(monkeypatch, LINES[:2] + LINES[3:])
        sessions.append(tcli.chat(tcli.build_parser().parse_args(_args(files, "f32", [*extra, "--device", "cpu"]))))
    capsys.readouterr()
    turns = [[(t["prompt_tokens"], t["tokens"], t["end"]) for t in s["turns"]] for s in sessions]
    assert turns[0] == turns[1] == turns[2] and sessions[0]["pos"] == sessions[1]["pos"] == sessions[2]["pos"]
    t1, t2 = sessions[0]["turns"][:2]
    tok = Tokenizer.from_file(files["tok"])
    assert t1["prompt_tokens"][0] == tok.bos_id and tok.bos_id not in t2["prompt_tokens"]
    history = t1["prompt_tokens"] + t1["tokens"][:-1] + t2["prompt_tokens"]
    engine = TorchEngine(files["f32"], dtype=torch.float32, device="cpu")
    first = engine.prefill_device(history, 0.0, 0.9, seed=1)
    want = []
    engine.stream_decode(first, lambda p, t: want.append(t) or len(want) < len(t2["tokens"]), 0.0, 0.9, seed=1,
                         chunk=4, first_prev=history[-1])
    assert want == t2["tokens"]


def test_chat_modes_and_worker_refusal(files):
    """``worker`` parses as in the JAX CLI and refuses, with the JAX
    messages, to run without ``--coordinator`` (before any rendezvous) and
    without ``--prompt`` (after joining the group: here a group of one)."""
    import socket

    parser = tcli.build_parser()
    assert parser.parse_args(["chat", "--model", "m", "--tokenizer", "t"]).mode == "chat"
    argv = ["worker", "--model", files["f32"], "--tokenizer", files["tok"], "--device", "cpu"]
    args = parser.parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv[:5])
    assert (args.mode, args.coordinator, args.num_hosts, args.host_id) == (
        jargs.mode, jargs.coordinator, jargs.num_hosts, jargs.host_id)
    with pytest.raises(SystemExit) as want:
        jcli.worker(jargs)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + ["--prompt", "hello"])
    assert str(got.value) == str(want.value) == tcli.NO_COORDINATOR
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + ["--coordinator", f"127.0.0.1:{port}", "--num-hosts", "1", "--host-id", "0"])
    assert str(got.value) == tcli.NO_PROMPT and "requires the SAME --prompt" in tcli.NO_PROMPT


# ---------------------------------------------------------------------------
# generate_on_device
# ---------------------------------------------------------------------------

PROMPT = [1, 5, 9]


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 5), (0.9, 17)])
def test_generate_on_device_matches_jax(files, temperature, seed):
    """One dispatch of 8 tokens: the JAX package's tokens for the same first
    token and seed; greedy, also the stepwise decode's; the position, stats
    and the device-sampled counter advance by 8."""
    je = JaxEngine(files["f32"], dtype=jnp.float32)
    ttel.reset()
    ttel.enable()
    try:
        te = TorchEngine(files["f32"], dtype=torch.float32, device="cpu")
        first = int(np.argmax(te.prefill(PROMPT)))
        assert first == int(np.argmax(je.prefill(PROMPT)))
        n_stats = len(te.stats)
        got = te.generate_on_device(first, 8, temperature=temperature, seed=seed)
        text = ttel.prometheus_text()
    finally:
        ttel.disable()
        ttel.reset()
    want = np.asarray(je.generate_on_device(first, 8, temperature=temperature, seed=seed))
    assert got.tolist() == want.tolist() and len(got) == 8
    assert te.pos == je.pos == len(PROMPT) + 8 and len(te.stats) == n_stats + 8
    assert "dllama_device_sampled_tokens_total 8" in text
    if temperature == 0.0:
        step = TorchEngine(files["f32"], dtype=torch.float32, device="cpu")
        token = int(np.argmax(step.prefill(PROMPT)))
        stepwise = []
        for _ in range(8):
            token = int(np.argmax(step.decode_step(token)))
            stepwise.append(token)
        assert got.tolist() == stepwise


@pytest.mark.parametrize("cache_dtype", [None, "i8"])
def test_generate_on_device_equals_the_chunked_stream(files, cache_dtype):
    """The single dispatch and the chunked decode give the same tokens for
    the same first token and seed (the bf16 and the int8 cache)."""
    out = []
    for run in ("loop", "chunks"):
        te = TorchEngine(files["q40"], dtype="q40", device="cpu", cache_dtype=cache_dtype)
        first = int(np.argmax(te.prefill(PROMPT)))
        if run == "loop":
            out.append(te.generate_on_device(first, 6, temperature=0.8, seed=3).tolist())
        else:
            gen = te.generate_chunks(first, 0.8, 0.9, seed=3, chunk=4, limit=te.pos + 6)
            out.append([next(gen) for _ in range(6)])
    assert out[0] == out[1] and all(0 <= t < SPEC["vocab_size"] for t in out[0])


def test_generate_on_device_context_overflow_like_jax(files):
    for engine in (JaxEngine(files["f32"], dtype=jnp.float32, max_seq_len=8),
                   TorchEngine(files["f32"], dtype=torch.float32, device="cpu", max_seq_len=8)):
        engine.prefill([1, 2, 3, 4])
        with pytest.raises(ValueError, match="context overflow"):
            engine.generate_on_device(5, 10)
        assert engine.pos == 4
        assert len(engine.generate_on_device(5, 4)) == 4 and engine.pos == 8
