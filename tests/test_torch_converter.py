"""The port's converters held against the JAX package's, byte for byte.

* The safetensors reader (numpy alone) against ``safetensors.numpy`` on
  F32, F16 and integer files, one file and several; BF16 raises TypeError
  in both packages' readers.
* ``convert_hf``: the port's `.m` equals the JAX converter's, byte for
  byte, on tiny synthetic checkpoints under llama (also with llama3 rope
  scaling, and tied embeddings), mistral, mixtral and grok-1 naming, F32,
  F16 and Q40 weights, split over several files with an index; and equals
  the file ``ModelFileWriter`` writes directly from the `.m`-layout
  tensors the checkpoint was made from (Q/K un-permuted into it).
* The tokenizer converters: ``tokenizer.json`` BPE (with a chat template
  and an extra stop), tiktoken base64 and sentencepiece (skipped while the
  ``sentencepiece`` package is absent, as in the JAX package's tests): the
  same `.t` bytes.
* ``convert_meta_pth`` on one- and two-shard ``consolidated.*.pth``: the
  same `.m` bytes.
* ``launch.py`` with ``urllib.request.urlopen`` replaced in both packages
  (nothing reaches the network): the same bytes downloaded, the same
  command after the program name.
* Each module's ``main``: the same output file.
"""

import base64
import filecmp
import json
import urllib.request

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

from distributed_llama_tpu.converter import hf as jhf
from distributed_llama_tpu.converter import launch as jlaunch
from distributed_llama_tpu.converter import pth as jpth
from distributed_llama_tpu.converter import tokenizers as jtok
from distributed_llama_tpu.quants import FloatType as JFloatType

from distributed_llama_tpu_torch import converter as tconverter
from distributed_llama_tpu_torch.converter import hf as thf
from distributed_llama_tpu_torch.converter import launch as tlaunch
from distributed_llama_tpu_torch.converter import pth as tpth
from distributed_llama_tpu_torch.converter import tokenizers as ttok
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.model_file import ArchType, HiddenAct, ModelFileReader, RopeType
from distributed_llama_tpu_torch.quants import FloatType, parse_float_type

QUIET = dict(progress=lambda *a: None)

# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------


def _tensors(dtype, seed=0):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return {f"t{i}": rng.randint(-100, 100, size=s).astype(dtype) for i, s in enumerate([(3, 5), (7,), (2, 2, 4)])}
    return {f"t{i}": rng.randn(*s).astype(dtype) for i, s in enumerate([(3, 5), (7,), (2, 2, 4), (1, 64)])}


@pytest.mark.parametrize("n_files", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_safetensors_reader_equals_the_package(tmp_path, dtype, n_files):
    """Files the safetensors package writes read back the same through the
    port's lazy multi-file lookup as through the package, dtype, shape and
    bytes; files the port writes read back the same through the package."""
    t = _tensors(dtype)
    names = list(t)
    files = []
    for i in range(n_files):
        files.append(str(tmp_path / f"p{i}.safetensors"))
        save_file({k: t[k] for k in names[i::n_files]}, files[-1])
    lazy = thf._LazySafetensors(files)
    for name in reversed(names):  # a miss scans forward, then from the start
        with safe_open(files[names.index(name) % n_files], framework="np", device="cpu") as f:
            want = f.get_tensor(name)
        got = lazy.get(name)
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), name
    with pytest.raises(KeyError):
        lazy.get("absent")
    mine = str(tmp_path / "mine.safetensors")
    thf.write_safetensors(mine, t, {"format": "pt"})
    with safe_open(mine, framework="np", device="cpu") as f:
        assert sorted(f.keys()) == sorted(names) and f.metadata() == {"format": "pt"}
        for name in names:
            assert np.array_equal(f.get_tensor(name), t[name]) and f.get_tensor(name).dtype == dtype


def test_bf16_raises_typeerror_in_both(tmp_path):
    """Neither converter takes a BF16 checkpoint (a limit the two packages
    share): run as a program, each raises TypeError naming bfloat16. (The
    JAX package's reader returns bfloat16 arrays only in a process where
    ml_dtypes registered the type, as importing jax does; its converter
    program does not import it.) The port raises in any process."""
    import subprocess
    import sys
    from pathlib import Path

    from safetensors.torch import save_file as save_torch

    spec = tsyn.tiny_spec(**_BASE)
    src = tmp_path / "hf_bf16"
    src.mkdir()
    (src / "config.json").write_text(json.dumps(tsyn.hf_config(spec, "llama")))
    from distributed_llama_tpu_torch.converter.hf import hf_tensor_plan

    save_torch({h: torch.from_numpy(tsyn.random_tensors(spec)[m]).to(torch.bfloat16)
                for m, h, _ in hf_tensor_plan(spec)}, str(src / "model.safetensors"))
    root = str(Path(__file__).resolve().parents[1])
    for pkg in ("distributed_llama_tpu", "distributed_llama_tpu_torch"):
        run = subprocess.run([sys.executable, "-m", f"{pkg}.converter.hf", str(src), "q40", "x"], cwd=tmp_path,
                             capture_output=True, text=True, env={"PYTHONPATH": root, "PATH": "/usr/bin:/bin"},
                             timeout=120)
        assert run.returncode != 0 and "TypeError" in run.stderr and "bfloat16" in run.stderr.lower(), run.stderr
    with pytest.raises(TypeError, match="BF16"):
        thf.convert_hf(str(src), FloatType.F32, str(tmp_path / "x.m"), **QUIET)


def test_permute_inverse_and_float_type_names():
    w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    assert np.array_equal(thf.permute_qk(w, 2), jhf.permute_qk(w, 2))
    assert np.array_equal(thf.unpermute_qk(thf.permute_qk(w, 2), 2), w)
    assert tconverter.permute_qk is thf.permute_qk and tconverter.convert_hf is thf.convert_hf
    for name in ("f32", "F16", "q40", "Q80"):
        assert int(parse_float_type(name)) == int(JFloatType[name.upper()])
    with pytest.raises(ValueError):
        parse_float_type("bf16")


# ---------------------------------------------------------------------------
# Hugging Face checkpoints
# ---------------------------------------------------------------------------

_BASE = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96, seq_len=64)
ARCHS = {
    "llama": ("llama", dict(), {}),
    "llama_rope_scaling": ("llama", dict(), {"rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32}, "rope_theta": 500000.0}),
    "llama_tied": ("llama", dict(), {"tie_word_embeddings": True}),
    "mistral": ("mistral", dict(), {}),
    "mixtral": ("mixtral", dict(arch_type=ArchType.MIXTRAL, n_experts=4, n_active_experts=2), {}),
    "grok": ("grok-1", dict(arch_type=ArchType.GROK1, n_experts=4, n_active_experts=2,
                             hidden_act=HiddenAct.GELU), {"hidden_act": None}),
}


def _checkpoint(tmp_path, arch, dtype=np.float32, n_files=2, seed=0):
    """A synthetic checkpoint of ``arch`` (its `.m`-named tensors kept):
    float32 tensors, or for float16 the chip smoke's fast random draw."""
    model_type, over, extra = ARCHS[arch]
    spec = tsyn.tiny_spec(**{**_BASE, **over})
    if dtype == np.float16:
        tensors = tsyn.random_f16_tensors(spec, seed=seed)
    else:
        tensors = {k: v.astype(dtype) for k, v in tsyn.random_tensors(spec, seed=seed).items()}
    if extra.get("tie_word_embeddings"):
        tensors["wcls"] = tensors["embedding"]
    config = tsyn.hf_config(spec, model_type, **extra)
    if config.get("hidden_act") is None:
        del config["hidden_act"]  # grok-1 configs may omit it
    src = tmp_path / f"hf_{arch}"
    tsyn.write_hf_checkpoint(str(src), spec, tensors, config, n_files=n_files)
    return str(src), tensors


@pytest.mark.parametrize("wt", ["f32", "f16", "q40"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_convert_hf_equals_jax_byte_for_byte(tmp_path, arch, wt):
    """The same `.m` bytes from both converters, and the same header."""
    src, _ = _checkpoint(tmp_path, arch, n_files=2 if arch != "llama_tied" else 1)
    jout, tout = str(tmp_path / "j.m"), str(tmp_path / "t.m")
    jspec = jhf.convert_hf(src, JFloatType[wt.upper()], jout, **QUIET)
    tspec = thf.convert_hf(src, FloatType[wt.upper()], tout, **QUIET)
    assert filecmp.cmp(jout, tout, shallow=False)
    assert (tspec.arch_type, tspec.rope_type, tspec.n_experts, tspec.seq_len) == (
        int(jspec.arch_type), int(jspec.rope_type), jspec.n_experts, jspec.seq_len)
    assert ModelFileReader(tout).spec.resolved_rope_type() == {
        "grok": RopeType.FALCON, "llama_rope_scaling": RopeType.LLAMA3_1}.get(arch, RopeType.LLAMA)


@pytest.mark.parametrize("arch", ["llama", "mixtral", "grok"])
def test_convert_hf_equals_the_direct_write(tmp_path, arch):
    """A checkpoint made from `.m`-layout F16 tensors (Q/K un-permuted
    into the HF layout) converts to the file ModelFileWriter writes from
    those tensors, byte for byte, Q40 (the chip smoke's 13a gate, small)."""
    src, tensors = _checkpoint(tmp_path, arch, dtype=np.float16, n_files=3)
    assert all(np.isfinite(v.astype(np.float32)).all() for v in tensors.values())
    out, direct = str(tmp_path / "c.m"), str(tmp_path / "d.m")
    spec = thf.convert_hf(src, FloatType.Q40, out, **QUIET)
    tsyn.write_model_file(direct, spec, {k: v.astype(np.float32) for k, v in tensors.items()})
    assert filecmp.cmp(out, direct, shallow=False)
    assert json.loads((tmp_path / f"hf_{arch}" / "model.safetensors.index.json").read_text())["weight_map"]


def test_convert_hf_refusals_equal_jax(tmp_path):
    src, _ = _checkpoint(tmp_path, "llama", n_files=1)
    cfg = json.loads((tmp_path / "hf_llama" / "config.json").read_text())
    for bad, exc in (({"model_type": "gpt2"}, ValueError), ({"hidden_act": None}, ValueError),
                     ({"rope_scaling": {"rope_type": "yarn"}}, ValueError)):
        c = {**cfg, **bad}
        if c.get("hidden_act") is None:
            c.pop("hidden_act")
        for mod, ft in ((jhf, JFloatType.F32), (thf, FloatType.F32)):
            with pytest.raises(exc):
                mod.spec_from_hf_config(c, ft)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps(cfg))
    for mod, ft in ((jhf, JFloatType.F32), (thf, FloatType.F32)):
        with pytest.raises(FileNotFoundError):
            mod.convert_hf(str(empty), ft, str(tmp_path / "x.m"), **QUIET)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["chatml", "no_template", "extra_stop", "named_eos"])
def test_hf_tokenizer_equals_jax(tmp_path, case):
    """tokenizer.json BPE vocabularies: the same `.t` bytes and fields."""
    d = str(tmp_path / "tok")
    kw = {"chatml": {}, "no_template": dict(chat_template=None), "extra_stop": {},
          "named_eos": dict(added=(), eos_token="</s>")}[case]
    tsyn.write_hf_tokenizer(d, 600, **kw)
    stop = "ab" if case == "extra_stop" else None
    jd = jtok.convert_hf_tokenizer(d, str(tmp_path / "j.t"), stop)
    td = ttok.convert_hf_tokenizer(d, str(tmp_path / "t.t"), stop)
    assert filecmp.cmp(str(tmp_path / "j.t"), str(tmp_path / "t.t"), shallow=False)
    assert (td.bos_id, td.eos_id, td.chat_eos_id, td.chat_stop) == (jd.bos_id, jd.eos_id, jd.chat_eos_id,
                                                                    jd.chat_stop)
    assert td.eos_id == (599 if case != "named_eos" else 2)


def test_hf_tokenizer_refusals_equal_jax(tmp_path):
    d = tmp_path / "tok"
    tsyn.write_hf_tokenizer(str(d), 300)
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    (d / "tokenizer_config.json").write_text(json.dumps({**cfg, "tokenizer_class": "BertTokenizer"}))
    for mod in (jtok, ttok):
        with pytest.raises(ValueError, match="not supported"):
            mod.convert_hf_tokenizer(str(d), str(tmp_path / "x.t"))
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    tok = json.loads((d / "tokenizer.json").read_text())
    (d / "tokenizer.json").write_text(json.dumps({**tok, "model": {**tok["model"], "type": "Unigram"}}))
    for mod in (jtok, ttok):
        with pytest.raises(ValueError, match="BPE"):
            mod.convert_hf_tokenizer(str(d), str(tmp_path / "x.t"))


def test_llama3_tokenizer_equals_jax(tmp_path):
    """A tiktoken base64 vocab: the same `.t` bytes, the 256 special tokens
    and the llama3 chat template."""
    lines = [f"{base64.b64encode(tok).decode()} {i}" for i, tok in enumerate(
        [b"a", b"b", b"ab", b" ", b"\xe2\x82", b"\xac", b"hello", b" world"])]
    path = tmp_path / "tokenizer.model"
    path.write_text("\n".join(lines) + "\n\n")
    jd = jtok.convert_llama3_tokenizer(str(path), str(tmp_path / "j.t"))
    td = ttok.convert_llama3_tokenizer(str(path), str(tmp_path / "t.t"))
    assert filecmp.cmp(str(tmp_path / "j.t"), str(tmp_path / "t.t"), shallow=False)
    assert td.vocab == jd.vocab and len(td.vocab) == 8 + ttok.LLAMA3_N_SPECIAL
    assert ttok.LLAMA3_CHAT_TEMPLATE == jtok.LLAMA3_CHAT_TEMPLATE
    assert ttok.LLAMA2_CHAT_TEMPLATE == jtok.LLAMA2_CHAT_TEMPLATE


def test_sentencepiece_tokenizer_equals_jax(tmp_path):
    """A Llama-2 ``tokenizer.model``: needs the sentencepiece package."""
    spm = pytest.importorskip("sentencepiece")
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("hello world, the quick brown fox jumps over the lazy dog\n" * 50)
    spm.SentencePieceTrainer.train(input=str(corpus), model_prefix=str(tmp_path / "tokenizer"), vocab_size=40)
    jtok.convert_llama2_tokenizer(str(tmp_path), str(tmp_path / "j.t"))
    ttok.convert_llama2_tokenizer(str(tmp_path), str(tmp_path / "t.t"))
    assert filecmp.cmp(str(tmp_path / "j.t"), str(tmp_path / "t.t"), shallow=False)


def test_sentencepiece_is_imported_only_to_convert(tmp_path, monkeypatch):
    """The port's converter imports without sentencepiece; a LlamaTokenizer
    folder reaches for it only when converted, and without the package both
    converters raise ImportError there."""
    import builtins

    real = builtins.__import__

    def no_spm(name, *a, **kw):
        if name.split(".")[0] == "sentencepiece":
            raise ModuleNotFoundError("No module named 'sentencepiece'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_spm)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "LlamaTokenizer"}))
    for mod in (jtok, ttok):
        with pytest.raises(ImportError, match="sentencepiece"):
            mod.convert_hf_tokenizer(str(tmp_path), str(tmp_path / "x.t"))
        with pytest.raises(ImportError, match="sentencepiece"):
            mod.convert_llama2_tokenizer(str(tmp_path), str(tmp_path / "x.t"))


# ---------------------------------------------------------------------------
# Meta .pth checkpoints
# ---------------------------------------------------------------------------


def _meta_checkpoint(tmp_path, n_shards, n_kv_heads=None):
    dim, hidden, vocab, n_layers, n_heads = 64, 96, 32, 2, 4
    rng = np.random.RandomState(n_shards)
    full = {"tok_embeddings.weight": rng.randn(vocab, dim)}
    kv = dim * (n_kv_heads or n_heads) // n_heads
    for l in range(n_layers):
        p = f"layers.{l}."
        for name, shape in (("attention.wq", (dim, dim)), ("attention.wk", (kv, dim)), ("attention.wv", (kv, dim)),
                            ("attention.wo", (dim, dim)), ("feed_forward.w1", (hidden, dim)),
                            ("feed_forward.w2", (dim, hidden)), ("feed_forward.w3", (hidden, dim))):
            full[p + name + ".weight"] = rng.randn(*shape)
        full[p + "attention_norm.weight"] = 1 + 0.1 * rng.randn(dim)
        full[p + "ffn_norm.weight"] = 1 + 0.1 * rng.randn(dim)
    full["norm.weight"] = 1 + 0.1 * rng.randn(dim)
    full["output.weight"] = rng.randn(vocab, dim)
    d = tmp_path / f"meta{n_shards}"
    d.mkdir()
    for s in range(n_shards):
        shard = {}
        for name, t in full.items():
            if t.ndim == 1:
                shard[name] = torch.from_numpy(t.astype(np.float32))
            else:
                axis = 1 if name.endswith(("tok_embeddings.weight", "attention.wo.weight", "feed_forward.w2.weight")) \
                    else 0
                shard[name] = torch.from_numpy(np.ascontiguousarray(
                    np.split(t, n_shards, axis=axis)[s]).astype(np.float32)).to(torch.bfloat16)
        torch.save(shard, d / f"consolidated.{s:02d}.pth")
    params = {"dim": dim, "n_layers": n_layers, "n_heads": n_heads, "vocab_size": vocab, "max_seq_len": 48,
              "norm_eps": 1e-5}
    if n_kv_heads:
        params["n_kv_heads"] = n_kv_heads
    (d / "params.json").write_text(json.dumps(params))
    return str(d)


@pytest.mark.parametrize("wt", ["f32", "q40"])
@pytest.mark.parametrize("n_shards,n_kv_heads", [(1, None), (2, 2)])
def test_convert_meta_pth_equals_jax(tmp_path, n_shards, n_kv_heads, wt):
    src = _meta_checkpoint(tmp_path, n_shards, n_kv_heads)
    jspec = jpth.convert_meta_pth(src, JFloatType[wt.upper()], str(tmp_path / "j.m"), **QUIET)
    tspec = tpth.convert_meta_pth(src, FloatType[wt.upper()], str(tmp_path / "t.m"), **QUIET)
    assert filecmp.cmp(str(tmp_path / "j.m"), str(tmp_path / "t.m"), shallow=False)
    assert (tspec.hidden_dim, tspec.n_kv_heads) == (jspec.hidden_dim, jspec.n_kv_heads) == (96, n_kv_heads or 4)


def test_convert_meta_pth_refusals_equal_jax(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    for params, exc in (({"vocab_size": -1, "max_seq_len": 8}, ValueError), ({"vocab_size": 8}, ValueError),
                        ({"vocab_size": 8, "max_seq_len": 8}, FileNotFoundError)):
        (d / "params.json").write_text(json.dumps(params))
        for mod, ft in ((jpth, JFloatType.F32), (tpth, FloatType.F32)):
            with pytest.raises(exc):
                mod.convert_meta_pth(str(d), ft, str(tmp_path / "x.m"), **QUIET)


# ---------------------------------------------------------------------------
# the command-line entry points
# ---------------------------------------------------------------------------


def test_mains_write_the_same_files(tmp_path, monkeypatch, capsys):
    """Each converter's ``main``, run from a directory of its own, writes
    the file the JAX package's ``main`` writes, under the same name."""
    src, _ = _checkpoint(tmp_path, "mixtral", n_files=2)
    tok = tmp_path / "tok"
    tsyn.write_hf_tokenizer(str(tok), 300)
    meta = _meta_checkpoint(tmp_path, 2)
    outs = {}
    for pkg, mods in (("jax", (jhf, jtok, jpth)), ("torch", (thf, ttok, tpth))):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        hf, tk, pt = mods
        hf.main([src, "q40", "tiny"])
        tk.main(["hf", str(tok), "tiny", "--chat-extra-stop", "zz"])
        pt.main([meta, "f32"])
        outs[pkg] = d
    names = sorted(p.name for p in outs["jax"].iterdir())
    assert names == sorted(p.name for p in outs["torch"].iterdir()) == [
        "dllama_model_meta2_f32.m", "dllama_model_tiny_q40.m", "dllama_tokenizer_tiny.t"]
    for name in names:
        assert filecmp.cmp(outs["jax"] / name, outs["torch"] / name, shallow=False), name
    assert "created successfully" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# launch.py
# ---------------------------------------------------------------------------


class _FakeResponse:
    def __init__(self, body: bytes):
        self.body, self.at = body, 0

    def read(self, n):
        chunk = self.body[self.at : self.at + n]
        self.at += len(chunk)
        return chunk

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_urlopen(monkeypatch):
    """``urllib.request.urlopen`` answering every URL with bytes derived
    from it (2.5 MiB, so a download spans several 1 MiB reads); the URLs
    asked for are recorded. Both packages call this one function."""
    asked = []

    def urlopen(url, *a, **kw):
        asked.append(url)
        seed = sum(url.encode()) % 251
        return _FakeResponse(bytes((seed + i) % 256 for i in range(256)) * (10 * 1024) + url.encode())

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return asked


@pytest.mark.parametrize("name", ["tinyllama_1_1b_3t_q40", "llama3_1_8b_instruct_q40"])
def test_launch_downloads_and_commands_equal_jax(tmp_path, fake_urlopen, name, capsys):
    assert tlaunch.MODELS == jlaunch.MODELS
    cmds, files = {}, {}
    for pkg, mod in (("jax", jlaunch), ("torch", tlaunch)):
        root = tmp_path / pkg
        cmds[pkg] = mod.launch(name, models_dir=str(root))
        files[pkg] = root / name
    assert fake_urlopen[: len(fake_urlopen) // 2] == fake_urlopen[len(fake_urlopen) // 2 :]
    for f in sorted(p.name for p in files["jax"].iterdir()):
        assert filecmp.cmp(files["jax"] / f, files["torch"] / f, shallow=False), f
    assert not any(p.name.endswith(".partial") for p in files["torch"].iterdir())
    assert cmds["jax"][0] == "dllama-tpu" and cmds["torch"][0] == "dllama-torch"
    strip = [c.replace(str(tmp_path / "jax"), "R") for c in cmds["jax"][1:]]
    assert strip == [c.replace(str(tmp_path / "torch"), "R") for c in cmds["torch"][1:]]
    assert cmds["torch"][1] == ("chat" if "instruct" in name else "inference")
    # a second launch keeps the files: nothing is fetched again
    n = len(fake_urlopen)
    tlaunch.launch(name, models_dir=str(tmp_path / "torch"))
    assert len(fake_urlopen) == n and "already exists, skipping download" in capsys.readouterr().out


def test_launch_parts_usage_and_cli_parses(tmp_path, fake_urlopen, capsys):
    """A model split into URL parts concatenates them in order; an unknown
    name prints the usage in both packages; every registry command parses
    with the port's CLI."""
    from distributed_llama_tpu_torch.apps import cli as tcli

    urls = jlaunch.MODELS["llama3_1_405b_instruct_q40"][0][:3]
    for mod in (jlaunch, tlaunch):
        mod.download_file(urls, str(tmp_path / f"{mod.__name__.split('.')[0]}.bin"), progress=lambda *a: None)
    assert filecmp.cmp(tmp_path / "distributed_llama_tpu.bin", tmp_path / "distributed_llama_tpu_torch.bin",
                       shallow=False)
    assert tlaunch._parts(56) == jlaunch._parts(56) and tlaunch._parts(56)[-1] == "cd"
    for mod in (jlaunch, tlaunch):
        with pytest.raises(SystemExit):
            mod.main(["nope"])
    out = capsys.readouterr().out
    assert out.count("Available models:") == 2
    for name in tlaunch.MODELS:
        cmd = tlaunch.launch_command(name, str(tmp_path))
        assert tcli.build_parser().parse_args(cmd[1:]).mode == cmd[1]
