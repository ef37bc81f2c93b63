"""Tokenizer converters -> `.t` format.

The port's copy of the JAX package's ``converter/tokenizers.py``: HF
``tokenizer.json`` BPE vocabularies, sentencepiece models (the
``sentencepiece`` package is imported only when one is converted), and the
tiktoken-style base64 llama3 format with its 256 special tokens and chat
template.
"""

from __future__ import annotations

import base64
import json
import os

from distributed_llama_tpu_torch.formats.tokenizer_file import TokenizerData, write_tokenizer_file

LLAMA2_CHAT_TEMPLATE = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = messages[1:] %}"
    "{% set system_message = messages[0]['content'] %}{% else %}"
    "{% set loop_messages = messages %}{% set system_message = false %}{% endif %}"
    "{% for message in loop_messages %}{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}"
    "{% endif %}{% if loop.index0 == 0 and system_message != false %}"
    "{% set content = '<<SYS>>\\n' + system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}"
    "{% else %}{% set content = message['content'] %}{% endif %}"
    "{% if message['role'] == 'user' %}{{ bos_token + '[INST] ' + content.strip() + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}{{ ' '  + content.strip() + ' ' + eos_token }}"
    "{% endif %}{% endfor %}"
)

LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}{% endif %}"
    "{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}"
)

LLAMA3_N_SPECIAL = 256
LLAMA3_SPECIAL_TOKENS = [
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>",
    "<|reserved_special_token_2|>",
    "<|reserved_special_token_3|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|reserved_special_token_4|>",
    "<|eot_id|>",
] + [f"<|reserved_special_token_{i}|>" for i in range(5, LLAMA3_N_SPECIAL - 5)]


def _write(out_path: str, data: TokenizerData) -> None:
    with open(out_path, "wb") as f:
        write_tokenizer_file(f, data)


def convert_hf_tokenizer(dir_path: str, out_path: str, chat_extra_stop: str | None = None) -> TokenizerData:
    """HF folder (tokenizer_config.json + tokenizer.json or tokenizer.model) -> `.t`."""
    with open(os.path.join(dir_path, "tokenizer_config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    cls = cfg.get("tokenizer_class")
    if cls == "PreTrainedTokenizerFast":
        tokens, scores, bos_id, eos_id = _resolve_fast(dir_path, cfg)
    elif cls == "LlamaTokenizer":
        tokens, scores, bos_id, eos_id = _resolve_sentencepiece(os.path.join(dir_path, "tokenizer.model"))
    else:
        raise ValueError(f"tokenizer class {cls} is not supported")

    data = TokenizerData(
        vocab=tokens,
        scores=scores,
        bos_id=bos_id,
        eos_id=eos_id,
        chat_eos_id=eos_id,
        chat_template=cfg.get("chat_template"),
        chat_stop=chat_extra_stop,
    )
    _write(out_path, data)
    return data


def _token_to_bytes(token: str) -> bytes:
    return token.encode("utf-8")


def _resolve_fast(dir_path: str, cfg: dict):
    """The BPE vocab of tokenizer.json, then its added tokens."""
    with open(os.path.join(dir_path, "tokenizer.json"), encoding="utf-8") as f:
        tok = json.load(f)
    if tok["model"]["type"] != "BPE":
        raise ValueError("only BPE tokenizer.json vocabularies are supported")
    bos_id = eos_id = None
    tokens: list[bytes] = []
    scores: list[float] = []
    vocab = tok["model"]["vocab"]
    for i, (token, tid) in enumerate(vocab.items()):
        if tid != i:
            raise ValueError("tokenizer.json vocab ids are not dense")
        tokens.append(_token_to_bytes(token))
        scores.append(-float(i))
    for at in tok.get("added_tokens", []):
        if at["id"] != len(tokens):
            raise ValueError("added_tokens ids are not dense")
        if at["content"] == cfg.get("bos_token"):
            bos_id = len(tokens)
        if at["content"] == cfg.get("eos_token"):
            eos_id = len(tokens)
        tokens.append(_token_to_bytes(at["content"]))
        scores.append(-float(len(tokens) - 1))
    if bos_id is None or eos_id is None:
        # fall back to named lookup in the whole vocab
        index = {t: i for i, t in enumerate(tokens)}
        bos = cfg.get("bos_token")
        eos = cfg.get("eos_token")
        bos_id = bos_id if bos_id is not None else index.get(_token_to_bytes(bos), -1) if bos else -1
        eos_id = eos_id if eos_id is not None else index.get(_token_to_bytes(eos), -1) if eos else -1
    return tokens, scores, bos_id, eos_id


def _resolve_sentencepiece(model_path: str):
    """A sentencepiece model's pieces (U+2581 as a space) and scores."""
    from sentencepiece import SentencePieceProcessor

    sp = SentencePieceProcessor(model_file=model_path)
    tokens: list[bytes] = []
    scores: list[float] = []
    for i in range(sp.vocab_size()):
        piece = sp.id_to_piece(i).replace("\u2581", " ")
        tokens.append(piece.encode("utf-8"))
        scores.append(sp.get_score(i))
    return tokens, scores, sp.bos_id(), sp.eos_id()


def convert_llama2_tokenizer(dir_path: str, out_path: str) -> TokenizerData:
    tokens, scores, bos_id, eos_id = _resolve_sentencepiece(os.path.join(dir_path, "tokenizer.model"))
    data = TokenizerData(
        vocab=tokens,
        scores=scores,
        bos_id=bos_id,
        eos_id=eos_id,
        chat_eos_id=eos_id,
        chat_template=LLAMA2_CHAT_TEMPLATE,
    )
    _write(out_path, data)
    return data


def convert_llama3_tokenizer(model_path: str, out_path: str) -> TokenizerData:
    """A tiktoken-style base64 vocab file, then the llama3 special tokens."""
    tokens: list[bytes] = []
    scores: list[float] = []
    with open(model_path, "r") as f:
        for line in f:
            if not line.strip():
                continue
            b64, rank = line.split(" ")
            tokens.append(base64.b64decode(b64))
            scores.append(-float(rank))
    for tok in LLAMA3_SPECIAL_TOKENS:
        tokens.append(tok.encode("utf-8"))
        scores.append(-float(len(tokens) - 1))
    data = TokenizerData(
        vocab=tokens,
        scores=scores,
        bos_id=128000,
        eos_id=128001,
        chat_eos_id=128009,
        chat_template=LLAMA3_CHAT_TEMPLATE,
    )
    _write(out_path, data)
    return data


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="dllama-torch-convert-tokenizer")
    p.add_argument("kind", choices=["hf", "llama2", "llama3"])
    p.add_argument("path", help="tokenizer folder (hf/llama2) or tokenizer.model (llama3)")
    p.add_argument("name")
    p.add_argument("--chat-extra-stop", default=None)
    args = p.parse_args(argv)
    out = f"dllama_tokenizer_{args.name}.t"
    if args.kind == "hf":
        convert_hf_tokenizer(args.path, out, args.chat_extra_stop)
    elif args.kind == "llama2":
        convert_llama2_tokenizer(args.path, out)
    else:
        convert_llama3_tokenizer(args.path, out)
    print(f"✅ Created {out}")


if __name__ == "__main__":
    main()
