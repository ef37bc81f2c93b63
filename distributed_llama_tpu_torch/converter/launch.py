"""Named-model launcher: download converted `.m`/`.t` files and print a
command that runs them with the port's CLI.

The port's copy of the JAX package's ``converter/launch.py``: the same
registry of published files (the `.m`/`.t` format is shared), the same
download (a large model's URL parts concatenate into one local file), and
the same command with the port's CLI, ``dllama-torch``
(``python -m distributed_llama_tpu_torch.apps.cli``), in place of
``dllama-tpu``.
"""

from __future__ import annotations

import os
import sys
import urllib.request

CLI = "dllama-torch"


def _parts(length: int) -> list[str]:
    return [chr(97 + i // 26) + chr(97 + i % 26) for i in range(length)]


_HF = "https://huggingface.co"

# name -> (model_urls, tokenizer_url, weights_float_type, buffer_float_type, kind)
MODELS: dict[str, tuple[list[str], str, str, str, str]] = {
    "tinyllama_1_1b_3t_q40": (
        [f"{_HF}/b4rtaz/TinyLlama-1.1B-3T-Distributed-Llama/resolve/main/dllama_model_tinylama_1.1b_3t_q40.m?download=true"],
        f"{_HF}/b4rtaz/TinyLlama-1.1B-3T-Distributed-Llama/resolve/main/dllama_tokenizer_tinylama_1.1b_3t.t?download=true",
        "q40", "q80", "base",
    ),
    "llama3_8b_q40": (
        [f"{_HF}/b4rtaz/Llama-3-8B-Q40-Distributed-Llama/resolve/main/dllama_model_meta-llama-3-8b_q40.m?download=true"],
        f"{_HF}/b4rtaz/Llama-3-8B-Q40-Distributed-Llama/resolve/main/dllama_tokenizer_llama3.t?download=true",
        "q40", "q80", "base",
    ),
    "llama3_8b_instruct_q40": (
        [f"{_HF}/b4rtaz/Llama-3-8B-Q40-Instruct-Distributed-Llama/resolve/main/dllama_model_lama3_instruct_q40.m?download=true"],
        f"{_HF}/b4rtaz/Llama-3-8B-Q40-Instruct-Distributed-Llama/resolve/main/dllama_tokenizer_llama3.t?download=true",
        "q40", "q80", "chat",
    ),
    "llama3_1_8b_instruct_q40": (
        [f"{_HF}/b4rtaz/Llama-3_1-8B-Q40-Instruct-Distributed-Llama/resolve/main/dllama_model_llama3.1_instruct_q40.m?download=true"],
        f"{_HF}/b4rtaz/Llama-3_1-8B-Q40-Instruct-Distributed-Llama/resolve/main/dllama_tokenizer_llama_3_1.t?download=true",
        "q40", "q80", "chat",
    ),
    "llama3_1_405b_instruct_q40": (
        [
            f"{_HF}/b4rtaz/Llama-3_1-405B-Q40-Instruct-Distributed-Llama/resolve/main/dllama_model_llama31_405b_q40_{s}?download=true"
            for s in _parts(56)
        ],
        f"{_HF}/b4rtaz/Llama-3_1-405B-Q40-Instruct-Distributed-Llama/resolve/main/dllama_tokenizer_llama_3_1.t?download=true",
        "q40", "q80", "chat",
    ),
}


def download_file(urls: list[str], path: str, progress=print) -> None:
    """Concatenate the bodies of ``urls`` into ``path`` (through a
    ``.partial`` file renamed at the end); an existing ``path`` is kept."""
    if os.path.isfile(path):
        progress(f"{os.path.basename(path)} already exists, skipping download")
        return
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        for url in urls:
            progress(f"📄 {url}")
            with urllib.request.urlopen(url) as r:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
    os.replace(tmp, path)


def launch_command(name: str, models_dir: str = "models") -> list[str]:
    _model_urls, _tok_url, _wft, _bft, kind = MODELS[name]
    d = os.path.join(models_dir, name)
    model_path = os.path.join(d, f"dllama_model_{name}.m")
    tok_path = os.path.join(d, f"dllama_tokenizer_{name}.t")
    mode = "chat" if kind == "chat" else "inference"
    cmd = [
        CLI, mode,
        "--model", model_path,
        "--tokenizer", tok_path,
        "--temperature", "0.8",
        "--max-seq-len", "4096",
    ]
    if mode == "inference":
        cmd += ["--prompt", "Hello world", "--steps", "64"]
    return cmd


def launch(name: str, models_dir: str = "models", run=False) -> list[str]:
    model_urls, tok_url, _wft, _bft, _kind = MODELS[name]
    d = os.path.join(models_dir, name)
    os.makedirs(d, exist_ok=True)
    download_file(model_urls, os.path.join(d, f"dllama_model_{name}.m"))
    download_file([tok_url], os.path.join(d, f"dllama_tokenizer_{name}.t"))
    cmd = launch_command(name, models_dir)
    print("To run the model:\n  " + " ".join(cmd))
    if run:
        from distributed_llama_tpu_torch.apps.cli import main as cli_main

        cli_main(cmd[1:])
    return cmd


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in MODELS:
        print("Usage: python -m distributed_llama_tpu_torch.converter.launch <model> [--run]")
        print("Available models:")
        for name in MODELS:
            print(f"  {name}")
        raise SystemExit(1)
    launch(argv[0], run="--run" in argv)


if __name__ == "__main__":
    main()
