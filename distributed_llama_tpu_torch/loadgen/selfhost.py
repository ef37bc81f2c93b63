"""In-process self-hosted target: the port's serving stack (ApiState +
ThreadingHTTPServer + BatchScheduler) on a tiny synthetic model.

The port's copy of the JAX package's ``loadgen/selfhost.py``: telemetry
enabled before anything binds its instruments (the report scrapes
``/metrics``), batched decode with the paged prefix cache and the host
spill tier on, on the card unless ``device="cpu"`` is passed. The model,
tokenizer and server settings are the JAX self-host's, so the same
schedule streams the same greedy completions from both packages. A fault
plan is installed before anything binds it; tenants, preemption,
``replicas`` (every replica, and every restart, loads the same weights),
the SDC canary and shadow votes are the server's flags. A rollout target
(``rollout_weights``) is a second synthetic model registered under
``rollout_version``: ``"same"`` writes identical bytes (the greedy streams
stay equal across the upgrade), an integer writes weights from that seed.
``pod="DATAxMODEL"`` self-hosts a one-process pod (parallel/pod.py): the
replicas are the pod's slices over one shared params tree, the group is the
engine factory, and a rollout target is a sibling group over the same
backend.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
import types
from http.server import ThreadingHTTPServer

# the JAX self-host tokenizer's template: the tiniest one the chat-template
# sniffer classifies as ChatML
SYNTHETIC_CHAT_TEMPLATE = "{{bos_token}}{% for m in messages %}<|im_start|>...{% endfor %}"


@dataclasses.dataclass
class SelfHost:
    url: str
    state: object  # ApiState
    server: ThreadingHTTPServer
    workdir: str
    plan: object | None = None  # the installed FaultPlan, if any
    rollout_version: str | None = None  # the registered rollout target, if any

    def reset_faults(self) -> None:
        """Rewind the fault plan's hit/fired counters, so ``after=`` and
        ``count=`` gates count the measured window's hits, not warmup's."""
        if self.plan is not None:
            self.plan.reset()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.state.close()
        if self.plan is not None:
            from distributed_llama_tpu_torch.engine import faults

            faults.clear()
        shutil.rmtree(self.workdir, ignore_errors=True)


def start_selfhost(
    parallel: int = 4,
    seq_len: int = 256,
    decode_chunk: int = 4,
    kv_page_size: int = 16,
    kv_pages: int | None = None,
    admission_queue: int | None = None,
    seed: int = 0,
    topk: int = 0,
    device: str = "cuda",
    tenants: str | None = None,
    preempt: bool = True,
    faults_spec: str | None = None,
    faults_seed: int = 0,
    deadline_ms: float | None = None,
    replicas: int | None = None,
    host_spill_mb: float = 16.0,
    canary_interval_s: float = 0.0,
    shadow_rate: float = 0.0,
    rollout_weights: str | None = None,
    rollout_version: str = "v1",
    pod: str | None = None,
) -> SelfHost:
    """Build the tiny synthetic f32 model and tokenizer, construct the
    port's ApiState (batched decode, prefix cache) and serve it on an
    ephemeral port. Telemetry is enabled first, so every component binds
    real instruments (the bind-once contract)."""
    import torch

    from distributed_llama_tpu_torch import telemetry
    from distributed_llama_tpu_torch.engine import InferenceEngine, faults
    from distributed_llama_tpu_torch.formats.synthetic import (
        synthetic_tokenizer_data,
        tiny_spec,
        write_synthetic_model,
    )
    from distributed_llama_tpu_torch.server.api import ApiState, make_handler
    from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer

    telemetry.enable()
    plan = None
    if faults_spec:
        plan = faults.install(faults.parse(faults_spec, seed=faults_seed))
    data = synthetic_tokenizer_data()
    data.chat_template = SYNTHETIC_CHAT_TEMPLATE
    tok = Tokenizer(data)
    spec = tiny_spec(seq_len=seq_len, vocab_size=tok.vocab_size)
    workdir = tempfile.mkdtemp(prefix="dllama-loadgen-")
    path = write_synthetic_model(os.path.join(workdir, "m.m"), spec, seed=seed)
    group = None
    if pod:
        from distributed_llama_tpu_torch.parallel.pod import PodGroup, parse_pod

        data, model = parse_pod(pod)
        group = PodGroup.build(path, data, model, dtype=torch.float32, device=device)
        engine = group.slice_engine()
        # an explicit replicas=1 keeps the consolidated one-domain pod; the
        # default is one replica per data slice (the server's rule)
        if replicas not in (None, 1, data):
            print(f"⚠️ --replicas {replicas} ignored under --pod: one replica per data slice ({data}), or 1 for "
                  "the consolidated single-domain pod")
        replicas = 1 if replicas == 1 else data
    else:
        engine = InferenceEngine(path, dtype=torch.float32, device=device)
    sampler = Sampler(vocab_size=spec.vocab_size, temperature=0.0, topp=0.9, topk=topk, seed=1)
    args = types.SimpleNamespace(
        temperature=0.0, topp=0.9, topk=topk, seed=1, chat_template=None,
        parallel=parallel, batch_decode=True, decode="device",
        decode_chunk=decode_chunk, prefill_chunk=64,
        prefix_cache=True, kv_pages=kv_pages, kv_page_size=kv_page_size,
        admission_queue=admission_queue, tenants=tenants, preempt=preempt, deadline_ms=deadline_ms,
        stall_timeout_s=60.0, replicas=replicas, host_spill_mb=host_spill_mb, spill_disk_dir=None, spill_disk_mb=0,
        replica_restart_backoff_s=0.1,
        # a fast canary cadence keeps detection inside a short run; short
        # probes keep them cheap beside real traffic
        sdc_canary_interval_s=canary_interval_s, sdc_canary_tokens=8, sdc_shadow_rate=shadow_rate,
    )
    state = ApiState(engine, tok, sampler, args,
                     engine_factory=group if group is not None
                     else lambda: InferenceEngine(path, dtype=torch.float32, device=device))
    registered = None
    if rollout_weights is not None:
        # the rollout target: a second model file under a new version id;
        # "same" writes identical bytes, so the whole rollout (drain,
        # rebuild, checksum gate, per-version golden) runs while the
        # streams stay comparable across the upgrade
        path2 = os.path.join(workdir, "m2.m")
        write_synthetic_model(path2, spec, seed=seed if rollout_weights == "same" else int(rollout_weights))
        state.register_weights_version(rollout_version, group.sibling(path2) if group is not None
                                       else lambda: InferenceEngine(path2, dtype=torch.float32, device=device))
        registered = rollout_version
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="dllama-selfhost", daemon=True).start()
    return SelfHost(url=f"http://127.0.0.1:{server.server_address[1]}", state=state, server=server,
                    workdir=workdir, plan=plan, rollout_version=registered)
