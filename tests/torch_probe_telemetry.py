"""The transfer probe's telemetry, one backend of each package against the
other: shared by the TP, SP and EP test files (not collected)."""

from distributed_llama_tpu import telemetry as jtel

from distributed_llama_tpu_torch import telemetry as ttel

FAMILIES = ("dllama_transfer_probe_runs_total", "dllama_allreduce_bytes_total", "dllama_allreduce_latency_seconds")


def assert_probe_telemetry_matches_jax(jax_backend, torch_backend, n_tokens=(2, 3)) -> None:
    """With telemetry on, each probe of either backend is one run, one
    latency observation and ``transfer_bytes_per_token() x n_tokens`` bytes:
    the port's counts equal the JAX backend's (the latency values are
    timings, so only their counts are compared), and each of the port's
    probes is a ``transfer_probe`` span of its length."""
    backends = (jax_backend, torch_backend)
    for tel in (ttel, jtel):
        tel.reset()
        tel.enable()
    try:
        for b in backends:
            b._collective_tel_bundle = None  # rebind after enable (the bind-once contract)
        for n in n_tokens:
            for b in backends:
                b.measure_transfer_ms(n_tokens=n)
        ours, theirs = ttel.REGISTRY.snapshot(), jtel.REGISTRY.snapshot()
        for name in FAMILIES:
            (a,), (b,) = ours[name]["series"], theirs[name]["series"]
            key = "count" if name.endswith("_seconds") else "value"
            assert a[key] == b[key], name
        assert ours["dllama_transfer_probe_runs_total"]["series"][0]["value"] == len(n_tokens)
        assert ours["dllama_allreduce_bytes_total"]["series"][0]["value"] == (
            sum(n_tokens) * torch_backend.transfer_bytes_per_token())
        probes = [e for e in ttel.TRACER.events() if e.name == "transfer_probe"]
        assert [e.args["tokens"] for e in probes] == list(n_tokens)
    finally:
        for b in backends:
            b._collective_tel_bundle = None
        for tel in (ttel, jtel):
            tel.disable()
            tel.reset()
