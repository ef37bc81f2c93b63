"""The span-name registry.

The port's copy of the JAX package's ``telemetry/spans.py``: every string
literal passed as a span name — ``tel.span("...")`` / ``trace_span("...")``
on the ring tracer, or ``trace.span(ctx, "...")`` / ``ctx.add_span("...")``
on a request trace — is one of these, so a trace of either package reads
with the same names (docs/OBSERVABILITY.md's span-name table). The tuple
equals the JAX package's; ``transfer_probe`` is the parallel backends'
timed probe replay (``parallel/tensor_parallel.py``
``TransferProbeMixin.measure_transfer_ms``). ``placement`` is the replica
pool's choice of a replica and a lane.
"""

from __future__ import annotations

SPAN_NAMES = (
    # engine ring-tracer spans (engine/engine.py)
    "forward",
    "prefill",
    "prefill_dispatch",
    "device_sample",
    "first_token_fetch",
    "decode_chunk_dispatch",
    "decode_chunk_fetch",
    "spec_verify",
    "transfer_probe",
    # batched-scheduler ring-tracer spans (engine/batch.py)
    "batch_decode_chunk",
    "batch_decode_fetch",
    "spec_verify_chunk",
    "prefix_spill_reload",
    "prefix_publish",
    # request-trace spans (telemetry/trace.py): the per-request tree
    # assembled by RequestTraceStore and served at /debug/trace/<id>
    "queue_wait",
    "placement",
    "prefill_chunk",
    "decode_stream",
    "batch_decode_chunk_row",
    "spec_verify_row",
    "prefix_match",
    "sse_send",
)
