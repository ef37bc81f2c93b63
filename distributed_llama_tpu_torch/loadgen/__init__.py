"""Traffic harness: a deterministic, seeded load generator that drives the
port's HTTP server (``server/api.py``) with open-loop, Zipf-prefixed
traffic and reports tail latency beside the server's own counters.

The port's copy of the JAX package's ``loadgen/``:

* :mod:`~distributed_llama_tpu_torch.loadgen.workload` — seeded workload
  specs; ``build_schedule`` is a pure function of (spec, seed) with the
  JAX package's fingerprint.
* :mod:`~distributed_llama_tpu_torch.loadgen.runner` — the open-loop HTTP
  client: requests fire at their scheduled instants regardless of
  completions, stream SSE, and record TTFT / TPOT / E2E per request.
* :mod:`~distributed_llama_tpu_torch.loadgen.report` — the SLO report:
  p50/p90/p99, goodput-under-SLO, ``/metrics`` deltas, the client/server
  skew, and the consistency / fairness checks.
* :mod:`~distributed_llama_tpu_torch.loadgen.selfhost` — an in-process
  server on a tiny synthetic model.

CLI: ``python -m distributed_llama_tpu_torch.loadgen --help``.
"""

from distributed_llama_tpu_torch.loadgen.report import build_report  # noqa: F401
from distributed_llama_tpu_torch.loadgen.runner import run_schedule  # noqa: F401
from distributed_llama_tpu_torch.loadgen.workload import (  # noqa: F401
    TenantLoad,
    Workload,
    build_schedule,
    schedule_fingerprint,
)
