"""One-shot telemetry snapshots: ``python -m distributed_llama_tpu_torch.telemetry.dump``.

The port's copy of the JAX package's ``telemetry/dump.py``. Two modes:

* ``--url http://host:port`` — scrape a running server. By default the
  ``/metrics`` exposition text; ``--trace <request_id>`` fetches that
  request's assembled span tree from ``/debug/trace/<id>`` instead
  (``--format json`` prints the tree, the default prom format prints the
  Chrome trace-event export ready for ui.perfetto.dev), and ``--flight``
  fetches the live flight-recorder snapshot from ``/debug/flight``.
* no ``--url`` — print THIS process's registry (useful from a REPL or a
  script that imported the engine; a fresh CLI invocation has an empty
  registry unless ``DLLAMA_TELEMETRY=1`` and something ran). ``--trace``
  is then a PATH: the ring span buffer is written as Chrome trace JSON.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.telemetry.dump")
    p.add_argument(
        "--url", default=None,
        help="base URL (or full /metrics URL) of a running API server to "
        "scrape instead of this process's registry",
    )
    p.add_argument(
        "--format", choices=["prom", "json"], default="prom",
        help="prom = Prometheus text exposition; json = registry snapshot "
        "(local mode) / raw trace tree (--url --trace)",
    )
    p.add_argument(
        "--trace", default=None, metavar="ID_OR_PATH",
        help="with --url: a request id — fetch its span tree from "
        "/debug/trace/<id> (Chrome trace-event JSON by default, "
        "--format json for the raw tree). Without --url: a PATH to write "
        "this process's span buffer as Chrome trace JSON",
    )
    p.add_argument(
        "--flight", action="store_true",
        help="fetch the flight-recorder snapshot (per-replica lifecycle "
        "rings + retained dumps): from /debug/flight with --url, else this "
        "process's recorder",
    )
    return p


def scrape(url: str, timeout: float = 10.0) -> str:
    import urllib.request

    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode("utf-8", errors="replace")


def fetch_json(base: str, path: str, timeout: float = 10.0) -> dict:
    """GET ``base``+``path`` and parse the JSON body (debug endpoints)."""
    import urllib.request

    url = base.rstrip("/") + path
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8", errors="replace"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from distributed_llama_tpu_torch import telemetry

    if args.url:
        if args.flight:
            json.dump(fetch_json(args.url, "/debug/flight"), sys.stdout, indent=2)
            sys.stdout.write("\n")
            return 0
        if args.trace:
            suffix = "" if args.format == "json" else "?format=chrome"
            try:
                tree = fetch_json(args.url, f"/debug/trace/{args.trace}{suffix}")
            except OSError as e:
                sys.stderr.write(f"trace fetch failed for {args.trace!r}: {e}\n")
                return 1
            json.dump(tree, sys.stdout, indent=2)
            sys.stdout.write("\n")
            return 0
        if args.format == "json":
            sys.stderr.write("--format json is local-only; scraping returns exposition text\n")
        sys.stdout.write(scrape(args.url))
        return 0
    if args.flight:
        # this process's recorder (populated only if serving components ran
        # in process)
        from distributed_llama_tpu_torch.telemetry import flight

        json.dump(flight.RECORDER.snapshot(), sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0
    if args.format == "json":
        json.dump(telemetry.REGISTRY.snapshot(), sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(telemetry.prometheus_text())
    if args.trace:
        telemetry.export_chrome_trace(args.trace)
        sys.stderr.write(f"wrote Chrome trace: {args.trace}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
