"""Seeded workload specs and the deterministic schedule (``build_schedule``).

The port's copy of the JAX package's ``loadgen/workload.py``, whole: the
same (spec, seed) gives the same schedule and fingerprint in both packages.

A :class:`Workload` describes traffic SHAPE (arrival process, rate, prompt
mix, tenant mix); :func:`build_schedule` expands it into a concrete list
of timestamped requests using ONLY ``random.Random(seed)`` — no wall
clock, no entropy — so the same (spec, seed) always yields the
byte-identical schedule (:func:`schedule_fingerprint` is the replay
proof the CI gate asserts).

Workload shape follows the serving-benchmark literature:
* **Zipf-shared prefixes** — prompts draw their system-prompt prefix from
  ``n_prefixes`` pools with Zipf(``zipf_s``) popularity, the
  production-shaped workload for the radix prefix cache (a hot prefix is
  published once and hit by its whole tail of requests).
* **Open-loop arrivals** — ``poisson`` (exponential gaps at ``rate_rps``),
  ``burst`` (``burst_size`` back-to-back arrivals every
  ``burst_period_s`` — the admission-queue / Retry-After stressor), or
  ``uniform`` (fixed gaps; the quiet-loop control).
* **Tenant mixes** — each arrival is assigned a tenant by ``share``;
  tenants carry priority, ``deadline_ms`` and SLO targets into the
  request bodies and the report.

Suffixes draw from a small pool (``n_suffixes``) ON PURPOSE: repeated
identical greedy bodies form the consistency groups the chaos gate uses
to prove survivors are uncorrupted (report.check_consistency).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random

# deterministic filler vocabulary for prompt text (byte-level synthetic
# tokenizers encode ~1 token/char, real tokenizers ~1 token/word — lengths
# are approximate by design; the schedule records characters)
_WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo "
    "lima mike november oscar papa quebec romeo sierra tango uniform "
    "victor whiskey xray yankee zulu"
).split()


@dataclasses.dataclass
class TenantLoad:
    """One tenant's slice of the workload. ``share`` is its fraction of
    arrivals (normalized across tenants); ``priority``/``deadline_ms``
    ride into request bodies; the ``slo_*`` targets classify completions
    for goodput-under-SLO (a completion outside any set target is
    throughput but not goodput)."""

    name: str
    share: float = 1.0
    priority: int | None = None
    deadline_ms: float | None = None
    slo_ttft_ms: float | None = None
    slo_e2e_ms: float | None = None
    max_tokens: int = 8

    def __post_init__(self):
        if self.share < 0:
            raise ValueError(f"tenant {self.name!r}: share must be >= 0")
        if self.max_tokens < 1:
            raise ValueError(f"tenant {self.name!r}: max_tokens must be >= 1")


@dataclasses.dataclass
class Workload:
    """The full workload spec; every field participates in the schedule
    fingerprint. Defaults are the CI-scale smoke shape."""

    seed: int = 0
    n_requests: int = 32
    rate_rps: float = 16.0
    arrival: str = "poisson"  # poisson | burst | uniform
    burst_size: int = 8
    burst_period_s: float = 1.0
    n_prefixes: int = 4
    zipf_s: float = 1.1
    prefix_chars: int = 48
    n_suffixes: int = 6
    suffix_chars: int = 12
    # sampling shape: temperature > 0 drives the fused
    # DEVICE-sampled path instead of greedy argmax. Bodies always pin
    # seed 0, and the counter PRNG keys coins on (seed, position), so
    # byte-identical sampled bodies still stream byte-identically — the
    # survivor-consistency contract holds for sampled traffic too
    temperature: float = 0.0
    topp: float = 0.9
    topk: int = 0
    tenants: list[TenantLoad] = dataclasses.field(
        default_factory=lambda: [TenantLoad("default")]
    )

    def __post_init__(self):
        if self.arrival not in ("poisson", "burst", "uniform"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if not self.tenants:
            raise ValueError("workload needs at least one tenant")
        if self.n_prefixes < 1 or self.n_suffixes < 1:
            raise ValueError("n_prefixes and n_suffixes must be >= 1")

    def spec_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tenants"] = [dataclasses.asdict(t) for t in self.tenants]
        return d


def parse_tenant_loads(spec: str | None) -> list[TenantLoad]:
    """Parse the CLI tenant-mix spec: ``;``-separated
    ``name:key=val,key=val`` with numeric fields ``share``/``priority``/
    ``deadline_ms``/``slo_ttft_ms``/``slo_e2e_ms``/``max_tokens`` — e.g.
    ``"gold:share=0.3,priority=5,slo_ttft_ms=2000;free:share=0.7"``."""
    if not (spec or "").strip():
        return [TenantLoad("default")]
    out: list[TenantLoad] = []
    seen = set()
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, kvs = part.partition(":")
        name = name.strip()
        if not name or name in seen:
            raise ValueError(f"bad or duplicate tenant entry: {part!r}")
        seen.add(name)
        kw: dict = {"name": name}
        for kv in filter(None, (x.strip() for x in kvs.split(","))):
            k, _, v = kv.partition("=")
            k = k.strip()
            if k in ("priority", "max_tokens"):
                kw[k] = int(v)
            elif k in ("share", "deadline_ms", "slo_ttft_ms", "slo_e2e_ms"):
                kw[k] = float(v)
            else:
                raise ValueError(f"unknown tenant-load field {k!r}")
        out.append(TenantLoad(**kw))
    return out


@dataclasses.dataclass
class ScheduledRequest:
    """One concrete arrival: fire the ``body`` at ``at_s`` seconds after
    run start. ``body_key`` groups byte-identical greedy bodies for the
    survivor-consistency check; ``prefix_id`` tracks radix-cache
    popularity."""

    index: int
    at_s: float
    tenant: str
    prefix_id: int
    body: dict
    body_key: str


def _zipf_cdf(n: int, s: float) -> list[float]:
    weights = [1.0 / (i + 1) ** s for i in range(n)]
    total = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def _pick(cdf: list[float], u: float) -> int:
    for i, c in enumerate(cdf):
        if u <= c:
            return i
    return len(cdf) - 1


def _text(rng: random.Random, n_chars: int, tag: str) -> str:
    words = [tag]
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(rng.choice(_WORDS))
    return " ".join(words)


def build_schedule(w: Workload) -> list[ScheduledRequest]:
    """Expand ``w`` into its deterministic arrival schedule. Pure in
    (spec, seed): every draw comes from one ``random.Random(w.seed)`` in a
    fixed order, so replays are byte-identical (the fingerprint proves
    it)."""
    rng = random.Random(w.seed)
    # prompt material first, in a fixed order independent of arrivals
    prefixes = [
        _text(rng, w.prefix_chars, f"ctx{i}") for i in range(w.n_prefixes)
    ]
    suffixes = [
        _text(rng, w.suffix_chars, f"q{i}") for i in range(w.n_suffixes)
    ]
    cdf = _zipf_cdf(w.n_prefixes, w.zipf_s)
    total_share = sum(t.share for t in w.tenants)
    if total_share <= 0:
        raise ValueError("tenant shares sum to zero")
    tenant_cdf, acc = [], 0.0
    for t in w.tenants:
        acc += t.share / total_share
        tenant_cdf.append(acc)

    out: list[ScheduledRequest] = []
    t_s = 0.0
    for i in range(w.n_requests):
        if w.arrival == "poisson":
            t_s += rng.expovariate(w.rate_rps)
            at = t_s
        elif w.arrival == "uniform":
            at = i / w.rate_rps
        else:  # burst
            at = (
                (i // w.burst_size) * w.burst_period_s
                + (i % w.burst_size) * 1e-3
            )
        tenant = w.tenants[_pick(tenant_cdf, rng.random())]
        pid = _pick(cdf, rng.random())
        sid = rng.randrange(w.n_suffixes)
        body: dict = {
            "messages": [
                {"role": "system", "content": prefixes[pid]},
                {"role": "user", "content": suffixes[sid]},
            ],
            "max_tokens": tenant.max_tokens,
            # identical bodies MUST stream identically (the consistency
            # contract): seed 0 pins the counter PRNG, so it holds for
            # sampled (temperature > 0) traffic exactly as for greedy
            "temperature": w.temperature,
            "seed": 0,
            "stream": True,
            "tenant": tenant.name,
        }
        if w.temperature > 0.0:
            body["top_p"] = w.topp
            if w.topk > 0:
                body["top_k"] = w.topk
        if tenant.priority is not None:
            body["priority"] = tenant.priority
        if tenant.deadline_ms is not None:
            body["deadline_ms"] = tenant.deadline_ms
        key = hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()
        ).hexdigest()[:16]
        out.append(
            ScheduledRequest(
                index=i, at_s=round(at, 6), tenant=tenant.name,
                prefix_id=pid, body=body, body_key=key,
            )
        )
    return out


def schedule_fingerprint(schedule: list[ScheduledRequest]) -> str:
    """sha256 over every arrival's (time, tenant, prefix, body key): the
    deterministic-replay witness — two builds of the same (spec, seed)
    must produce the same fingerprint, and the CI gate rebuilds to check."""
    h = hashlib.sha256()
    for r in schedule:
        h.update(
            f"{r.index}|{r.at_s:.6f}|{r.tenant}|{r.prefix_id}|{r.body_key}\n".encode()
        )
    return h.hexdigest()


def scheduled_counts(schedule: list[ScheduledRequest]) -> dict[str, int]:
    """Per-tenant scheduled request counts (the deterministic aggregate
    the replay check compares)."""
    out: dict[str, int] = {}
    for r in schedule:
        out[r.tenant] = out.get(r.tenant, 0) + 1
    return out
