"""TEL-001 / FLT-001 / TRC-001 — registry consistency for metric names,
fault injection sites, and trace span names.

* **TEL-001** — every string literal passed as the name of a
  ``counter(...)`` / ``gauge(...)`` / ``histogram(...)`` creation call must
  (a) match ``dllama_[a-z0-9_]+`` (one Prometheus namespace, no stray
  casing) and (b) appear in the docs/OBSERVABILITY.md metric table, so the
  scrape surface and its documentation cannot drift apart. The doc is
  parsed for metric-shaped tokens; a missing doc file downgrades the rule
  to regex-only (fixture corpora bring their own doc).

* **FLT-001** — every site string passed to ``FaultPlan.fire("...")`` /
  ``fires("...")`` must be registered in ``engine/faults.py``'s
  module-level ``SITES`` tuple (so ``--faults`` specs can actually target
  it), and — when the registry module itself is inside the scan, i.e. the
  scan plausibly covers all call sites — every registered site must be
  fired somewhere, flagging dead registry entries.

* **TRC-001** — every span-name literal passed to ``span(...)`` /
  ``trace_span(...)`` / ``add_span(...)`` (the ring tracer's and the
  request trace's recording calls) must be registered in
  ``telemetry/spans.py``'s module-level ``SPAN_NAMES`` tuple and
  documented in docs/OBSERVABILITY.md's span table. The FLT-001 shape
  exactly: unregistered names can't drift into the trace surface, and
  registered-but-never-emitted names are flagged dead when the registry
  module is inside the scan. The name literal may be the call's first or
  second positional argument (``ctx.add_span("name", ...)`` vs the
  module helper ``trace.span(ctx, "name")``).
"""

from __future__ import annotations

import ast
import os
import re

from ..engine import FileCtx, Finding, ProjectContext, Rule

_METRIC_FACTORIES = ("counter", "gauge", "histogram")
_SITES_KEY = "flt.sites"
_CALLS_KEY = "flt.calls"
_SPAN_FUNCS = ("span", "trace_span", "add_span")
_SPAN_CALLS_KEY = "trc.calls"


def _terminal_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _first_str_arg(call: ast.Call) -> str | None:
    if call.args and isinstance(call.args[0], ast.Constant):
        v = call.args[0].value
        if isinstance(v, str):
            return v
    return None


def _span_name_arg(call: ast.Call) -> str | None:
    """The span-name literal of a recording call: first positional string
    among args[0:2] — ``tel.span("name", ...)`` / ``add_span("name", ...)``
    put it first, the module helper ``trace.span(ctx, "name", ...)``
    second (behind the context)."""
    for arg in call.args[:2]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    return None


def _registry_tuple(
    source: str, symbol: str
) -> tuple[set[str] | None, int]:
    """Parse ``symbol = ("...", ...)`` from a registry module's top level
    (the FLT-001/TRC-001 shared shape). Returns (names, lineno)."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None, 1
    for node in tree.body:
        if isinstance(node, ast.Assign):
            target_names = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            target_names = [node.target.id]
            value = node.value
        else:
            continue
        if symbol not in target_names or not isinstance(
            value, (ast.Tuple, ast.List)
        ):
            continue
        names = {
            e.value
            for e in value.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        }
        return names, node.lineno
    return None, 1


class MetricNameRule(Rule):
    id = "TEL-001"
    severity = "warning"
    short = "metric literal malformed or missing from OBSERVABILITY.md"

    def prepare(self, project: ProjectContext) -> None:
        self._prefix = project.config.metric_prefix
        self._name_re = re.compile(
            "^" + re.escape(self._prefix) + r"[a-z0-9_]+$"
        )
        doc = project.read_aux(project.config.observability_doc)
        self._doc_names: set[str] | None = None
        if doc is not None:
            self._doc_names = set(
                re.findall(re.escape(self._prefix) + r"[a-z0-9_]+", doc)
            )

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(fc.tree):
            if not isinstance(node, ast.Call):
                continue
            if _terminal_name(node.func) not in _METRIC_FACTORIES:
                continue
            name = _first_str_arg(node)
            if name is None:
                continue
            if not self._name_re.match(name):
                # a missing prefix is the primary namespace drift, not an
                # exemption — every creation-site literal must carry it
                out.append(
                    self.finding(
                        fc,
                        node,
                        f"metric name `{name}` does not match"
                        f" `{self._prefix}[a-z0-9_]+` — one lowercase"
                        " Prometheus namespace, underscores only,"
                        f" `{self._prefix}` prefix required",
                    )
                )
            elif self._doc_names is not None and name not in self._doc_names:
                out.append(
                    self.finding(
                        fc,
                        node,
                        f"metric `{name}` is not documented in"
                        f" {project.config.observability_doc} — add it to"
                        " the metric table (TEL-001 keeps the scrape"
                        " surface and its docs in lockstep)",
                    )
                )
        return out


class FaultSiteRule(Rule):
    id = "FLT-001"
    severity = "warning"
    short = "fault site not registered in faults.SITES (or registered but dead)"

    def prepare(self, project: ProjectContext) -> None:
        self._registry_rel = os.path.normpath(project.config.fault_registry)
        self._sites: set[str] | None = None
        self._sites_lineno = 1
        source = project.read_aux(self._registry_rel)
        if source is not None:
            self._sites, self._sites_lineno = _registry_tuple(source, "SITES")
        project.shared[_CALLS_KEY] = []

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        out: list[Finding] = []
        calls: list = project.shared[_CALLS_KEY]  # type: ignore[assignment]
        for node in ast.walk(fc.tree):
            if not isinstance(node, ast.Call):
                continue
            if _terminal_name(node.func) not in ("fire", "fires"):
                continue
            site = _first_str_arg(node)
            if site is None:
                continue
            calls.append(site)
            if self._sites is not None and site not in self._sites:
                out.append(
                    self.finding(
                        fc,
                        node,
                        f"fault site `{site}` is not in the SITES registry"
                        f" of {self._registry_rel} — register it so"
                        " --faults rules can target it",
                    )
                )
        return out

    def finalize(self, project: ProjectContext) -> list[Finding]:
        # dead-site check: only meaningful when the scan covers the call
        # sites — require the registry module to be part of the scan and
        # not be the only scanned file
        fc = project.by_rel.get(self._registry_rel)
        if fc is None or self._sites is None or len(project.files) < 2:
            return []
        fired = set(project.shared[_CALLS_KEY])  # type: ignore[arg-type]
        out: list[Finding] = []
        for site in sorted(self._sites - fired):
            out.append(
                Finding(
                    rule=self.id,
                    severity=self.severity,
                    path=fc.rel,
                    line=self._sites_lineno,
                    col=0,
                    message=(
                        f"registered fault site `{site}` has no"
                        " fire()/fires() call site in the scanned tree —"
                        " dead registry entry (remove it, or wire the hook"
                        " back in)"
                    ),
                    qualname="",
                    source=fc.line_text(self._sites_lineno),
                )
            )
        return out


class SpanNameRule(Rule):
    id = "TRC-001"
    severity = "warning"
    short = (
        "span name not registered in telemetry/spans.py SPAN_NAMES, "
        "undocumented, or registered but dead"
    )

    def prepare(self, project: ProjectContext) -> None:
        self._registry_rel = os.path.normpath(project.config.span_registry)
        self._names: set[str] | None = None
        self._names_lineno = 1
        source = project.read_aux(self._registry_rel)
        if source is not None:
            self._names, self._names_lineno = _registry_tuple(
                source, "SPAN_NAMES"
            )
        # documented span names: any backticked token in the
        # observability doc (the span table); a missing doc downgrades
        # the rule to registry-only, like TEL-001's doc half
        doc = project.read_aux(project.config.observability_doc)
        self._doc_names: set[str] | None = None
        if doc is not None:
            self._doc_names = set(re.findall(r"`([a-z0-9_.]+)`", doc))
        project.shared[_SPAN_CALLS_KEY] = []

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        out: list[Finding] = []
        calls: list = project.shared[_SPAN_CALLS_KEY]  # type: ignore[assignment]
        for node in ast.walk(fc.tree):
            if not isinstance(node, ast.Call):
                continue
            if _terminal_name(node.func) not in _SPAN_FUNCS:
                continue
            name = _span_name_arg(node)
            if name is None:
                continue
            calls.append(name)
            if self._names is not None and name not in self._names:
                out.append(
                    self.finding(
                        fc,
                        node,
                        f"span name `{name}` is not in the SPAN_NAMES"
                        f" registry of {self._registry_rel} — register it"
                        " so the trace surface stays enumerable",
                    )
                )
            elif self._doc_names is not None and name not in self._doc_names:
                out.append(
                    self.finding(
                        fc,
                        node,
                        f"span name `{name}` is not documented in"
                        f" {project.config.observability_doc} — add it to"
                        " the span-name table (TRC-001 keeps the trace"
                        " surface and its docs in lockstep)",
                    )
                )
        return out

    def finalize(self, project: ProjectContext) -> list[Finding]:
        # dead-name check, FLT-001's exact shape: only when the registry
        # module is inside the scan and is not the only scanned file
        fc = project.by_rel.get(self._registry_rel)
        if fc is None or self._names is None or len(project.files) < 2:
            return []
        emitted = set(project.shared[_SPAN_CALLS_KEY])  # type: ignore[arg-type]
        out: list[Finding] = []
        for name in sorted(self._names - emitted):
            out.append(
                Finding(
                    rule=self.id,
                    severity=self.severity,
                    path=fc.rel,
                    line=self._names_lineno,
                    col=0,
                    message=(
                        f"registered span name `{name}` has no"
                        " span()/trace_span()/add_span() call site in the"
                        " scanned tree — dead registry entry (remove it,"
                        " or wire the span back in)"
                    ),
                    qualname="",
                    source=fc.line_text(self._names_lineno),
                )
            )
        return out
