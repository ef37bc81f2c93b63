"""CLK-001 — ``time.time()`` outside the wall-clock allowlist.

History: the JAX package's first observability sweep found request
durations measured with ``time.time()`` in server/api.py — an NTP step mid-request yields negative
or wildly wrong latencies. Every duration in this repo now flows through
``telemetry.Stopwatch`` (``perf_counter``) or ``time.monotonic`` for
deadlines; the only legitimate wall-clock reads are *timestamps shown to
users* — the OpenAI-compatible ``created`` fields. Those sites live in the
``clock_allow`` list of the port's ``analysis/analysis.toml`` (``"relpath"`` or
``"relpath::qualname-glob"`` entries); everything else is a finding.
"""

from __future__ import annotations

import ast
import fnmatch

from ..engine import FileCtx, Finding, ProjectContext, Rule


def _is_time_time(node: ast.Call, fc: FileCtx) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr == "time":
        return isinstance(func.value, ast.Name) and func.value.id == "time"
    if isinstance(func, ast.Name):
        # `from time import time` under any alias
        return fc.from_imports.get(func.id, ("", ""))[:2] == ("time", "time")
    return False


class WallClockRule(Rule):
    id = "CLK-001"
    severity = "warning"
    short = "time.time() outside the wall-clock allowlist"

    def _allowed(self, project: ProjectContext, fc: FileCtx, qualname: str) -> bool:
        for entry in project.config.clock_allow:
            path_glob, _, qual_glob = entry.partition("::")
            if not fnmatch.fnmatch(fc.rel, path_glob):
                continue
            if not qual_glob or fnmatch.fnmatch(qualname, qual_glob):
                return True
        return False

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(fc.tree):
            if not (isinstance(node, ast.Call) and _is_time_time(node, fc)):
                continue
            if self._allowed(project, fc, fc.qualname(node)):
                continue
            out.append(
                self.finding(
                    fc,
                    node,
                    "`time.time()` is wall-clock: durations belong to"
                    " telemetry.Stopwatch/perf_counter, deadlines to"
                    " time.monotonic — if this really is a user-facing"
                    " timestamp, add the site to `clock_allow` in"
                    " distributed_llama_tpu_torch/analysis/analysis.toml",
                )
            )
        return out
