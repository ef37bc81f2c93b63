"""GEN-002 — suppression hygiene: a ``# dllama: noqa[...]`` that
suppresses nothing is itself a finding.

A noqa is a claim ("this line violates RULE-ID for a reason the AST can't
see"); when the flagged code is later fixed or moved, the stale comment
keeps advertising a violation that no longer exists — and worse, keeps a
blanket hole open for FUTURE violations on that line. The engine tracks
which suppressions actually absorbed a finding during the run and this
rule flags, per noqa comment:

* a rule-scoped id that names an unknown rule (typo — it can never
  suppress anything),
* a rule-scoped id whose rule RAN in this scan and produced nothing on
  that line,
* a bare ``# dllama: noqa`` that absorbed nothing — only on a full scan
  (all rules selected), since a partial ``--select`` run can't prove a
  blanket suppression useless.

``noqa[GEN-002]`` on the same line opts a deliberate placeholder out.
GEN-002 findings are exempt from the line's own suppression (a bare noqa
must not hide its own uselessness) but respect the baseline like every
rule. The logic runs in the engine's post-suppression hook
(:meth:`post_suppression`) because only analyze() knows which findings
each noqa absorbed.
"""

from __future__ import annotations

from ..engine import Finding, ProjectContext, Rule


class UselessNoqaRule(Rule):
    """GEN-002: stale/ineffective ``# dllama: noqa`` comments."""

    id = "GEN-002"
    severity = "warning"
    short = "noqa comment that suppresses nothing"

    def post_suppression(
        self,
        project: ProjectContext,
        active_ids: set[str],
        used: set[tuple[str, int, str | None]],
    ) -> list[Finding]:
        from . import rule_ids

        known = set(rule_ids())
        full_scan = active_ids >= known
        out: list[Finding] = []
        for fc in project.files:
            for line, ids in sorted(fc.noqa.items()):
                if ids is None:
                    if full_scan and (fc.rel, line, None) not in used:
                        out.append(
                            self._at(
                                fc,
                                line,
                                "bare `# dllama: noqa` suppresses nothing"
                                " on a full scan — remove it (it also"
                                " blanket-hides any future finding on"
                                " this line)",
                            )
                        )
                    continue
                if "GEN-002" in ids:
                    continue  # deliberate opt-out for the whole line
                for rid in sorted(ids):
                    if rid not in known:
                        out.append(
                            self._at(
                                fc,
                                line,
                                f"`noqa[{rid}]` names an unknown rule id"
                                " — it can never suppress anything"
                                " (typo?)",
                            )
                        )
                    elif rid in active_ids and (fc.rel, line, rid) not in used:
                        out.append(
                            self._at(
                                fc,
                                line,
                                f"`noqa[{rid}]` suppresses nothing —"
                                f" {rid} produced no finding on this"
                                " line; the violation it grandfathered"
                                " is gone, remove the comment",
                            )
                        )
        return out

    def _at(self, fc, line: int, message: str) -> Finding:
        return Finding(
            rule=self.id,
            severity=self.severity,
            path=fc.rel,
            line=line,
            col=0,
            message=message,
            qualname="",
            source=fc.line_text(line),
        )
