"""Rule catalogue for `dllama-analyze`. Each rule encodes an invariant
this repo has shipped (and review-caught) a real bug against — the
histories live in the rule modules' docstrings and docs/ANALYSIS.md."""

from __future__ import annotations

from ..engine import Rule
from .clock import WallClockRule
from .donation import DonationRule
from .exceptions import BaseExceptionRule
from .falsy import FalsyDefaultRule
from .hygiene import UselessNoqaRule
from .locks import (
    BlockingUnderLockRule,
    LockedCallRule,
    LockOrderRule,
    SharedStateMutationRule,
)
from .registries import FaultSiteRule, MetricNameRule, SpanNameRule

_RULE_CLASSES = (
    DonationRule,       # DON-001
    LockedCallRule,     # LCK-001
    BlockingUnderLockRule,  # LCK-002
    LockOrderRule,      # LCK-003
    SharedStateMutationRule,  # LCK-004
    BaseExceptionRule,  # EXC-001
    WallClockRule,      # CLK-001
    FalsyDefaultRule,   # FLS-001
    MetricNameRule,     # TEL-001
    FaultSiteRule,      # FLT-001
    SpanNameRule,       # TRC-001
    UselessNoqaRule,    # GEN-002
)


def all_rules(select: set[str] | None = None) -> list[Rule]:
    """Fresh rule instances (rules carry per-run prepare() state), filtered
    to ``select`` ids when given."""
    rules = [cls() for cls in _RULE_CLASSES]
    if select:
        wanted = {s.upper() for s in select}
        rules = [r for r in rules if r.id in wanted]
    return rules


def rule_ids() -> list[str]:
    return [cls.id for cls in _RULE_CLASSES]
