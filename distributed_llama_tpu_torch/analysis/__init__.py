"""`dllama-analyze` for the port — project-specific static analysis.

The port's copy of the JAX package's AST rule engine, with every rule id
of it, over the port's own code: use-after-donation of jitted buffers
(DON-001, which reads ``jax.jit(donate_argnums=...)`` and so finds nothing
in a package that never writes one), scheduler-lock discipline
(LCK-001..004), swallowed ``BaseException`` in recovery paths (EXC-001),
wall-clock misuse (CLK-001), falsy numeric defaults (FLS-001), registry
consistency for metric names, fault sites and span names (TEL-001,
FLT-001, TRC-001) and noqa hygiene (GEN-002).

Run it as a module — this is the port's gate::

    python -m distributed_llama_tpu_torch.analysis distributed_llama_tpu_torch/

Inline suppression: ``# dllama: noqa[RULE-ID]`` on the flagged line (with
a comment stating the invariant that makes the site safe). Grandfathered
findings live in the port's baseline file (``analysis/baseline.txt``,
kept empty). Configuration: ``analysis/analysis.toml``; the lock ranks are
pyproject.toml's ``[tool.dllama.analysis.locks]`` table, read only, the
table the runtime witness (``lockcheck``) holds the port to. Catalogue and
workflow: docs/ANALYSIS.md.

The package imports only the standard library, so the gate runs anywhere
the repo checks out.
"""

from .config import AnalysisConfig, load_config
from .engine import Finding, analyze
from .rules import all_rules, rule_ids

__all__ = [
    "AnalysisConfig",
    "Finding",
    "all_rules",
    "analyze",
    "load_config",
    "rule_ids",
]
