"""Configuration for the port's `dllama-analyze` rule engine.

Configuration is committed, not flag-soup: the ``[analysis]`` table of the
port's ``analysis/analysis.toml`` holds the baseline path, the
registry/doc locations the consistency rules (TEL-001 / FLT-001 / TRC-001)
cross-check, and the allowlists (CLK-001's wall-clock-appropriate sites,
extra lock attributes, extra blocking-call names). Its ``root`` key names
the repository root relative to the file, and every other path is relative
to that root. LCK-003's lock ranks are read, read-only, from the
``[tool.dllama.analysis.locks]`` table of the file its ``locks_from`` key
names (pyproject.toml), so the static rule and the runtime witness read one
table. The CLI reads the package's own file unless given another; tests
construct :class:`AnalysisConfig` directly.

A minimal TOML-subset reader backs ``tomllib`` up (Python < 3.11): table
headers, ``key = "string"`` / ``key = ["a", "b"]`` (arrays may span lines) /
booleans / integers. The committed files stay inside that subset.
"""

from __future__ import annotations

import dataclasses
import os
import re


@dataclasses.dataclass
class AnalysisConfig:
    """Resolved analyzer configuration. Paths are relative to :attr:`root`
    (the repository root the configuration file names)."""

    root: str = "."
    # committed fingerprints of grandfathered findings ("" disables)
    baseline: str = "distributed_llama_tpu_torch/analysis/baseline.txt"
    # TEL-001: every metric literal must appear in this document's table
    observability_doc: str = "docs/OBSERVABILITY.md"
    # FLT-001: the module whose top-level SITES tuple registers fault sites
    fault_registry: str = "distributed_llama_tpu_torch/engine/faults.py"
    # TRC-001: the module whose top-level SPAN_NAMES tuple registers
    # trace span names
    span_registry: str = "distributed_llama_tpu_torch/telemetry/spans.py"
    # LCK-001/002: attribute names that count as "the scheduler lock".
    # When `lock_ranks` is set (the `[tool.dllama.analysis.locks]` table)
    # this is DERIVED from the declared lock names — the flat list only
    # survives as an override for rank-less setups.
    lock_attrs: tuple[str, ...] = ("_cond",)
    # LCK-003 / lockcheck: the declared lock hierarchy as ("Class._attr",
    # rank) pairs — lower rank acquires first, leaf locks are max-rank.
    # Committed once in pyproject's [tool.dllama.analysis.locks] table;
    # both the static rule and the runtime witness read it.
    lock_ranks: tuple[tuple[str, int], ...] = ()
    # CLK-001: "relpath" or "relpath::qualname-glob" entries where
    # time.time() is wall-clock-appropriate (API `created` fields)
    clock_allow: tuple[str, ...] = ()
    # LCK-002: extra call names (terminal attribute / function name)
    # treated as blocking in addition to the built-in set
    blocking_calls: tuple[str, ...] = ()
    # fnmatch globs of relpaths to skip entirely
    exclude: tuple[str, ...] = ()
    metric_prefix: str = "dllama_"

    def __post_init__(self) -> None:
        if self.lock_ranks:
            # normalize (accept dicts / lists from loaders) and derive the
            # flat attr list the lexical rules key on from the ranked names
            pairs = dict(self.lock_ranks)
            self.lock_ranks = tuple(
                sorted((str(k), int(v)) for k, v in pairs.items())
            )
            derived = {k.rsplit(".", 1)[-1] for k, _ in self.lock_ranks}
            self.lock_attrs = tuple(sorted(derived | set(self.lock_attrs)))

    def rank_of(self, lock_id: str) -> int | None:
        for key, rank in self.lock_ranks:
            if key == lock_id:
                return rank
        return None

    def rel_to_root(self, path: str) -> str:
        return os.path.normpath(os.path.join(self.root, path))


_KEYS = {
    "baseline": str,
    "observability_doc": str,
    "fault_registry": str,
    "span_registry": str,
    "lock_attrs": tuple,
    "clock_allow": tuple,
    "blocking_calls": tuple,
    "exclude": tuple,
    "metric_prefix": str,
}


def _parse_toml_section(text: str, section: str) -> dict:
    """Extract one table from TOML source without a TOML library: scan to
    the ``[section]`` header, then read ``key = value`` pairs (strings,
    string arrays — possibly multi-line — booleans, ints) until the next
    table header."""
    lines = text.splitlines()
    out: dict = {}
    in_section = False
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line.startswith("["):
            in_section = line == f"[{section}]"
            continue
        if not in_section or not line or line.startswith("#"):
            continue
        # keys may be bare or quoted — the locks table uses quoted
        # "Class._attr" keys, which plain TOML requires to be strings
        m = re.match(r'(?:"([^"]+)"|([A-Za-z0-9_.-]+))\s*=\s*(.*)$', line)
        if not m:
            continue
        key, value = m.group(1) or m.group(2), m.group(3).strip()
        if value.startswith("["):
            # accumulate until the array's brackets balance
            while value.count("[") > value.count("]") and i < len(lines):
                value += " " + lines[i].strip()
                i += 1
            out[key] = re.findall(r'"((?:[^"\\]|\\.)*)"', value)
        elif value.startswith('"'):
            sm = re.match(r'"((?:[^"\\]|\\.)*)"', value)
            out[key] = sm.group(1) if sm else ""
        elif value in ("true", "false"):
            out[key] = value == "true"
        else:
            try:
                out[key] = int(value.split("#")[0].strip())
            except ValueError:
                out[key] = value
        # strip inline comments from bare strings only; quoted forms above
        # already isolated their payload
    return out


CONFIG_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "analysis.toml")
LOCKS_TABLE = "tool.dllama.analysis.locks"


def _read_table(path: str, table: str) -> dict:
    """One table of a TOML file (dotted ``table`` name), {} if absent."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        import tomllib  # Python >= 3.11
    except ModuleNotFoundError:
        return _parse_toml_section(text, table)
    data = tomllib.loads(text)
    for part in table.split("."):
        data = data.get(part, {}) if isinstance(data, dict) else {}
    return data if isinstance(data, dict) else {}


def load_config(path: str | None = None) -> AnalysisConfig:
    """Build an :class:`AnalysisConfig` from the ``[analysis]`` table of
    ``path`` (default: the package's ``analysis.toml``) and the lock ranks
    of the file its ``locks_from`` names. Unknown keys are ignored."""
    path = os.path.abspath(path or CONFIG_FILE)
    section = _read_table(path, "analysis")
    root = os.path.normpath(os.path.join(os.path.dirname(path), section.get("root", ".")))
    kwargs: dict = {"root": root}
    for key, typ in _KEYS.items():
        if key in section:
            val = section[key]
            kwargs[key] = tuple(val) if typ is tuple else typ(val)
    locks_from = section.get("locks_from")
    if locks_from:
        locks = _read_table(os.path.join(root, locks_from), LOCKS_TABLE)
        if locks:
            kwargs["lock_ranks"] = tuple(sorted((str(k), int(v)) for k, v in locks.items()))
    return AnalysisConfig(**kwargs)
