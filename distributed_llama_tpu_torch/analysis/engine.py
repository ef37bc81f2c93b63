"""The `dllama-analyze` rule engine: AST walking, suppression, baseline,
and the two-pass analyzer run (the port's copy of the JAX package's).

The engine parses every scanned file once into a :class:`FileCtx` (AST +
parent links + import aliases + per-line ``# dllama: noqa[...]``
suppressions), hands the full set to each rule's ``prepare`` pass (where
cross-file facts like the donation table or the fault-site registry are
collected), then runs per-file ``check`` and project-level ``finalize``
passes. Findings that survive inline suppression and the committed
baseline decide the exit code — the CI gate is exactly
``python -m distributed_llama_tpu_torch.analysis distributed_llama_tpu_torch/``.

Rules are deliberately *project-shaped*: each encodes an invariant this
repo has actually shipped a bug against (docs/ANALYSIS.md has the
catalogue and the history). The engine itself is generic; adding a rule is
subclassing :class:`Rule` and listing it in ``rules/__init__.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import os
import re

from .config import AnalysisConfig

SEVERITIES = ("warning", "error")

_NOQA_RE = re.compile(
    r"#\s*dllama:\s*noqa(?:\[([A-Za-z0-9_,\s-]+)\])?", re.IGNORECASE
)


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str
    severity: str  # "warning" | "error"
    path: str  # relative to the scan invocation's config root
    line: int
    col: int
    message: str
    qualname: str = ""  # enclosing function/class dotted path, "" at module level
    source: str = ""  # stripped text of the flagged physical line

    def format(self) -> str:
        where = f"  [{self.qualname}]" if self.qualname else ""
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.severity}: {self.message}{where}"
        )

    def fingerprint(self) -> str:
        """Line-number-independent identity for the baseline file: the rule,
        the file, the enclosing scope and the flagged line's text."""
        h = hashlib.sha1(self.source.strip().encode("utf-8")).hexdigest()[:12]
        return f"{self.rule}|{self.path}|{self.qualname}|{h}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileCtx:
    """Parsed view of one scanned file: AST with parent links, source
    lines, import aliases, and the per-line noqa suppression map."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # names that (probably) refer to imported modules: `import jax` ->
        # jax, `import numpy as np` -> np, `from a.b import c` -> c (c may
        # be a module or a function; rules treat it as "resolvable import")
        self.module_aliases: set[str] = set()
        # alias -> (module, original_name) for `from time import time` style
        self.from_imports: dict[str, tuple[str, str]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.module_aliases.add(a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    alias = a.asname or a.name
                    self.module_aliases.add(alias)
                    self.from_imports[alias] = (node.module, a.name)
        # string-literal spans: noqa text INSIDE a string (docstrings
        # quoting the syntax, generated-file headers) is prose, not a
        # suppression — it must neither suppress findings nor trip GEN-002
        str_spans = [
            (n.lineno, n.col_offset, n.end_lineno, n.end_col_offset)
            for n in ast.walk(self.tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.end_lineno is not None
        ]

        def in_string(line: int, col: int) -> bool:
            for l0, c0, l1, c1 in str_spans:
                if (l0, c0) <= (line, col) and (line, col) < (l1, c1):
                    return True
            return False

        # line -> None (suppress all rules) | set of rule ids
        self.noqa: dict[int, set[str] | None] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(text)
            if not m:
                continue
            if in_string(i, m.start()):
                continue
            if m.group(1):
                ids = {part.strip().upper() for part in m.group(1).split(",")}
                self.noqa[i] = {x for x in ids if x}
            else:
                self.noqa[i] = None

    # -- tree queries ---------------------------------------------------

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return anc
        return None

    def qualname(self, node: ast.AST) -> str:
        parts = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(anc.name)
        return ".".join(reversed(parts))

    def statement_of(self, node: ast.AST) -> ast.stmt:
        """The innermost statement containing ``node``."""
        cur: ast.AST = node
        while not isinstance(cur, ast.stmt):
            nxt = self.parents.get(cur)
            if nxt is None:
                break
            cur = nxt
        return cur  # type: ignore[return-value]

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        if lineno not in self.noqa:
            return False
        ids = self.noqa[lineno]
        return ids is None or rule.upper() in ids


def expr_key(node: ast.AST) -> str | None:
    """Dotted-name key for a simple Name / Attribute-of-Names chain
    (``self._slab`` -> "self._slab"); None for anything computed."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def assigned_keys(stmt: ast.stmt) -> set[str]:
    """Dotted keys (re)bound to a NEW value by a statement: assignment
    targets (including tuple unpacking), ``for`` targets and ``with ...
    as`` bindings. AugAssign is deliberately absent — ``x += 1`` READS the
    old value first, so it heals nothing (DON-001 treats its target as a
    load)."""
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, ast.AnnAssign):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    out: set[str] = set()
    stack = targets
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            key = expr_key(t)
            if key:
                out.add(key)
    return out


class ProjectContext:
    """Everything the rules share: the config, the parsed files, and the
    cross-file facts rules deposit during their ``prepare`` pass."""

    def __init__(self, config: AnalysisConfig, files: list[FileCtx]):
        self.config = config
        self.files = files
        self.shared: dict[str, object] = {}
        self.by_rel = {fc.rel: fc for fc in files}

    def read_aux(self, rel_or_abs: str) -> str | None:
        """Source of an auxiliary file (doc table, registry module) —
        served from the scan set when present, else read from disk."""
        fc = self.by_rel.get(os.path.normpath(rel_or_abs))
        if fc is not None:
            return fc.source
        path = self.config.rel_to_root(rel_or_abs)
        if os.path.isfile(path):
            with open(path, "r", encoding="utf-8") as f:
                return f.read()
        return None


class Rule:
    """Base class: subclasses set ``id``/``severity``/``short`` and
    implement any of ``prepare`` (cross-file collection), ``check``
    (per-file findings) and ``finalize`` (project-level findings)."""

    id = "GEN-000"
    severity = "error"
    short = ""

    def prepare(self, project: ProjectContext) -> None:
        pass

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        return []

    def finalize(self, project: ProjectContext) -> list[Finding]:
        return []

    def post_suppression(
        self,
        project: ProjectContext,
        active_ids: set[str],
        used: set[tuple[str, int, str | None]],
    ) -> list[Finding]:
        """Hook run by analyze() AFTER the noqa pass: ``used`` holds the
        (rel, line, rule-id-or-None-for-bare) suppressions that actually
        absorbed a finding. Findings returned here bypass inline noqa (but
        not the baseline) — GEN-002 uses this to flag noqa comments that
        suppressed nothing."""
        return []

    def finding(
        self, fc: FileCtx, node: ast.AST, message: str, severity: str | None = None
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=self.id,
            severity=severity or self.severity,
            path=fc.rel,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            qualname=fc.qualname(node),
            source=fc.line_text(line),
        )


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> dict[str, int]:
    """Fingerprint -> allowed count. Missing file = empty baseline; ``#``
    lines are comments."""
    counts: dict[str, int] = {}
    if not path or not os.path.isfile(path):
        return counts
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            counts[line] = counts.get(line, 0) + 1
    return counts


def write_baseline(path: str, findings: list[Finding]) -> int:
    """Snapshot ``findings`` as the new baseline. Returns the number of
    STALE fingerprints pruned — entries of the previous baseline that no
    current finding matches (fixed code whose grandfather entry would
    otherwise silently absorb a future regression)."""
    old = load_baseline(path)
    fresh = {f2.fingerprint() for f2 in findings}
    pruned = sum(n for fp, n in old.items() if fp not in fresh)
    with open(path, "w", encoding="utf-8") as f:
        f.write(
            "# dllama-analyze baseline — grandfathered findings, one"
            " fingerprint per line.\n"
            "# Regenerate with: python -m distributed_llama_tpu_torch.analysis"
            " --write-baseline <paths>\n"
            "# An empty baseline is the healthy state: fix findings or"
            " suppress them inline\n"
            "# with a justified `# dllama: noqa[RULE-ID]` instead of"
            " parking them here.\n"
        )
        for fp in sorted(f2.fingerprint() for f2 in findings):
            f.write(fp + "\n")
    return pruned


def apply_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], int]:
    """Drop findings covered by the baseline (each entry absorbs as many
    findings as it is listed times). Returns (kept, n_baselined)."""
    remaining = dict(baseline)
    kept: list[Finding] = []
    absorbed = 0
    for f in findings:
        fp = f.fingerprint()
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            absorbed += 1
        else:
            kept.append(f)
    return kept, absorbed


# ---------------------------------------------------------------------------
# The analyzer run
# ---------------------------------------------------------------------------


def collect_files(paths: list[str], config: AnalysisConfig) -> tuple[list[FileCtx], list[Finding]]:
    """Parse every ``.py`` under ``paths`` into FileCtx objects. Returns
    (files, parse_failures) — an unparsable file is a GEN-001 finding, not
    a crash, so one bad file cannot mask the rest of the scan."""
    seen: set[str] = set()
    files: list[FileCtx] = []
    failures: list[Finding] = []
    root = os.path.abspath(config.root)

    def rel_of(abspath: str) -> str:
        try:
            rel = os.path.relpath(abspath, root)
        except ValueError:  # different drive (windows)
            rel = abspath
        return os.path.normpath(rel)

    def excluded(rel: str) -> bool:
        return any(fnmatch.fnmatch(rel, pat) for pat in config.exclude)

    def add(abspath: str) -> None:
        if abspath in seen:
            return
        seen.add(abspath)
        rel = rel_of(abspath)
        if excluded(rel):
            return
        try:
            with open(abspath, "r", encoding="utf-8") as f:
                source = f.read()
            files.append(FileCtx(abspath, rel, source))
        except (SyntaxError, ValueError, OSError) as e:
            failures.append(
                Finding(
                    rule="GEN-001",
                    severity="error",
                    path=rel,
                    line=getattr(e, "lineno", 1) or 1,
                    col=0,
                    message=f"file could not be parsed: {e}",
                    source="",
                )
            )

    for path in paths:
        path = os.path.abspath(path)
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [
                    d for d in sorted(dirnames) if d != "__pycache__"
                ]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        add(os.path.join(dirpath, name))
        elif path.endswith(".py"):
            add(path)
    files.sort(key=lambda fc: fc.rel)
    return files, failures


def analyze(
    paths: list[str],
    config: AnalysisConfig,
    rules: list[Rule] | None = None,
    use_baseline: bool = True,
) -> tuple[list[Finding], dict]:
    """Run the engine. Returns (unsuppressed findings, stats dict with
    ``files``/``suppressed``/``baselined`` counts)."""
    if rules is None:
        from .rules import all_rules

        rules = all_rules()
    files, failures = collect_files(paths, config)
    project = ProjectContext(config, files)
    for rule in rules:
        rule.prepare(project)
    raw: list[Finding] = list(failures)
    for rule in rules:
        for fc in files:
            raw.extend(rule.check(project, fc))
        raw.extend(rule.finalize(project))
    raw.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    kept: list[Finding] = []
    suppressed = 0
    # which suppressions earned their keep: (rel, line, rule-id) for a
    # scoped hit, (rel, line, None) when the bare form absorbed it
    used: set[tuple[str, int, str | None]] = set()
    for f in raw:
        fc = project.by_rel.get(f.path)
        if fc is not None and fc.suppressed(f.rule, f.line):
            suppressed += 1
            ids = fc.noqa.get(f.line)
            used.add(
                (f.path, f.line, None if ids is None else f.rule.upper())
            )
        else:
            kept.append(f)

    active_ids = {r.id for r in rules}
    for rule in rules:
        kept.extend(rule.post_suppression(project, active_ids, used))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    baselined = 0
    if use_baseline and config.baseline:
        baseline = load_baseline(config.rel_to_root(config.baseline))
        kept, baselined = apply_baseline(kept, baseline)
    stats = {
        "files": len(files),
        "suppressed": suppressed,
        "baselined": baselined,
    }
    return kept, stats
