"""DON-001 — use-after-donation of ``jax.jit(donate_argnums=...)`` buffers.

The engine's hottest state — the batched slab KV cache, the prefix-page
pool, per-stream caches — is threaded through jitted calls with
``donate_argnums`` so XLA aliases the output over the input buffer. After
the call dispatches, the donated array is DELETED: any later read raises
``RuntimeError: Array has been deleted`` at best, or silently observes
aliased bytes under disabled checking. Every donation call site in this
repo follows the self-healing idiom ``x = f(x)`` (the donated name is
rebound by the result in the same statement); this rule flags the ones
that don't.

Mechanics (two passes):

1. ``prepare`` builds a project-wide donation table:
   * module-level ``def`` decorated with ``jax.jit``/``functools.partial(
     jax.jit, ..., donate_argnums=(k,...))`` — keyed by bare name, reached
     from other files through imported-module attribute calls
     (``sampling.decode_chunk(...)``) or ``from`` imports;
   * ``self.X = jax.jit(fn, donate_argnums=...)`` and the one-step
     propagations ``j = jax.jit(...); self.X = j`` and ``self.X =
     functools.partial(donor, a, b)`` (indices shift left by the number of
     bound leading args) — keyed by attribute name, file-scoped.
2. ``check`` walks each function: at a donating call whose donated
   positional argument is a simple name/attribute chain, the chain is
   poisoned from the end of that statement unless the same statement's
   assignment targets rebind it; any later load of the chain before a
   rebinding statement is a finding. Nested ``def``/``lambda`` bodies are
   skipped (they execute at an unknown time).

This is a lexical, single-block approximation: loops that donate on one
iteration and read on the next are out of scope (none exist here — the
fixture corpus pins the supported shapes).
"""

from __future__ import annotations

import ast

from ..engine import FileCtx, Finding, ProjectContext, Rule, assigned_keys, expr_key

_SHARED_KEY = "don.table"


def _donate_indices_of_jit_call(call: ast.Call) -> set[int] | None:
    """Indices from a ``jax.jit(...)`` or ``functools.partial(jax.jit,
    ...)`` call expression carrying ``donate_argnums``; None if this isn't
    such an expression."""
    func = call.func
    is_jit = (
        isinstance(func, ast.Attribute)
        and func.attr == "jit"
        or isinstance(func, ast.Name)
        and func.id == "jit"
    )
    is_partial_of_jit = (
        isinstance(func, ast.Attribute)
        and func.attr == "partial"
        or isinstance(func, ast.Name)
        and func.id == "partial"
    ) and any(
        (isinstance(a, ast.Attribute) and a.attr == "jit")
        or (isinstance(a, ast.Name) and a.id == "jit")
        for a in call.args[:1]
    )
    if not (is_jit or is_partial_of_jit):
        return None
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            return _int_tuple(kw.value)
    return None


def _int_tuple(node: ast.AST) -> set[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        return {
            e.value
            for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, int)
        }
    return set()


class _DonationTable:
    def __init__(self):
        # bare function name -> donated positional indices (module-level
        # jitted defs, merged project-wide; collisions union)
        self.defs: dict[str, set[int]] = {}
        # (file rel, name) -> indices for file-local `j = jax.jit(...)`
        self.names: dict[tuple[str, str], set[int]] = {}
        # (file rel, attr) -> indices for `self.X = jax.jit(...)` bindings
        self.attrs: dict[tuple[str, str], set[int]] = {}

    def resolve(self, fc: FileCtx, call: ast.Call) -> tuple[set[int], str] | None:
        func = call.func
        if isinstance(func, ast.Name):
            hit = self.names.get((fc.rel, func.id))
            if hit:
                return hit, func.id
            target = fc.from_imports.get(func.id, (None, func.id))[1]
            hit = self.defs.get(target)
            if hit:
                return hit, func.id
            return None
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id in fc.module_aliases:
                hit = self.defs.get(func.attr)
                if hit:
                    return hit, f"{base.id}.{func.attr}"
                return None
            # instance attribute bound to a jitted callable in this file
            hit = self.attrs.get((fc.rel, func.attr))
            if hit:
                return hit, f"<instance>.{func.attr}"
        return None


def _partial_target_indices(
    table: _DonationTable, fc: FileCtx, target: ast.AST
) -> set[int]:
    """Donated indices of the callable being wrapped by ``functools.
    partial(target, ...)``. Unlike call-site resolution, a plain-attribute
    target (``self._forward_single``) falls back to the decorated-def
    table by terminal name — the wrapped function is being *named*, not
    called through an arbitrary object."""
    if isinstance(target, ast.Name):
        return (
            table.names.get((fc.rel, target.id))
            or table.defs.get(fc.from_imports.get(target.id, (None, target.id))[1])
            or set()
        )
    if isinstance(target, ast.Attribute):
        return (
            table.attrs.get((fc.rel, target.attr))
            or table.defs.get(target.attr)
            or set()
        )
    return set()


class DonationRule(Rule):
    id = "DON-001"
    severity = "error"
    short = "read of a buffer after it was donated to a jitted call"

    # -- pass 1: donation table -----------------------------------------

    def prepare(self, project: ProjectContext) -> None:
        table = _DonationTable()
        # sweep 1: decorated defs + direct jax.jit(...) bindings
        for fc in project.files:
            for node in ast.walk(fc.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        if isinstance(dec, ast.Call):
                            idxs = _donate_indices_of_jit_call(dec)
                            if idxs:
                                table.defs.setdefault(node.name, set()).update(idxs)
                elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    idxs = _donate_indices_of_jit_call(node.value)
                    if not idxs:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Attribute):
                            table.attrs.setdefault((fc.rel, t.attr), set()).update(idxs)
                        elif isinstance(t, ast.Name):
                            table.names.setdefault((fc.rel, t.id), set()).update(idxs)
        # sweep 2: one-step propagation (`self.X = jitted_local` and
        # `self.X = functools.partial(donor, a, b, ...)`)
        for fc in project.files:
            for node in ast.walk(fc.tree):
                if not (isinstance(node, ast.Assign) and node.targets):
                    continue
                idxs: set[int] = set()
                value = node.value
                if isinstance(value, ast.Name):
                    idxs = table.names.get((fc.rel, value.id), set())
                elif isinstance(value, ast.Call):
                    func = value.func
                    is_partial = (
                        isinstance(func, ast.Attribute) and func.attr == "partial"
                    ) or (isinstance(func, ast.Name) and func.id == "partial")
                    if is_partial and value.args:
                        inner = _partial_target_indices(table, fc, value.args[0])
                        if inner:
                            bound = len(value.args) - 1
                            idxs = {i - bound for i in inner if i - bound >= 0}
                if not idxs:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute):
                        table.attrs.setdefault((fc.rel, t.attr), set()).update(idxs)
                    elif isinstance(t, ast.Name):
                        table.names.setdefault((fc.rel, t.id), set()).update(idxs)
        project.shared[_SHARED_KEY] = table

    # -- pass 2: per-function read-after-donation ------------------------

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        table: _DonationTable = project.shared[_SHARED_KEY]  # type: ignore[assignment]
        out: list[Finding] = []
        scopes: list[ast.AST] = [fc.tree] + [
            n
            for n in ast.walk(fc.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            out.extend(self._check_scope(table, fc, scope))
        return out

    def _walk_scope(self, scope: ast.AST):
        """Walk a function body without descending into nested functions
        (their execution time is unknown)."""
        body = scope.body if hasattr(scope, "body") else []
        stack = list(body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def _check_scope(
        self, table: _DonationTable, fc: FileCtx, scope: ast.AST
    ) -> list[Finding]:
        # (poison position, donated key, callee label, donated index)
        poisons: list[tuple[tuple[int, int], str, str, int]] = []
        kills: dict[str, list[tuple[int, int]]] = {}
        loads: dict[str, list[tuple[tuple[int, int], ast.AST]]] = {}
        keys_of_interest: set[str] = set()

        # first sweep of the scope: find donations and rebinding statements
        for node in self._walk_scope(scope):
            if isinstance(node, ast.stmt):
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    # the target rebinds at the loop HEADER — body loads
                    # are healed, loads in the iterable itself are not
                    kill_line = node.iter.end_lineno or node.lineno
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    kill_line = max(
                        i.context_expr.end_lineno or node.lineno
                        for i in node.items
                    )
                else:
                    kill_line = node.end_lineno or node.lineno
                for key in assigned_keys(node):
                    kills.setdefault(key, []).append((kill_line, 10**9))
            elif isinstance(node, ast.NamedExpr):
                key = expr_key(node.target)
                if key:
                    kills.setdefault(key, []).append(
                        (node.end_lineno or node.lineno, 10**9)
                    )
            if not isinstance(node, ast.Call):
                continue
            hit = table.resolve(fc, node)
            if hit is None:
                continue
            indices, label = hit
            stmt = fc.statement_of(node)
            if isinstance(stmt, (ast.Return, ast.Raise)):
                # control flow leaves the scope with the donating call —
                # no later read in this scope is reachable
                continue
            rebound = assigned_keys(stmt)
            for idx in sorted(indices):
                if idx >= len(node.args):
                    continue
                key = expr_key(node.args[idx])
                if key is None or key in rebound:
                    continue  # computed arg, or the self-healing `x = f(x)`
                keys_of_interest.add(key)
                poisons.append(
                    (
                        (stmt.end_lineno or stmt.lineno, 10**9),
                        key,
                        label,
                        idx,
                    )
                )
        if not poisons:
            return []

        # second sweep: loads of the poisoned chains. An AugAssign target
        # (`cache += 1`) READS the deleted value first, so it is a load,
        # never a heal.
        for node in self._walk_scope(scope):
            key = None
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                key = expr_key(node)
            elif isinstance(node, ast.AugAssign):
                key = expr_key(node.target)
            if key in keys_of_interest:
                loads.setdefault(key, []).append(
                    ((node.lineno, node.col_offset), node)
                )

        out: list[Finding] = []
        flagged: set[tuple[int, int]] = set()
        for poison_pos, key, label, idx in poisons:
            for load_pos, load_node in loads.get(key, []):
                if load_pos <= poison_pos:
                    continue
                healed = any(
                    poison_pos < kill_pos < load_pos
                    for kill_pos in kills.get(key, [])
                )
                if healed or load_pos in flagged:
                    continue
                flagged.add(load_pos)
                out.append(
                    self.finding(
                        fc,
                        load_node,
                        f"`{key}` is read here but was donated to"
                        f" `{label}` (donate_argnums index {idx}) on line"
                        f" {poison_pos[0]} — the buffer is deleted at"
                        " dispatch; rebind it from the call's result"
                        " (`x = f(x)`) before any further use",
                    )
                )
        return out
