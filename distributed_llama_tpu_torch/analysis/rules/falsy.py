"""FLS-001 — the falsy-default bug class: ``param or DEFAULT`` eats a
meaningful zero.

History: this exact shape shipped three times in the JAX package —
``admission_queue=0`` (an explicit "unbounded queue" request silently
became the default bound) and twice in the replica pool
(``--replica-suspect-s 0`` meaning "suspect immediately" fell back to the
30s default). A numeric
parameter where ``0`` is a legal, meaningful value must be defaulted with
an ``is None`` check, never truthiness.

The rule flags ``param or <number>`` and ``param if param else <number>``
where ``param`` is a parameter of the enclosing function and the fallback
is a numeric literal (int/float, not bool). The numeric-literal
requirement is the precision filter: ``restart_policy or BackoffPolicy()``
style object defaults stay legal, because for object/str parameters
falsiness and missingness coincide in this codebase.
"""

from __future__ import annotations

import ast

from ..engine import FileCtx, Finding, ProjectContext, Rule


def _param_names(fn: ast.AST) -> set[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


def _numeric_const(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
    )


class FalsyDefaultRule(Rule):
    """FLS-001: ``param or <number>`` treats a meaningful 0 as missing."""

    id = "FLS-001"
    severity = "warning"
    short = "falsy-default on a numeric parameter (`x or N` eats a meaningful 0)"

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(fc.tree):
            hit = self._match(fc, node)
            if hit is None:
                continue
            param, default = hit
            out.append(
                self.finding(
                    fc,
                    node,
                    f"`{param} or {default}` swallows an explicit"
                    f" `{param}=0` into the {default} default (the admission-queue /"
                    " suspect-timeout falsy-default bug) — write"
                    f" `{default} if {param} is None else {param}`",
                )
            )
        return out

    def _match(self, fc: FileCtx, node: ast.AST) -> tuple[str, object] | None:
        """(param name, fallback literal) for a flagged expression."""
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
            if len(node.values) != 2:
                return None
            lhs, rhs = node.values
            if not (isinstance(lhs, ast.Name) and _numeric_const(rhs)):
                return None
            name, fallback = lhs.id, rhs.value
        elif isinstance(node, ast.IfExp):
            if not (
                isinstance(node.test, ast.Name)
                and isinstance(node.body, ast.Name)
                and node.test.id == node.body.id
                and _numeric_const(node.orelse)
            ):
                return None
            name, fallback = node.test.id, node.orelse.value
        else:
            return None
        fn = fc.enclosing_function(node)
        if fn is None or isinstance(fn, ast.Lambda):
            return None
        if name not in _param_names(fn):
            return None
        return name, fallback
