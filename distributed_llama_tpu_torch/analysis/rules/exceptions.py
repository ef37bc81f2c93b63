"""EXC-001 — swallowed ``BaseException`` (or bare ``except:``).

History: the JAX package's first retry loops caught ``BaseException``
around the batched dispatch/fetch, so a Ctrl-C mid-fetch was *retried into a row
quarantine* instead of aborting the process — the review fix narrowed them
to ``except Exception`` and the in-flight accounting moved to dedicated
cleanup-and-reraise handlers. The surviving legitimate shape is exactly
that: ``except BaseException: <undo>; raise``. This rule flags any
``BaseException``/bare handler whose body contains no ``raise`` at all —
the handler that can swallow a KeyboardInterrupt/SystemExit. Conditional
re-raises (``if not isinstance(e, Exception): raise``) count as raising;
the point is that an interpreter-exit path exists.
"""

from __future__ import annotations

import ast

from ..engine import FileCtx, Finding, ProjectContext, Rule


def _catches_base_exception(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True  # bare `except:`
    types = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    for t in types:
        if isinstance(t, ast.Name) and t.id == "BaseException":
            return True
        if isinstance(t, ast.Attribute) and t.attr == "BaseException":
            return True
    return False


def _body_raises(handler: ast.ExceptHandler) -> bool:
    stack: list[ast.AST] = list(handler.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # a raise inside a nested def runs later, if ever
        stack.extend(ast.iter_child_nodes(node))
    return False


class BaseExceptionRule(Rule):
    id = "EXC-001"
    severity = "error"
    short = "except BaseException / bare except that never re-raises"

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(fc.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _catches_base_exception(node):
                continue
            if _body_raises(node):
                continue
            what = "bare `except:`" if node.type is None else "`except BaseException`"
            out.append(
                self.finding(
                    fc,
                    node,
                    f"{what} without a re-raise swallows KeyboardInterrupt/"
                    "SystemExit — retry/recovery paths must catch"
                    " `Exception`; cleanup handlers must end in `raise`",
                )
            )
        return out
