"""LCK-001 / LCK-002 — lock discipline around ``BatchScheduler._cond``.

History: the Sarathi-style chunked prefill exists precisely because a
blocking prefill dispatch loop ran while ``self._cond`` was held, starving
co-batched decode joins for the whole prompt. The convention the scheduler
settled on — dispatch under the lock, block outside it, ``_locked``-suffixed
helpers assume the lock — lives in engine/batch.py's section comments.
These rules make the convention machine-checked:

* **LCK-001** — a call to a ``*_locked`` function must happen either
  lexically inside a ``with self._cond:`` (any configured lock attribute)
  or from a function that is itself ``*_locked``. Crossing a nested
  ``def``/``lambda`` boundary discards the guarantee (the closure runs
  later, lock state unknown).
* **LCK-002** — no blocking operation inside a lock-held region (a
  ``with self._cond:`` body or a ``*_locked`` function): device syncs
  (``block_until_ready``, ``jax.device_get``, ``np.asarray`` on device
  values), ``time.sleep``, the scheduler's blocking ``_fetch``, and
  socket/HTTP primitives. ``self._cond.wait()`` is exempt — it *releases*
  the lock while waiting.
* **LCK-003** — the declared lock hierarchy
  (pyproject's ``[tool.dllama.analysis.locks]``: "Class._attr" → rank, ascending
  acquire order, leaf locks max-rank) is enforced over an interprocedural
  acquisition graph: every ``with <lock>:`` region / ``.acquire()``
  window is walked for the locks it acquires lexically or transitively
  (through ``self.method``/``obj.method`` calls resolved within the
  scanned set), and an edge that acquires rank ≤ a held rank — or any
  cycle the graph closes — is a finding. History: the JAX package's
  CPU mocks surfaced a real enqueue-order deadlock on the dispatch lock, and the
  scheduler→pool order lived only in prose (server/replicas.py) until
  this rule. Resolution is deliberately under-approximate (ambiguous
  attribute or method names are skipped) so the gate stays quiet on
  correct code; the runtime witness (distributed_llama_tpu_torch/lockcheck.py)
  covers the dynamic edges the AST cannot see (callbacks, supervisor
  threads).
* **LCK-004** — an attribute mutated under a held lock anywhere in its
  class must not be mutated outside one elsewhere (``__init__`` is
  exempt: construction happens-before publication). History: the JAX
  replica pool shipped a real lost-update race on a bare ``self.replayed_total += 1``
  next to the locked mutation path.
"""

from __future__ import annotations

import ast

from ..engine import FileCtx, Finding, ProjectContext, Rule

# terminal call names that block the calling thread; np/jax-qualified
# entries are checked with their base, bare entries match any base
_BLOCKING_ATTRS = {"block_until_ready", "_fetch", "urlopen", "getaddrinfo",
                   "create_connection"}
_BLOCKING_QUALIFIED = {
    ("jax", "device_get"),
    ("np", "asarray"),
    ("numpy", "asarray"),
    ("time", "sleep"),
}


def _call_name(func: ast.AST) -> tuple[str | None, str | None]:
    """(base name or None, terminal name) of a call target."""
    if isinstance(func, ast.Name):
        return None, func.id
    if isinstance(func, ast.Attribute):
        base = func.value.id if isinstance(func.value, ast.Name) else None
        return base, func.attr
    return None, None


def _is_lock_expr(node: ast.AST, lock_attrs: tuple[str, ...]) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr in lock_attrs
    if isinstance(node, ast.Name):
        return node.id in lock_attrs
    return False


def _lock_state(fc: FileCtx, node: ast.AST, lock_attrs: tuple[str, ...]) -> bool:
    """True when the lock is known-held at ``node``: a ``with <lock>:``
    ancestor inside the same function, or an enclosing ``*_locked``
    function. Walking stops at the first function boundary — only that
    function's own name can vouch for the lock beyond it."""
    cur = node
    for anc in fc.ancestors(cur):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            if any(_is_lock_expr(i.context_expr, lock_attrs) for i in anc.items):
                return True
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc.name.endswith("_locked")
        elif isinstance(anc, ast.Lambda):
            return False
    return False


def _acquire_window_state(
    fc: FileCtx, node: ast.AST, lock_attrs: tuple[str, ...]
) -> bool:
    """True when ``node`` sits between an ``<lock>.acquire()`` call and
    the first matching ``<lock>.release()`` (or function end) in its own
    enclosing function — the try/finally trylock pattern the fleet ops
    path uses, which a ``with``-only check can't see."""
    fn = fc.enclosing_function(node)
    if fn is None or isinstance(fn, ast.Lambda):
        return False
    line = getattr(node, "lineno", 0)
    fn_end = max(getattr(fn, "end_lineno", fn.lineno), fn.lineno)
    for sub in ast.walk(fn):
        if not (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "acquire"
            and _is_lock_expr(sub.func.value, lock_attrs)
        ):
            continue
        end = fn_end
        for sub2 in ast.walk(fn):
            if (
                isinstance(sub2, ast.Call)
                and isinstance(sub2.func, ast.Attribute)
                and sub2.func.attr == "release"
                and ast.dump(sub2.func.value) == ast.dump(sub.func.value)
                and sub2.lineno > sub.lineno
            ):
                end = min(end, sub2.lineno)
        if sub.lineno <= line <= end:
            return True
    return False


class LockedCallRule(Rule):
    """LCK-001: ``*_locked`` helpers reached without the lock."""

    id = "LCK-001"
    severity = "error"
    short = "call to a *_locked function without holding the scheduler lock"

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        lock_attrs = project.config.lock_attrs
        out: list[Finding] = []
        for node in ast.walk(fc.tree):
            if not isinstance(node, ast.Call):
                continue
            _, name = _call_name(node.func)
            if not name or not name.endswith("_locked"):
                continue
            if _lock_state(fc, node, lock_attrs):
                continue
            out.append(
                self.finding(
                    fc,
                    node,
                    f"`{name}` follows the _locked convention (caller must"
                    f" hold {'/'.join(lock_attrs)}) but no enclosing"
                    " `with <lock>:` or *_locked function vouches for the"
                    " lock here",
                )
            )
        return out


class BlockingUnderLockRule(Rule):
    """LCK-002: blocking operations inside a lock-held region."""

    id = "LCK-002"
    severity = "error"
    short = "blocking call while holding the scheduler lock"

    def check(self, project: ProjectContext, fc: FileCtx) -> list[Finding]:
        cfg = project.config
        lock_attrs = cfg.lock_attrs
        extra = set(cfg.blocking_calls)
        out: list[Finding] = []
        for node in ast.walk(fc.tree):
            if not isinstance(node, ast.Call):
                continue
            base, name = _call_name(node.func)
            if not name:
                continue
            blocking = (
                name in _BLOCKING_ATTRS
                or name in extra
                or (base, name) in _BLOCKING_QUALIFIED
                or (
                    name == "sleep"
                    and base is None
                    and fc.from_imports.get("sleep", ("", ""))[0] == "time"
                )
            )
            if not blocking:
                continue
            # cond.wait()/lock.acquire-style calls ON the lock are the
            # coordination primitives themselves, not foreign blocking work
            if isinstance(node.func, ast.Attribute) and _is_lock_expr(
                node.func.value, lock_attrs
            ):
                continue
            if not _lock_state(fc, node, lock_attrs):
                continue
            label = f"{base}.{name}" if base else name
            out.append(
                self.finding(
                    fc,
                    node,
                    f"blocking call `{label}(...)` while"
                    f" {'/'.join(lock_attrs)} is held — joins and co-batched"
                    " decode stall behind it (move it outside the `with`, or"
                    " justify with a noqa stating why the block is bounded)",
                )
            )
        return out


# ---------------------------------------------------------------------------
# LCK-003 — the declared lock hierarchy, statically enforced
# ---------------------------------------------------------------------------


def _enclosing_class(fc: FileCtx, node: ast.AST) -> str | None:
    for anc in fc.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc.name
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # keep walking: methods sit inside their class
            continue
    return None


class _LockIndex:
    """Cross-file facts for LCK-003/LCK-004: class→methods, method-name→
    owning classes, module-level functions, and the rank table. Shared via
    ``project.shared`` so both rules build it once."""

    KEY = "lck.index"

    def __init__(self, project: ProjectContext):
        self.ranks: dict[str, int] = dict(project.config.lock_ranks)
        self.classes: dict[str, dict[str, tuple[FileCtx, ast.AST]]] = {}
        self.method_owners: dict[str, set[str]] = {}
        self.module_funcs: dict[str, list[tuple[FileCtx, ast.AST]]] = {}
        self.class_locks: dict[str, list[str]] = {}
        for key in self.ranks:
            cls, _, _attr = key.rpartition(".")
            self.class_locks.setdefault(cls, []).append(key)
        for fc in project.files:
            for node in fc.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.module_funcs.setdefault(node.name, []).append(
                        (fc, node)
                    )
                elif isinstance(node, ast.ClassDef):
                    methods = self.classes.setdefault(node.name, {})
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            methods.setdefault(item.name, (fc, item))
                            self.method_owners.setdefault(
                                item.name, set()
                            ).add(node.name)

    @classmethod
    def of(cls, project: ProjectContext) -> "_LockIndex":
        idx = project.shared.get(cls.KEY)
        if idx is None:
            idx = project.shared[cls.KEY] = cls(project)
        return idx

    # -- resolution (deliberately under-approximate) --------------------

    def resolve_lock(self, expr: ast.AST, cls_name: str | None) -> str | None:
        """"Class._attr" rank-table id for a lock expression, or None when
        the expression is computed or the attr name is ambiguous."""
        if not isinstance(expr, ast.Attribute):
            return None
        if not isinstance(expr.value, ast.Name):
            return None
        base, attr = expr.value.id, expr.attr
        if base == "self" and cls_name:
            key = f"{cls_name}.{attr}"
            if key in self.ranks:
                return key
        cands = [k for k in self.ranks if k.endswith("." + attr)]
        if len(cands) == 1:
            return cands[0]
        if base != "self" and len(cands) > 1:
            # `pool._cond` → ReplicaPool._cond: the variable name names
            # the class (the repo's pervasive convention)
            stem = base.strip("_").lower()
            hits = [k for k in cands if stem and stem in k.split(".")[0].lower()]
            if len(hits) == 1:
                return hits[0]
        return None

    def resolve_call(
        self, func: ast.AST, cls_name: str | None
    ) -> tuple[str, str] | None:
        """(class, method) / ("", function) key for a call target, or None
        when the target is computed, foreign, or ambiguous."""
        if isinstance(func, ast.Name):
            hits = self.module_funcs.get(func.id, [])
            return ("", func.id) if len(hits) == 1 else None
        if not (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
        ):
            return None
        base, name = func.value.id, func.attr
        if base == "self" and cls_name and name in self.classes.get(cls_name, {}):
            return (cls_name, name)
        owners = self.method_owners.get(name, set())
        if len(owners) == 1:
            return (next(iter(owners)), name)
        if base != "self" and len(owners) > 1:
            stem = base.strip("_").lower()
            hits = [o for o in owners if stem and stem in o.lower()]
            if len(hits) == 1:
                return (hits[0], name)
        return None

    def fn_of(self, key: tuple[str, str]) -> tuple[FileCtx, ast.AST] | None:
        cls, name = key
        if cls:
            return self.classes.get(cls, {}).get(name)
        hits = self.module_funcs.get(name, [])
        return hits[0] if len(hits) == 1 else None


class LockOrderRule(Rule):
    """LCK-003: acquisition edges that violate the declared lock ranks."""

    id = "LCK-003"
    severity = "error"
    short = "lock acquisition violates the declared [tool.dllama.analysis.locks] hierarchy"

    def prepare(self, project: ProjectContext) -> None:
        self._idx = _LockIndex.of(project)
        # (class, name) -> {"direct": {lock: node}, "calls": [(key, node, holders)]}
        self._fns: dict[tuple[str, str], dict] = {}
        self._eff: dict[tuple[str, str], dict[str, list[str]]] = {}
        self._edges: list[tuple[str, str, FileCtx, ast.AST, list[str]]] = []
        if not self._idx.ranks:
            return
        for fc in project.files:
            for node in ast.walk(fc.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_function(fc, node)
        self._fixpoint()
        self._transitive_edges()

    # -- per-function lexical walk --------------------------------------

    def _scan_function(self, fc: FileCtx, fn: ast.AST) -> None:
        idx = self._idx
        cls = _enclosing_class(fc, fn)
        key = (cls or "", fn.name)
        info = self._fns.setdefault(
            key, {"direct": {}, "calls": [], "fc": fc}
        )
        # acquire()/release() windows: line spans inside this function
        windows: list[tuple[str, int, int]] = []
        end = max(getattr(fn, "end_lineno", fn.lineno), fn.lineno)
        for sub in ast.walk(fn):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "acquire"
            ):
                continue
            lock = idx.resolve_lock(sub.func.value, cls)
            if lock is None:
                continue
            rel_lineno = sub.lineno
            rel_end = end
            for sub2 in ast.walk(fn):
                if (
                    isinstance(sub2, ast.Call)
                    and isinstance(sub2.func, ast.Attribute)
                    and sub2.func.attr == "release"
                    and idx.resolve_lock(sub2.func.value, cls) == lock
                    and sub2.lineno > rel_lineno
                ):
                    rel_end = min(rel_end, sub2.lineno)
            windows.append((lock, rel_lineno, rel_end))
            info["direct"].setdefault(lock, sub)
        held0: list[str] = []
        if fn.name.endswith("_locked") and cls:
            own = self._idx.class_locks.get(cls, [])
            if len(own) == 1:
                held0 = [own[0]]

        def window_holds(lineno: int) -> list[str]:
            return [w[0] for w in windows if w[1] <= lineno <= w[2]]

        def walk(node: ast.AST, held: list[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue  # runs later; lock state unknown (LCK-001's rule)
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    got = [
                        lock
                        for item in child.items
                        if (
                            lock := idx.resolve_lock(item.context_expr, cls)
                        )
                        is not None
                    ]
                    for lock in got:
                        info["direct"].setdefault(lock, child)
                        for held_lock in held + window_holds(child.lineno):
                            self._edge(held_lock, lock, fc, child, [])
                    walk(child, held + got)
                    continue
                if isinstance(child, ast.Call):
                    if (
                        isinstance(child.func, ast.Attribute)
                        and child.func.attr == "acquire"
                    ):
                        lock = idx.resolve_lock(child.func.value, cls)
                        if lock is not None:
                            holders = [
                                h
                                for h in held + window_holds(child.lineno)
                                if h != lock
                            ]
                            for held_lock in holders:
                                self._edge(held_lock, lock, fc, child, [])
                    callee = idx.resolve_call(child.func, cls)
                    if callee is not None:
                        holders = sorted(
                            set(held) | set(window_holds(child.lineno))
                        )
                        info["calls"].append((callee, child, holders))
                walk(child, held)

        walk(fn, held0)
        if held0:
            # the *_locked convention: the class lock is held on entry, so
            # every direct acquisition in the body is an edge from it
            for lock, node in info["direct"].items():
                if lock != held0[0]:
                    self._edge(held0[0], lock, fc, node, [])

    def _edge(
        self,
        held: str,
        acquired: str,
        fc: FileCtx,
        node: ast.AST,
        via: list[str],
    ) -> None:
        if held == acquired:
            return  # reentrant same-lock entry (Condition/RLock); the
            # runtime witness distinguishes plain-Lock self-deadlock
        self._edges.append((held, acquired, fc, node, via))

    # -- interprocedural closure ----------------------------------------

    def _fixpoint(self) -> None:
        # eff[f]: lock -> call-chain (qualnames) that reaches it from f
        eff: dict[tuple[str, str], dict[str, list[str]]] = {}
        for key, info in self._fns.items():
            eff[key] = {lock: [] for lock in info["direct"]}
        changed = True
        guard = 0
        while changed and guard < 50:
            changed = False
            guard += 1
            for key, info in self._fns.items():
                mine = eff[key]
                for callee, _node, _holders in info["calls"]:
                    sub = eff.get(callee)
                    if not sub:
                        continue
                    label = (
                        f"{callee[0]}.{callee[1]}" if callee[0] else callee[1]
                    )
                    for lock, chain in sub.items():
                        if lock not in mine:
                            mine[lock] = [label] + chain
                            changed = True
        self._eff = eff

    def _transitive_edges(self) -> None:
        for key, info in self._fns.items():
            fc = info["fc"]
            for callee, node, holders in info["calls"]:
                if not holders:
                    continue
                sub = self._eff.get(callee)
                if not sub:
                    continue
                label = (
                    f"{callee[0]}.{callee[1]}" if callee[0] else callee[1]
                )
                for lock, chain in sub.items():
                    for held in holders:
                        self._edge(held, lock, fc, node, [label] + chain)

    # -- findings -------------------------------------------------------

    def finalize(self, project: ProjectContext) -> list[Finding]:
        ranks = self._idx.ranks if self._idx.ranks else {}
        out: list[Finding] = []
        seen: set[tuple[str, int, str, str]] = set()
        graph: dict[str, set[str]] = {}
        for held, acquired, fc, node, via in self._edges:
            graph.setdefault(held, set()).add(acquired)
            r_held, r_acq = ranks[held], ranks[acquired]
            if r_acq > r_held:
                continue
            dedup = (fc.rel, getattr(node, "lineno", 0), held, acquired)
            if dedup in seen:
                continue
            seen.add(dedup)
            path = f" via {' -> '.join(via)}" if via else ""
            out.append(
                self.finding(
                    fc,
                    node,
                    f"acquires `{acquired}` (rank {r_acq}){path} while"
                    f" `{held}` (rank {r_held}) is held — the declared"
                    " hierarchy ([tool.dllama.analysis.locks]) requires"
                    " strictly ascending ranks; invert the nesting or"
                    " re-rank the table",
                )
            )
        cycle = self._find_cycle(graph, ranks)
        if cycle is not None:
            locs = self._edge_site(cycle[0], cycle[1])
            if locs is not None:
                fc, node = locs
                out.append(
                    self.finding(
                        fc,
                        node,
                        "lock acquisition graph contains a cycle: "
                        + " -> ".join(cycle + [cycle[0]])
                        + " — two threads taking opposite arcs deadlock",
                    )
                )
        return out

    def _edge_site(
        self, held: str, acquired: str
    ) -> tuple[FileCtx, ast.AST] | None:
        for h, a, fc, node, _via in self._edges:
            if h == held and a == acquired:
                return fc, node
        return None

    def _find_cycle(
        self, graph: dict[str, set[str]], ranks: dict[str, int]
    ) -> list[str] | None:
        """First cycle made ENTIRELY of rank-legal edges (rank-violating
        edges are already individual findings)."""
        legal = {
            n: {m for m in nbrs if ranks[m] > ranks[n]}
            for n, nbrs in graph.items()
        }
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in legal}
        stack: list[str] = []

        def dfs(n: str) -> list[str] | None:
            color[n] = GREY
            stack.append(n)
            for m in sorted(legal.get(n, ())):
                if color.get(m, WHITE) == GREY:
                    return stack[stack.index(m):]
                if color.get(m, WHITE) == WHITE:
                    found = dfs(m)
                    if found is not None:
                        return found
            stack.pop()
            color[n] = BLACK
            return None

        for n in sorted(legal):
            if color[n] == WHITE:
                found = dfs(n)
                if found is not None:
                    return found
        return None


# ---------------------------------------------------------------------------
# LCK-004 — unsynchronized shared-state mutation
# ---------------------------------------------------------------------------


class SharedStateMutationRule(Rule):
    """LCK-004: a ``self.x`` attribute mutated under a lock somewhere in
    its class must not be mutated without one elsewhere (the replica
    pool's ``replayed_total`` lost-update). ``__init__`` is exempt both ways —
    construction happens-before publication."""

    id = "LCK-004"
    severity = "error"
    short = "attribute mutated both under a lock and without one"

    def prepare(self, project: ProjectContext) -> None:
        self._locked: dict[tuple[str, str], list[str]] = {}
        self._unlocked: dict[tuple[str, str], list[tuple[FileCtx, ast.AST]]] = {}
        lock_attrs = project.config.lock_attrs
        for fc in project.files:
            for node in ast.walk(fc.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.AugAssign):
                        targets = [sub.target]
                    elif isinstance(sub, ast.Assign):
                        targets = list(sub.targets)
                    elif isinstance(sub, ast.AnnAssign):
                        targets = [sub.target]
                    else:
                        continue
                    attrs = [
                        t.attr
                        for t in targets
                        if isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ]
                    if not attrs:
                        continue
                    fn = fc.enclosing_function(sub)
                    if fn is None or isinstance(fn, ast.Lambda):
                        continue
                    if fn.name == "__init__":
                        continue
                    if _enclosing_class(fc, fn) != node.name:
                        continue  # nested class's method
                    held = _lock_state(
                        fc, sub, lock_attrs
                    ) or _acquire_window_state(fc, sub, lock_attrs)
                    for attr in attrs:
                        if attr in lock_attrs:
                            continue  # rebinding the lock itself
                        key = (node.name, attr)
                        if held:
                            self._locked.setdefault(key, []).append(
                                fc.qualname(sub)
                            )
                        else:
                            self._unlocked.setdefault(key, []).append(
                                (fc, sub)
                            )

    def finalize(self, project: ProjectContext) -> list[Finding]:
        out: list[Finding] = []
        for key, sites in sorted(self._unlocked.items()):
            where = self._locked.get(key)
            if not where:
                continue
            cls, attr = key
            for fc, node in sites:
                out.append(
                    self.finding(
                        fc,
                        node,
                        f"`self.{attr}` is mutated under a lock in"
                        f" {sorted(set(where))[0]} but written here without"
                        " one — concurrent writers lose updates (the replica"
                        " pool's `replayed_total` race); move this write under the"
                        " lock or noqa with the reason it cannot race",
                    )
                )
        return out
