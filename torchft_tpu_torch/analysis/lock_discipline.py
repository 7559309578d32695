"""lock-discipline checker: attributes written inside a thread target and
touched from other methods must be lock-guarded everywhere.

Per class, the checker:

1. finds **thread-target methods**: any ``self._x`` passed as ``target=``
   to ``threading.Thread(...)`` (or as a ``threading.Timer`` callback)
   anywhere in the class, then closes transitively over ``self._y(...)``
   calls so helpers reached from the thread body count as thread code;
2. collects ``self.attr`` **writes** inside that closure (assignments,
   aug-assignments, and subscript stores like ``self.counters[k] += 1``),
   ignoring ``__init__`` and attributes that are synchronization
   primitives (``threading.Lock/RLock/Event/Condition`` constructions);
3. collects accesses to the same attributes from methods **outside** the
   closure — that pair is a cross-thread shared attribute;
4. demands every one of those sites sit lexically inside a
   ``with self.<lock>:`` block (any attr assigned from
   ``threading.Lock()``/``RLock()`` in ``__init__``, or named ``*lock*``),
   unless the attribute is listed in the class-level ``_atomic_attrs``
   allowlist (a tuple/set of strings with a justifying comment).

Methods whose name ends in ``_locked`` follow the repo convention "caller
holds the class lock" — their accesses count as guarded (the convention
itself is what code review enforces; this checker enforces everything
else).

One finding per (class, attribute), anchored at the first unguarded site.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding, Repo, Source, dotted_name

_SYNC_CONSTRUCTORS = {
    "Lock", "RLock", "Event", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "local",
}
_THREAD_CONSTRUCTORS = {"Thread", "Timer"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _base_self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` or ``self.x[...]`` -> ``x``."""
    attr = _self_attr(node)
    if attr is not None:
        return attr
    if isinstance(node, ast.Subscript):
        return _self_attr(node.value)
    return None


class _ClassInfo:
    def __init__(self, node: ast.ClassDef, src: Source) -> None:
        self.node = node
        self.src = src
        self.methods: Dict[str, ast.AST] = {}
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
        self.atomic_attrs = self._atomic_attrs()
        self.lock_attrs = self._lock_attrs()
        self.sync_attrs = self._sync_attrs()
        self.thread_targets = self._thread_target_closure()

    def _atomic_attrs(self) -> Set[str]:
        out: Set[str] = set()
        for item in self.node.body:
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(item, ast.Assign):
                targets, value = item.targets, item.value
            elif isinstance(item, ast.AnnAssign) and item.value is not None:
                targets, value = [item.target], item.value
            if not any(
                isinstance(t, ast.Name) and t.id == "_atomic_attrs"
                for t in targets
            ):
                continue
            if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
                for elt in value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ):
                        out.add(elt.value)
        return out

    def _attrs_assigned_from(self, ctors: Set[str]) -> Set[str]:
        out: Set[str] = set()
        for method in self.methods.values():
            for node in ast.walk(method):
                if not isinstance(node, ast.Assign):
                    continue
                value = node.value
                if not isinstance(value, ast.Call):
                    continue
                ctor = dotted_name(value.func).rsplit(".", 1)[-1]
                if ctor not in ctors:
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out.add(attr)
        return out

    def _lock_attrs(self) -> Set[str]:
        locks = self._attrs_assigned_from({"Lock", "RLock"})
        # name-based fallback for locks handed in from outside
        for method in self.methods.values():
            for node in ast.walk(method):
                attr = _self_attr(node)
                if attr is not None and "lock" in attr.lower():
                    locks.add(attr)
        return locks

    def _sync_attrs(self) -> Set[str]:
        return self._attrs_assigned_from(_SYNC_CONSTRUCTORS)

    def _thread_target_methods(self) -> Set[str]:
        """Method names passed as Thread targets / Timer callbacks."""
        out: Set[str] = set()
        for method in self.methods.values():
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                ctor = dotted_name(node.func).rsplit(".", 1)[-1]
                if ctor not in _THREAD_CONSTRUCTORS:
                    continue
                cands: List[ast.expr] = []
                for kw in node.keywords:
                    if kw.arg in ("target", "function"):
                        cands.append(kw.value)
                if ctor == "Timer" and len(node.args) >= 2:
                    cands.append(node.args[1])
                for cand in cands:
                    attr = _self_attr(cand)
                    if attr is not None and attr in self.methods:
                        out.add(attr)
        return out

    def _thread_target_closure(self) -> Set[str]:
        """Thread targets plus every self-method reachable from them."""
        closure = set(self._thread_target_methods())
        frontier = list(closure)
        while frontier:
            name = frontier.pop()
            method = self.methods.get(name)
            if method is None:
                continue
            for node in ast.walk(method):
                if isinstance(node, ast.Call):
                    attr = _self_attr(node.func)
                    if (
                        attr is not None
                        and attr in self.methods
                        and attr not in closure
                    ):
                        closure.add(attr)
                        frontier.append(attr)
        return closure


class _AccessCollector(ast.NodeVisitor):
    """Attribute accesses within one method, tagged guarded/unguarded by
    lexical ``with self.<lock>:`` nesting."""

    def __init__(self, lock_attrs: Set[str]) -> None:
        self.lock_attrs = lock_attrs
        self.guard_depth = 0
        # attr -> list of (line, guarded, is_write)
        self.accesses: Dict[str, List[Tuple[int, bool, bool]]] = {}

    def _record(self, attr: str, line: int, is_write: bool) -> None:
        self.accesses.setdefault(attr, []).append(
            (line, self.guard_depth > 0, is_write)
        )

    def _is_lock_item(self, item: ast.withitem) -> bool:
        expr = item.context_expr
        # with self._lock: …  (or a Call like self._rw.read_lock())
        attr = _base_self_attr(expr)
        if attr is None and isinstance(expr, ast.Call):
            attr = _base_self_attr(expr.func)
        return attr is not None and attr in self.lock_attrs

    def visit_With(self, node: ast.With) -> None:
        guarded = any(self._is_lock_item(item) for item in node.items)
        for item in node.items:
            self.visit(item)
        if guarded:
            self.guard_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if guarded:
            self.guard_depth -= 1

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self._record(attr, node.lineno, isinstance(node.ctx, ast.Store))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _base_self_attr(node.target)
        if attr is not None:
            self._record(attr, node.lineno, True)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        attr = _self_attr(node.value)
        if attr is not None and isinstance(node.ctx, ast.Store):
            self._record(attr, node.lineno, True)
        self.generic_visit(node)


def _collect(
    info: _ClassInfo, method: ast.AST
) -> Dict[str, List[Tuple[int, bool, bool]]]:
    c = _AccessCollector(info.lock_attrs)
    for stmt in getattr(method, "body", []):
        c.visit(stmt)
    return c.accesses


def check(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    for src in repo.sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = _ClassInfo(node, src)
            if not info.thread_targets:
                continue
            thread_acc: Dict[str, List[Tuple[int, bool, bool]]] = {}
            other_acc: Dict[str, List[Tuple[int, bool, bool]]] = {}
            for name, method in info.methods.items():
                if name == "__init__":
                    continue  # construction happens-before the thread start
                acc = _collect(info, method)
                bucket = (
                    thread_acc if name in info.thread_targets else other_acc
                )
                locked_by_convention = name.endswith("_locked")
                for attr, sites in acc.items():
                    if locked_by_convention:
                        sites = [(ln, True, w) for ln, _, w in sites]
                    bucket.setdefault(attr, []).extend(sites)
            skip = (
                info.atomic_attrs
                | info.lock_attrs
                | info.sync_attrs
                | info.thread_targets
                | set(info.methods)
            )
            for attr, t_sites in sorted(thread_acc.items()):
                if attr in skip or not any(w for _, _, w in t_sites):
                    continue  # only attrs WRITTEN from thread code
                o_sites = other_acc.get(attr)
                if not o_sites:
                    continue  # not shared outside the thread closure
                unguarded = [
                    (line, w)
                    for line, guarded, w in t_sites + o_sites
                    if not guarded
                ]
                if not unguarded:
                    continue
                line = min(line for line, _ in unguarded)
                findings.append(
                    Finding(
                        checker="lock-discipline",
                        rule="unguarded-shared-attr",
                        path=src.rel,
                        line=line,
                        key=f"{node.name}.{attr}",
                        message=(
                            f"{node.name}.{attr} is written inside a "
                            "thread target and accessed from other "
                            f"methods, but {len(unguarded)} site(s) are "
                            "outside any lock — guard them with the "
                            "class lock or add the attr to _atomic_attrs "
                            "with a justification"
                        ),
                    )
                )
    return findings
