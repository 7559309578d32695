"""stale-guard checker: handlers that consume ``(epoch, seq)``-versioned
messages must compare them for monotonicity before acting.

In this stack every cross-replica message that mutates state carries an
``(epoch, seq)`` pair (lighthouse leases, shard-directory announces,
snapshot manifests). A handler that extracts both fields but never
compares them will happily apply a delayed duplicate from a previous
epoch — the classic zombie-writer bug the paper's reconfiguration
protocol exists to prevent.

Detection: a function whose body *loads* both an ``"epoch"`` and a
``"seq"`` field (via ``msg["epoch"]`` / ``msg.get("epoch")`` /
``payload.epoch`` attribute access, or parameters named ``epoch``/``seq``)
must also contain at least one ordering comparison (``<``, ``>``, ``<=``,
``>=``, ``!=``) whose operands mention an epoch/seq-derived name, or a
tuple compare of both. Functions named like constructors/serializers
(``__init__``, ``to_*``, ``encode*``, ``snapshot*``) are skipped — they
produce versions rather than consume them.
"""

from __future__ import annotations

import ast
from typing import List, Set

from torchft_tpu_torch.analysis.core import Finding, Repo, dotted_name

_FIELDS = ("epoch", "seq")
_ORDERING_OPS = (ast.Lt, ast.Gt, ast.LtE, ast.GtE, ast.NotEq)
_PRODUCER_PREFIXES = ("to_", "encode", "snapshot", "make_", "build_")


def _field_of(node: ast.AST) -> str | None:
    """Which versioned field (if any) this expression loads."""
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        key = node.slice
        if isinstance(key, ast.Constant) and key.value in _FIELDS:
            return key.value
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name.endswith(".get") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and arg.value in _FIELDS:
                return arg.value
    if isinstance(node, ast.Attribute) and node.attr in _FIELDS:
        return node.attr
    return None


def _versioned_names(fn: ast.AST) -> Set[str]:
    """Names bound from epoch/seq field loads (``e = msg["epoch"]``),
    plus parameters literally named epoch/seq."""
    names: Set[str] = set(_FIELDS)
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.arg in _FIELDS:
                names.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _field_of(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        if isinstance(node, (ast.Tuple,)) and isinstance(
            getattr(node, "ctx", None), ast.Store
        ):
            pass  # tuple unpack handled below via parent Assign
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Tuple
        ):
            for t in node.targets:
                if isinstance(t, ast.Tuple) and len(t.elts) == len(
                    node.value.elts
                ):
                    for tgt, val in zip(t.elts, node.value.elts):
                        if isinstance(tgt, ast.Name) and _field_of(val):
                            names.add(tgt.id)
    return names


def _mentions_version(node: ast.AST, names: Set[str]) -> bool:
    for sub in ast.walk(node):
        if _field_of(sub):
            return True
        if isinstance(sub, ast.Name) and sub.id in names:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in names:
            return True
    return False


def _has_guard(fn: ast.AST, names: Set[str]) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, _ORDERING_OPS) for op in node.ops):
            continue
        operands = [node.left, *node.comparators]
        if any(_mentions_version(o, names) for o in operands):
            return True
    return False


def check(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    for src in repo.sources:
        for node in ast.walk(src.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if node.name == "__init__" or node.name.startswith(
                _PRODUCER_PREFIXES
            ):
                continue
            loaded = set()
            for sub in ast.walk(node):
                f = _field_of(sub)
                if f:
                    loaded.add(f)
            if loaded != {"epoch", "seq"}:
                continue  # consumes at most one field: not a versioned msg
            names = _versioned_names(node)
            if _has_guard(node, names):
                continue
            findings.append(
                Finding(
                    checker="stale-guard",
                    rule="missing-stale-guard",
                    path=src.rel,
                    line=node.lineno,
                    key=node.name,
                    message=(
                        f"{node.name}() consumes both epoch and seq but "
                        "never compares them for monotonicity — a delayed "
                        "duplicate from an old epoch will be applied"
                    ),
                )
            )
    return findings
