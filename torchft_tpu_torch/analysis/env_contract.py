"""env-contract checker: every ``TORCHFT_*`` env read must be registered,
documented, and doctor-covered; every registered knob must be alive.

Counterpart of ``torchft_tpu/analysis/env_contract.py`` over the port: the
registry is ``torchft_tpu_torch/knobs.py``, the knob index is the README's
``### Knobs`` table (``README.md#knobs``, ``knobs.DOC``) and each knob's
doc anchor names a doc that ``core.load_repo`` loaded.

Read shapes understood (the repo's actual idioms):

- ``os.environ.get(K)`` / ``os.environ[K]`` / ``os.getenv(K)``
- ``knobs.env_raw(K)`` and the typed ``knobs.env_*`` wrappers
- one level of helper indirection: a local function whose parameter feeds
  any of the above (``_pick(env, ...)`` / ``_get(name, ...)``) has its
  call sites resolved instead, so the `from_env` pattern every config
  class uses resolves to real knob names.

``K`` itself may be a string literal, a module-level ``*_ENV`` constant,
or a constant imported from another module (resolved via the repo-wide
constant table when unambiguous).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from torchft_tpu_torch import knobs
from torchft_tpu_torch.analysis.core import Finding, Repo, Source, dotted_name

_KNOB_WRAPPERS = {"env_raw", "env_str", "env_int", "env_float", "env_bool"}


def _env_key_expr(node: ast.AST) -> Optional[ast.expr]:
    """If ``node`` is an env-read expression, return the key expression."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        last = name.rsplit(".", 1)[-1]
        if name.endswith("environ.get") or last == "getenv":
            return node.args[0] if node.args else None
        if last in _KNOB_WRAPPERS and (
            "knobs" in name or name in _KNOB_WRAPPERS
        ):
            return node.args[0] if node.args else None
        return None
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if dotted_name(node.value).endswith("environ"):
            key = node.slice
            return key if isinstance(key, ast.expr) else None
    return None


class _FunctionIndex(ast.NodeVisitor):
    """Map every env-read key expression to its enclosing function def."""

    def __init__(self) -> None:
        self.func_stack: List[ast.AST] = []
        self.reads: List[Tuple[ast.expr, Optional[ast.AST], int]] = []
        self.calls_by_name: Dict[str, List[ast.Call]] = {}

    def _visit_func(self, node: ast.AST) -> None:
        self.func_stack.append(node)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name):
            self.calls_by_name.setdefault(node.func.id, []).append(node)
        key = _env_key_expr(node)
        if key is not None:
            self.reads.append(
                (key, self.func_stack[-1] if self.func_stack else None,
                 node.lineno)
            )
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        key = _env_key_expr(node)
        if key is not None:
            self.reads.append(
                (key, self.func_stack[-1] if self.func_stack else None,
                 node.lineno)
            )
        self.generic_visit(node)


def _param_names(fn: ast.AST) -> List[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    return [a.arg for a in args.posonlyargs + args.args]


def _resolve_key(
    repo: Repo, src: Source, key: ast.expr
) -> Optional[str]:
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return key.value
    if isinstance(key, ast.Name):
        return repo.resolve_constant(src, key.id)
    return None


def collect_env_reads(repo: Repo) -> List[Tuple[Source, int, str]]:
    """All resolved TORCHFT_* env reads as (source, line, knob name)."""
    out: List[Tuple[Source, int, str]] = []
    for src in repo.sources:
        if src.path.name == "knobs.py":
            continue  # the registry implementation, not a consumer
        idx = _FunctionIndex()
        idx.visit(src.tree)
        for key, fn, line in idx.reads:
            resolved = _resolve_key(repo, src, key)
            if resolved is not None:
                if resolved.startswith("TORCHFT_"):
                    out.append((src, line, resolved))
                continue
            # helper indirection: the key is a parameter of the enclosing
            # function — resolve that function's call sites instead
            if not (isinstance(key, ast.Name) and fn is not None):
                continue
            params = _param_names(fn)
            if key.id not in params:
                continue
            pos = params.index(key.id)
            fn_name = getattr(fn, "name", "")
            for call in idx.calls_by_name.get(fn_name, []):
                arg: Optional[ast.expr] = None
                if len(call.args) > pos:
                    arg = call.args[pos]
                else:
                    for kw in call.keywords:
                        if kw.arg == key.id:
                            arg = kw.value
                if arg is None:
                    continue
                resolved = _resolve_key(repo, src, arg)
                if resolved is not None and resolved.startswith("TORCHFT_"):
                    out.append((src, call.lineno, resolved))
    return out


def _doctor_check_names(repo: Repo) -> Set[str]:
    doctor = repo.by_name("doctor.py")
    if doctor is None:
        return set()
    names: Set[str] = set()
    for node in doctor.tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else []
        )
        if not any(
            isinstance(t, ast.Name) and t.id == "CHECKS" for t in targets
        ):
            continue
        value = node.value
        if value is None or not isinstance(value, (ast.List, ast.Tuple)):
            continue
        for elt in value.elts:
            if (
                isinstance(elt, ast.Tuple)
                and elt.elts
                and isinstance(elt.elts[0], ast.Constant)
                and isinstance(elt.elts[0].value, str)
            ):
                names.add(elt.elts[0].value)
    return names


def check(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    reads = collect_env_reads(repo)
    read_names = {name for _, _, name in reads}
    registry = knobs.all_knobs()
    doctor_checks = _doctor_check_names(repo)
    index_text = repo.docs.get(knobs.DOC, "")

    # 1) reads of unregistered knobs
    seen: Set[Tuple[str, str]] = set()
    for src, line, name in reads:
        if name in registry or (src.rel, name) in seen:
            continue
        seen.add((src.rel, name))
        findings.append(
            Finding(
                checker="env-contract",
                rule="unregistered-read",
                path=src.rel,
                line=line,
                key=name,
                message=(
                    f"{name} is read here but not registered in "
                    "torchft_tpu_torch/knobs.py — declare it (type, default, doc "
                    "anchor, doctor coverage)"
                ),
            )
        )

    knobs_rel = "torchft_tpu_torch/knobs.py"
    for name, knob in sorted(registry.items()):
        # 2) registered but never read anywhere: dead knob
        if name not in read_names:
            findings.append(
                Finding(
                    checker="env-contract",
                    rule="dead-knob",
                    path=knobs_rel,
                    line=1,
                    key=name,
                    message=(
                        f"{name} is registered but never read in the "
                        "package — remove it or wire it up"
                    ),
                )
            )
        # 3) registered but absent from the README's knob index
        if index_text and name not in index_text:
            findings.append(
                Finding(
                    checker="env-contract",
                    rule="undocumented-knob",
                    path=knobs_rel,
                    line=1,
                    key=name,
                    message=(
                        f"{name} is not mentioned in {knobs.DOC} — add it "
                        "to the knob table"
                    ),
                )
            )
        # 3b) the doc anchor must point at a doc file that mentions it
        doc_file = knob.doc.split("#", 1)[0]
        doc_text = repo.docs.get(doc_file)
        if doc_text is not None and name not in doc_text:
            findings.append(
                Finding(
                    checker="env-contract",
                    rule="doc-anchor-drift",
                    path=knobs_rel,
                    line=1,
                    key=name,
                    message=(
                        f"{name} declares doc anchor {knob.doc!r} but "
                        f"{doc_file} never mentions it"
                    ),
                )
            )
        # 4) doctor coverage
        if knob.doctor is None:
            findings.append(
                Finding(
                    checker="env-contract",
                    rule="undoctored-knob",
                    path=knobs_rel,
                    line=1,
                    key=name,
                    message=(
                        f"{name} has no doctor check validating it — add "
                        "coverage or baseline with a justification"
                    ),
                )
            )
        elif doctor_checks and knob.doctor not in doctor_checks:
            findings.append(
                Finding(
                    checker="env-contract",
                    rule="doctor-check-missing",
                    path=knobs_rel,
                    line=1,
                    key=name,
                    message=(
                        f"{name} claims doctor coverage by "
                        f"{knob.doctor!r}, but doctor.py has no such check"
                    ),
                )
            )
    return findings
