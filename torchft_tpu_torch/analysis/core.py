"""fleetlint core: source loading, constant resolution, findings, baseline.

Counterpart of ``torchft_tpu/analysis/core.py``. Everything here is
dependency-free stdlib (``ast`` + ``json``) so the analyzer runs in CI, in
the doctor, and as a tier-1 test without touching torch or the native
plane.

The port documents itself in the README's ``## PyTorch/CUDA port``
section, not in a ``docs/`` folder: ``load_repo`` reads that section as
the doc ``README.md`` and each of its ``### `` subsections as
``README.md#<slug>`` (``### Knobs`` is ``README.md#knobs``, the index the
env contract reads; ``### Counters`` is ``README.md#counters``, the one
the counter contract reads).
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PACKAGE_ROOT = Path(__file__).resolve().parents[1]  # torchft_tpu_torch/
REPO_ROOT = PACKAGE_ROOT.parent
# the port's documentation: the README's port section
DOCS_ROOT = REPO_ROOT / "README.md"
PORT_SECTION = "## PyTorch/CUDA port"
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

# directories under torchft_tpu_torch/ that are not production source
_EXCLUDED_PARTS = {"_native", "_build", "_test", "analysis", "__pycache__"}


@dataclass(frozen=True)
class Finding:
    """One checker hit. The ``fingerprint`` intentionally excludes the
    line number so unrelated edits don't churn the committed baseline."""

    checker: str  # e.g. "env-contract"
    rule: str  # e.g. "unregistered-read"
    path: str  # repo-relative file
    line: int
    key: str  # stable identity (knob name, Class.attr, call site)
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.checker}:{self.rule}:{self.path}:{self.key}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
            f"{self.message}"
        )


@dataclass
class Source:
    """One parsed module."""

    path: Path
    rel: str  # repo-relative path
    text: str
    tree: ast.Module
    # module-level NAME = "literal" string constants
    constants: Dict[str, str] = field(default_factory=dict)
    # from X import NAME bindings (NAME -> X) for cross-module resolution
    imports: Dict[str, str] = field(default_factory=dict)


@dataclass
class Repo:
    """The loaded analysis universe: parsed sources plus doc texts."""

    sources: List[Source]
    docs: Dict[str, str]  # e.g. "README.md#knobs" -> text

    # NAME -> set of string values seen across ALL modules (fallback for
    # `from module import SOME_ENV` where the import graph isn't walked)
    global_constants: Dict[str, set] = field(default_factory=dict)

    def by_name(self, filename: str) -> Optional[Source]:
        for s in self.sources:
            if s.path.name == filename:
                return s
        return None

    def resolve_constant(self, src: Source, name: str) -> Optional[str]:
        """Resolve ``name`` to a module-level string constant: local
        module first, then (for imported names) the unique global value."""
        if name in src.constants:
            return src.constants[name]
        values = self.global_constants.get(name)
        if values is not None and len(values) == 1:
            return next(iter(values))
        return None


def _module_constants(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None or not (
            isinstance(value, ast.Constant) and isinstance(value.value, str)
        ):
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out[t.id] = value.value
    return out


def _module_imports(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
    return out


def _headings(lines: List[str]) -> List[Tuple[int, int]]:
    """(index, level) of each ``## `` / ``### `` heading outside fences."""
    out: List[Tuple[int, int]] = []
    in_fence = False
    for i, ln in enumerate(lines):
        if ln.startswith("```"):
            in_fence = not in_fence
        elif not in_fence and ln.startswith(("## ", "### ")):
            out.append((i, 3 if ln.startswith("### ") else 2))
    return out


def readme_docs(text: str, name: str = "README.md") -> Dict[str, str]:
    """A README as docs: its port section (the whole text when it has
    none) under ``name``, and each ``### `` subsection of it, up to the
    next heading of that level or above, under ``name#<slug>`` (the
    heading lowercased, its words joined by ``-``)."""
    lines = text.splitlines(keepends=True)
    heads = _headings(lines)
    start = next((i for i, _ in heads if lines[i].rstrip() == PORT_SECTION), None)
    if start is not None:
        end = next((i for i, lvl in heads if i > start and lvl == 2), len(lines))
        lines = lines[start:end]
        heads = _headings(lines)
    docs = {name: "".join(lines)}
    bounds = [i for i, _ in heads] + [len(lines)]
    for (i, lvl), nxt in zip(heads, bounds[1:]):
        if lvl == 3:
            slug = "-".join(lines[i][4:].strip().lower().split())
            docs[f"{name}#{slug}"] = "".join(lines[i:nxt])
    return docs


def load_docs(docs_root: Path) -> Dict[str, str]:
    """A README file (its port section, see ``readme_docs``), or a folder
    of ``*.md`` files by name, a ``README.md`` among them read as one."""
    docs: Dict[str, str] = {}
    if docs_root.is_file():
        return readme_docs(docs_root.read_text(), docs_root.name)
    if docs_root.is_dir():
        for doc in sorted(docs_root.glob("*.md")):
            if doc.name == "README.md":
                docs.update(readme_docs(doc.read_text()))
            else:
                docs[doc.name] = doc.read_text()
    return docs


def load_repo(
    package_root: Optional[Path] = None, docs_root: Optional[Path] = None
) -> Repo:
    package_root = package_root or PACKAGE_ROOT
    docs_root = docs_root or DOCS_ROOT
    sources: List[Source] = []
    for path in sorted(package_root.rglob("*.py")):
        rel_parts = path.relative_to(package_root).parts
        if any(p in _EXCLUDED_PARTS for p in rel_parts):
            continue
        text = path.read_text()
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError:  # stubs/templates never block the run
            continue
        try:
            rel = str(path.relative_to(package_root.parent))
        except ValueError:
            rel = str(path)
        sources.append(
            Source(
                path=path,
                rel=rel,
                text=text,
                tree=tree,
                constants=_module_constants(tree),
                imports=_module_imports(tree),
            )
        )
    repo = Repo(sources=sources, docs={})
    for src in sources:
        for name, value in src.constants.items():
            repo.global_constants.setdefault(name, set()).add(value)
    repo.docs = load_docs(docs_root)
    return repo


# --------------------------------------------------------------- ancestry
def build_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def ancestors(
    node: ast.AST, parents: Dict[ast.AST, ast.AST]
) -> Iterable[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        yield cur
        cur = parents.get(cur)


def dotted_name(node: ast.expr) -> str:
    """Best-effort dotted rendering of a Name/Attribute chain."""
    parts: List[str] = []
    cur: ast.expr = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        parts.append(dotted_name(cur.func) + "()")
    return ".".join(reversed(parts))


# --------------------------------------------------------------- baseline
def load_baseline(path: Optional[Path] = None) -> Dict[str, str]:
    """fingerprint -> justification. Missing file = empty baseline."""
    path = path or DEFAULT_BASELINE
    if not Path(path).is_file():
        return {}
    payload = json.loads(Path(path).read_text())
    out: Dict[str, str] = {}
    for entry in payload.get("findings", []):
        out[entry["fingerprint"]] = entry.get("justification", "")
    return out


def save_baseline(
    findings: List[Finding],
    path: Optional[Path] = None,
    justifications: Optional[Dict[str, str]] = None,
) -> Path:
    """Write the given findings as the accepted baseline (``--update``).
    A fingerprint with no justification given is written with an empty
    one, which ``unjustified`` reports until someone writes why it is
    accepted: the port's baseline has no default justification."""
    path = Path(path or DEFAULT_BASELINE)
    justifications = justifications or {}
    entries = []
    for f in sorted(set(f.fingerprint for f in findings)):
        entries.append(
            {"fingerprint": f, "justification": justifications.get(f, "")}
        )
    path.write_text(
        json.dumps({"version": 1, "findings": entries}, indent=2) + "\n"
    )
    return path


def diff_baseline(
    findings: List[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[str]]:
    """(new findings not in baseline, stale baseline fingerprints)."""
    fps = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    stale = sorted(fp for fp in baseline if fp not in fps)
    return new, stale


def unjustified(baseline: Dict[str, str]) -> List[str]:
    """Baseline fingerprints whose justification is empty."""
    return sorted(fp for fp, why in baseline.items() if not why.strip())


# --------------------------------------------------------------- running
def run_all(
    package_root: Optional[Path] = None,
    docs_root: Optional[Path] = None,
    checkers: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Run the selected checkers (default: all five) over the package."""
    from torchft_tpu_torch.analysis import (
        blocking_calls,
        counter_contract,
        env_contract,
        lock_discipline,
        stale_guard,
    )

    repo = load_repo(package_root, docs_root)
    registry = {
        "env-contract": env_contract.check,
        "counter-contract": counter_contract.check,
        "lock-discipline": lock_discipline.check,
        "blocking-calls": blocking_calls.check,
        "stale-guard": stale_guard.check,
    }
    selected = list(checkers) if checkers else list(registry)
    findings: List[Finding] = []
    for name in selected:
        findings.extend(registry[name](repo))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings
