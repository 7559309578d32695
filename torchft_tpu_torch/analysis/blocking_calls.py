"""blocking-call-in-hot-path checker: network calls in the hot-path
modules must either ride :func:`torchft_tpu_torch.retry.retry_call` or carry an
explicit ``timeout=``.

Scope is the modules whose threads sit on the training/serving hot path:
``manager.py``, ``serving.py``, ``redundancy.py``, ``coordination.py``.
A bare ``urlopen(url)`` there blocks its thread for the kernel default
(minutes) when a peer wedges — exactly the failure mode the paper's
fault-tolerance plane exists to bound.

Blocking shapes recognized:

- ``urllib.request.urlopen(...)`` (and bare ``urlopen``)
- ``socket.create_connection(...)``
- ``http.client.HTTPConnection(...)`` / ``HTTPSConnection(...)``
- ``requests.<verb>(...)``

A call is exempt when it has a ``timeout=`` keyword, or when it sits
lexically inside a ``retry_call(...)`` expression (whose policy owns the
deadline), or inside a function whose name ends with ``_with_timeout``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from torchft_tpu_torch.analysis.core import Finding, Repo, dotted_name

_SCOPED_MODULES = ("manager.py", "serving.py", "redundancy.py",
                   "coordination.py")
_BLOCKING_NAMES = {
    "urlopen", "create_connection", "HTTPConnection", "HTTPSConnection",
}
_RETRY_WRAPPERS = {"retry_call", "retry_call_async"}


def _is_blocking(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    last = name.rsplit(".", 1)[-1]
    if last in _BLOCKING_NAMES:
        return True
    if name.startswith("requests."):
        return True
    return False


def _has_timeout(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in call.keywords)


def check(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    for src in repo.sources:
        if src.path.name not in _SCOPED_MODULES:
            continue
        # every node lexically inside a retry_call(...) expression is
        # exempt — the retry policy owns the deadline
        exempt: Set[int] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                last = dotted_name(node.func).rsplit(".", 1)[-1]
                if last in _RETRY_WRAPPERS:
                    for sub in ast.walk(node):
                        exempt.add(id(sub))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name.endswith("_with_timeout"):
                    for sub in ast.walk(node):
                        exempt.add(id(sub))
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not _is_blocking(node):
                continue
            if id(node) in exempt or _has_timeout(node):
                continue
            callee = dotted_name(node.func) or "<call>"
            findings.append(
                Finding(
                    checker="blocking-calls",
                    rule="missing-timeout",
                    path=src.rel,
                    line=node.lineno,
                    key=f"{callee}@L{node.lineno}",
                    message=(
                        f"{callee}(...) on the hot path has no timeout= "
                        "and is not wrapped in retry_call — a wedged peer "
                        "blocks this thread for the kernel default"
                    ),
                )
            )
    return findings
