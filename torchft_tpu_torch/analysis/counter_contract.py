"""counter-contract checker: every key emitted into ``Manager.timings()``
and the manager-side Prometheus exporter must be declared once (in
``analysis/contracts.py``) and documented in the README's ``### Counters``
subsection of the port section (``README.md#counters``, the port's
counterpart of the reference's ``docs/observability.md``); declared keys
must still exist in code.

Emission shapes understood (the repo's actual idioms):

- ``self._record_timing("key", …)`` / ``self._bump_counter("key")``
- ``self._on_metric("key", …)`` (the redundancy→Manager metrics bridge)
- dict-literal counter maps whose **values** feed ``_bump_counter`` via a
  variable (``{"heal_retry": "heal_attempts", …}.get(kind)``)
- literal subscript stores ``self._timings["key"] = …`` / ``out["key"]``
- ``for k in ("a", "b"): self._timings[k] = …`` seeding loops
- explicit exporter series: ``reg.gauge_set("torchft_manager_X", …)`` /
  ``counter_set`` / ``observe`` literal first args
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from torchft_tpu_torch.analysis.core import Finding, Repo, Source, dotted_name
from torchft_tpu_torch.analysis.contracts import DECLARED_TIMINGS, DECLARED_SERIES

_EMIT_METHODS = {"_record_timing", "_bump_counter", "_on_metric"}
_SERIES_METHODS = {"gauge_set", "counter_set", "observe"}
_TIMINGS_DICTS = {"_timings", "out"}
# modules whose emissions land in Manager.timings() / manager /metrics
_SCOPED_MODULES = ("manager.py", "redundancy.py")
# where the port documents every declared key
COUNTERS_DOC = "README.md#counters"


def _str_arg0(call: ast.Call) -> str | None:
    if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
        call.args[0].value, str
    ):
        return call.args[0].value
    return None


def extract_emitted(src: Source) -> List[Tuple[str, int]]:
    """(key, line) pairs for every statically visible emission."""
    out: List[Tuple[str, int]] = []
    for fn in [
        n
        for n in ast.walk(src.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]:
        fn_calls_emit_with_var = False
        body_nodes = list(ast.walk(fn))
        for node in body_nodes:
            if not isinstance(node, ast.Call):
                continue
            method = dotted_name(node.func).rsplit(".", 1)[-1]
            if method in _EMIT_METHODS:
                key = _str_arg0(node)
                if key is not None:
                    out.append((key, node.lineno))
                elif node.args:
                    fn_calls_emit_with_var = True
        # a counter map: dict literal string values in a function that
        # also feeds a variable into an emit method
        if fn_calls_emit_with_var:
            for node in body_nodes:
                if isinstance(node, ast.Dict):
                    for v in node.values:
                        if isinstance(v, ast.Constant) and isinstance(
                            v.value, str
                        ):
                            out.append((v.value, v.lineno))
    for node in ast.walk(src.tree):
        # self._timings["k"] = … / out["k"] = …
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Store
        ):
            base = dotted_name(node.value).rsplit(".", 1)[-1]
            if base in _TIMINGS_DICTS:
                key = node.slice
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    out.append((key.value, node.lineno))
        # for k in ("a", "b"): self._timings[k] = …
        if isinstance(node, ast.For) and isinstance(
            node.iter, (ast.Tuple, ast.List)
        ):
            elts = node.iter.elts
            if elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in elts
            ):
                stores_timings = any(
                    isinstance(n, ast.Subscript)
                    and isinstance(n.ctx, ast.Store)
                    and dotted_name(n.value).rsplit(".", 1)[-1]
                    in _TIMINGS_DICTS
                    for n in ast.walk(node)
                )
                if stores_timings:
                    out.extend((e.value, e.lineno) for e in elts)
    return out


def extract_series(src: Source) -> List[Tuple[str, int]]:
    """Literal Prometheus series names registered on the exporter."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        method = dotted_name(node.func).rsplit(".", 1)[-1]
        if method in _SERIES_METHODS:
            name = _str_arg0(node)
            if name is not None and name.startswith("torchft_manager_"):
                out.append((name, node.lineno))
    return out


def check(repo: Repo) -> List[Finding]:
    findings: List[Finding] = []
    obs_text = repo.docs.get(COUNTERS_DOC, "")
    emitted: Dict[str, Tuple[Source, int]] = {}
    series: Dict[str, Tuple[Source, int]] = {}
    for src in repo.sources:
        if src.path.name not in _SCOPED_MODULES:
            continue
        for key, line in extract_emitted(src):
            emitted.setdefault(key, (src, line))
        for name, line in extract_series(src):
            series.setdefault(name, (src, line))

    for key, (src, line) in sorted(emitted.items()):
        if key not in DECLARED_TIMINGS:
            findings.append(
                Finding(
                    checker="counter-contract",
                    rule="undeclared-counter",
                    path=src.rel,
                    line=line,
                    key=key,
                    message=(
                        f"timings key {key!r} is emitted here but not "
                        "declared in torchft_tpu_torch/analysis/contracts.py"
                    ),
                )
            )
        elif obs_text and key not in obs_text:
            findings.append(
                Finding(
                    checker="counter-contract",
                    rule="undocumented-counter",
                    path=src.rel,
                    line=line,
                    key=key,
                    message=(
                        f"timings key {key!r} is emitted but never "
                        f"mentioned in {COUNTERS_DOC}"
                    ),
                )
            )
    for name, (src, line) in sorted(series.items()):
        if name not in DECLARED_SERIES:
            findings.append(
                Finding(
                    checker="counter-contract",
                    rule="undeclared-series",
                    path=src.rel,
                    line=line,
                    key=name,
                    message=(
                        f"/metrics series {name!r} is registered here but "
                        "not declared in torchft_tpu_torch/analysis/contracts.py"
                    ),
                )
            )
        elif obs_text and name not in obs_text:
            findings.append(
                Finding(
                    checker="counter-contract",
                    rule="undocumented-series",
                    path=src.rel,
                    line=line,
                    key=name,
                    message=(
                        f"/metrics series {name!r} is not documented in "
                        f"{COUNTERS_DOC}"
                    ),
                )
            )

    # drift in the other direction: declared keys that no longer exist
    # anywhere in the scoped sources (substring scan so keys built by
    # helpers — the pipeline-stats dict, f-strings — stay alive)
    scoped_text = "".join(
        src.text
        for src in repo.sources
        if src.path.name in _SCOPED_MODULES
    )
    contracts_rel = "torchft_tpu_torch/analysis/contracts.py"
    for key in sorted(DECLARED_TIMINGS):
        if f'"{key}"' not in scoped_text and f"'{key}'" not in scoped_text:
            findings.append(
                Finding(
                    checker="counter-contract",
                    rule="dead-declaration",
                    path=contracts_rel,
                    line=1,
                    key=key,
                    message=(
                        f"declared timings key {key!r} no longer appears "
                        "in manager.py/redundancy.py — emission was removed "
                        "without updating the contract"
                    ),
                )
            )
    for name in sorted(DECLARED_SERIES):
        if f'"{name}"' not in scoped_text:
            findings.append(
                Finding(
                    checker="counter-contract",
                    rule="dead-declaration",
                    path=contracts_rel,
                    line=1,
                    key=name,
                    message=(
                        f"declared series {name!r} no longer appears in "
                        "the scoped sources"
                    ),
                )
            )
    return findings
