"""Runtime lock-order race detector (test mode).

Counterpart of ``torchft_tpu/analysis/lockgraph.py``; a creation site reads
from ``torchft_tpu_torch/`` or ``tests/`` on.

:func:`watch` monkeypatches ``threading.Lock`` / ``threading.RLock`` so
every lock created inside the block is instrumented: each acquisition
records a directed edge from every lock the acquiring thread already
holds to the one being acquired, keyed by the locks' **creation sites**
(``file:line`` of the ``Lock()`` call). A cycle in that graph is a
lock-order inversion — two threads that interleave the other way
deadlock — reported by :meth:`LockGraph.cycles` without needing the
unlucky schedule to actually happen. Hold times are tracked per site so
tests can also flag a lock pinned across a slow call on the hot path.

Wired into the port's serving and redundancy tests and around phase 20
of ``chip_smoke.py`` (two bench_1b replica threads, the fp8 ring's
workers, the lighthouse's policy pass, a crash and an HTTP heal on the
card), each with a zero-cycle assertion; enable it in a harness via::

    with lockgraph.watch() as graph:
        ...  # exercise the planes
    lockgraph.assert_clean(graph)

Locks created *before* ``watch()`` ran are untouched — instrumentation is
opt-in per block, never a production overhead.

Granularity caveat: the graph is keyed by creation site, so two locks
born at the same ``file:line`` (a lock-per-shard list comprehension, two
``Lock()`` calls on one line) collapse into one node and nesting them is
NOT reported — the same class-granularity tradeoff kernel lockdep makes,
which keeps consistently-ordered per-instance lock arrays from flagging
as false positives. Give each distinctly-ordered lock its own line.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Set, Tuple


def _creation_site(depth: int = 1) -> str:
    import sys

    frame = sys._getframe(depth)
    # walk out of this module so the site names the caller's code
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    fname = frame.f_code.co_filename
    for marker in ("torchft_tpu_torch", "tests"):
        idx = fname.find(marker)
        if idx != -1:
            fname = fname[idx:]
            break
    return f"{fname}:{frame.f_lineno}"


class LockGraph:
    """Global acquisition-order graph over instrumented locks."""

    def __init__(self, hold_warn_ms: float = 200.0) -> None:
        self.hold_warn_ms = hold_warn_ms
        self._mu = threading.Lock()  # a REAL lock, never instrumented
        # edge: held-site -> acquired-site, with one example thread name
        self._edges: Dict[Tuple[str, str], str] = {}
        self._max_hold_ms: Dict[str, float] = defaultdict(float)
        self._tls = threading.local()
        self._n_locks = 0
        self._n_acquires = 0

    # ---------------------------------------------------- bookkeeping
    def _held_stack(self) -> List[Tuple[object, str, float]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def on_created(self) -> None:
        with self._mu:
            self._n_locks += 1

    def on_acquired(self, lock: object, site: str) -> None:
        stack = self._held_stack()
        held_sites = []
        for held_lock, held_site, _ in stack:
            if held_lock is lock:  # reentrant RLock: no self-edge
                continue
            held_sites.append(held_site)
        if held_sites:
            thread = threading.current_thread().name
            with self._mu:
                for held_site in held_sites:
                    if held_site != site:
                        self._edges.setdefault((held_site, site), thread)
        with self._mu:
            self._n_acquires += 1
        stack.append((lock, site, time.perf_counter()))

    def on_released(self, lock: object, site: str) -> None:
        stack = self._held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                _, _, t0 = stack.pop(i)
                hold_ms = (time.perf_counter() - t0) * 1000.0
                with self._mu:
                    if hold_ms > self._max_hold_ms[site]:
                        self._max_hold_ms[site] = hold_ms
                return

    # -------------------------------------------------------- queries
    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> List[List[str]]:
        """Cycles in the site-level acquisition-order graph (each as the
        ordered list of sites; a two-element cycle is the classic
        A→B / B→A inversion)."""
        adj: Dict[str, Set[str]] = defaultdict(set)
        for (a, b) in self.edges():
            adj[a].add(b)
        cycles: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = defaultdict(int)
        path: List[str] = []

        def dfs(node: str) -> None:
            color[node] = GRAY
            path.append(node)
            for nxt in sorted(adj.get(node, ())):
                if color[nxt] == GRAY:
                    cycle = path[path.index(nxt):]
                    canon = tuple(sorted(cycle))
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        cycles.append(list(cycle))
                elif color[nxt] == WHITE:
                    dfs(nxt)
            path.pop()
            color[node] = BLACK

        for node in sorted(adj):
            if color[node] == WHITE:
                dfs(node)
        return cycles

    def hold_violations(
        self, threshold_ms: Optional[float] = None
    ) -> Dict[str, float]:
        limit = self.hold_warn_ms if threshold_ms is None else threshold_ms
        with self._mu:
            return {
                site: ms
                for site, ms in self._max_hold_ms.items()
                if ms > limit
            }

    def report(self) -> Dict[str, object]:
        with self._mu:
            max_holds = dict(self._max_hold_ms)
            n_locks, n_acq, n_edges = (
                self._n_locks, self._n_acquires, len(self._edges)
            )
        return {
            "locks": n_locks,
            "acquires": n_acq,
            "edges": n_edges,
            "cycles": self.cycles(),
            "max_hold_ms": max_holds,
        }


class _InstrumentedLock:
    """Wraps a real Lock/RLock; reports acquire/release to the graph and
    speaks enough of the protocol (including the private Condition hooks)
    to be substitutable anywhere the stdlib types are."""

    def __init__(self, inner: object, graph: LockGraph, site: str) -> None:
        self._inner = inner
        self._graph = graph
        self._site = site
        graph.on_created()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.on_acquired(self, self._site)
        return got

    def release(self) -> None:
        self._graph.on_released(self, self._site)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    # threading.Condition private protocol (waits release the lock
    # without calling release(), so bookkeeping must follow)
    def _release_save(self) -> object:
        self._graph.on_released(self, self._site)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state: object) -> None:
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        self._graph.on_acquired(self, self._site)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _at_fork_reinit(self) -> None:
        # a module first imported inside a watch may register a lock's
        # reinit with os.register_at_fork (concurrent.futures.thread does)
        self._inner._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<lockgraph wrapper {self._site} of {self._inner!r}>"


_install_mu = threading.Lock()


@contextmanager
def watch(hold_warn_ms: float = 200.0) -> Iterator[LockGraph]:
    """Instrument every ``threading.Lock``/``RLock`` created inside the
    block and yield the shared :class:`LockGraph`. Nested/concurrent
    watches are refused (the patch is process-global)."""
    graph = LockGraph(hold_warn_ms=hold_warn_ms)
    real_lock = threading.Lock
    real_rlock = threading.RLock
    if not _install_mu.acquire(blocking=False):
        raise RuntimeError("lockgraph.watch() is already active")

    def make_lock() -> _InstrumentedLock:
        return _InstrumentedLock(real_lock(), graph, _creation_site())

    def make_rlock() -> _InstrumentedLock:
        return _InstrumentedLock(real_rlock(), graph, _creation_site())

    threading.Lock = make_lock  # type: ignore[misc]
    threading.RLock = make_rlock  # type: ignore[misc]
    try:
        yield graph
    finally:
        threading.Lock = real_lock  # type: ignore[misc]
        threading.RLock = real_rlock  # type: ignore[misc]
        _install_mu.release()


def assert_clean(
    graph: LockGraph, max_hold_ms: Optional[float] = None
) -> None:
    """Fail on any acquisition-order cycle; optionally also on hot-path
    hold times above ``max_hold_ms`` (left off by default so loaded CI
    hosts don't flake integration tests on wall-clock)."""
    cycles = graph.cycles()
    assert not cycles, (
        f"lock-order cycles detected (A→B / B→A inversions): {cycles}; "
        f"edges={sorted(graph.edges())}"
    )
    if max_hold_ms is not None:
        slow = graph.hold_violations(max_hold_ms)
        assert not slow, (
            f"locks held >{max_hold_ms}ms on the hot path: {slow}"
        )
