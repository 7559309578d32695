"""Asynchronous work handles for collectives and the managed allreduce.

Counterpart of ``torchft_tpu/work.py:30-267``: a small thread-safe
``Future`` with callback chaining, the ``Work`` handles the process
groups and the Manager return, ``join_futures`` and the streamed
allreduce's per-bucket handle ``GradStream``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")
S = TypeVar("S")

__all__ = ["Future", "Work", "DummyWork", "FutureWork", "GradStream", "join_futures"]


class Future(Generic[T]):
    """A minimal thread-safe future with callback chaining.

    The subset of ``torch.futures.Future`` the Manager relies on
    (``value``, ``wait``, ``then``, ``set_result``, ``set_exception``), with
    thread-safe callbacks and a ``then`` whose callback receives the
    completed future. A copy of ``torchft_tpu.work.Future`` so both packages
    chain results with the same semantics.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._done = False
        self._result: Optional[T] = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future[T]"], None]] = []

    # -- completion -------------------------------------------------------
    def set_result(self, result: T) -> None:
        with self._cond:
            if self._done:
                raise RuntimeError("future already completed")
            self._result = result
            self._done = True
            callbacks = list(self._callbacks)
            self._callbacks.clear()
            self._cond.notify_all()
        for cb in callbacks:
            self._invoke(cb)

    def set_exception(self, exc: BaseException) -> None:
        with self._cond:
            if self._done:
                raise RuntimeError("future already completed")
            self._exception = exc
            self._done = True
            callbacks = list(self._callbacks)
            self._callbacks.clear()
            self._cond.notify_all()
        for cb in callbacks:
            self._invoke(cb)

    def _invoke(self, cb: Callable[["Future[T]"], None]) -> None:
        try:
            cb(self)
        except Exception:  # callbacks must never break completion
            import logging

            logging.getLogger(__name__).exception("future callback failed")

    # -- inspection -------------------------------------------------------
    def done(self) -> bool:
        with self._cond:
            return self._done

    def exception(self) -> Optional[BaseException]:
        with self._cond:
            return self._exception

    def wait(self, timeout: Optional[float] = None) -> T:
        """Block until complete; raises the stored exception if any."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout=timeout):
                raise TimeoutError(f"future did not complete within {timeout}s")
            if self._exception is not None:
                raise self._exception
            return self._result  # type: ignore[return-value]

    def value(self) -> T:
        """Non-blocking result access; requires ``done()``."""
        with self._cond:
            if not self._done:
                raise RuntimeError("future is not complete")
            if self._exception is not None:
                raise self._exception
            return self._result  # type: ignore[return-value]

    # -- chaining ---------------------------------------------------------
    def add_done_callback(self, cb: Callable[["Future[T]"], None]) -> None:
        with self._cond:
            if not self._done:
                self._callbacks.append(cb)
                return
        self._invoke(cb)

    def then(self, cb: Callable[["Future[T]"], S]) -> "Future[S]":
        """Return a new future holding ``cb(self)`` once this completes.

        Unlike torch's ``then``, the callback receives the *completed* future
        (same convention as torch) and its return value resolves the chained
        future; exceptions propagate.
        """
        out: Future[S] = Future()

        def _run(fut: "Future[T]") -> None:
            try:
                out.set_result(cb(fut))
            except BaseException as e:  # noqa: BLE001 - propagate everything
                out.set_exception(e)

        self.add_done_callback(_run)
        return out

    @staticmethod
    def completed(value: T) -> "Future[T]":
        f: Future[T] = Future()
        f.set_result(value)
        return f


class Work:
    """Handle for an in-flight collective operation."""

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the op (and its future chain) completes."""
        raise NotImplementedError

    def get_future(self) -> Future[Any]:
        raise NotImplementedError

    def exception(self) -> Optional[BaseException]:
        fut = self.get_future()
        return fut.exception() if fut.done() else None

    def synchronize(self) -> None:
        """Ensure device-side effects are ordered; default is wait()."""
        self.wait()


class DummyWork(Work):
    """Pre-completed work returning a fixed result.

    Used after swallowed errors and by the dummy process group
    (reference behavior: torchft/work.py:15-26).
    """

    def __init__(self, result: Any = None) -> None:
        self._future: Future[Any] = Future.completed(result)

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._future.wait(timeout)
        return True

    def get_future(self) -> Future[Any]:
        return self._future


class FutureWork(Work):
    """Work wrapping an arbitrary Future."""

    def __init__(self, future: Future[Any]) -> None:
        self._future = future

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._future.wait(timeout)
        return True

    def get_future(self) -> Future[Any]:
        return self._future


def join_futures(futures: List[Future[Any]]) -> Future[List[Any]]:
    """One future resolving to ``[f.value() for f in futures]``.

    Fails fast: the first input exception resolves the joined future with
    that exception. An empty list resolves immediately."""
    out: Future[List[Any]] = Future()
    if not futures:
        out.set_result([])
        return out

    remaining = [len(futures)]
    lock = threading.Lock()

    def _on_done(fut: Future[Any]) -> None:
        exc = fut.exception()
        if exc is not None:
            try:
                out.set_exception(exc)
            except RuntimeError:
                pass  # a sibling already failed the join
            return
        with lock:
            remaining[0] -= 1
            last = remaining[0] == 0
        if last:
            try:
                out.set_result([f.value() for f in futures])
            except RuntimeError:
                pass

    for f in futures:
        f.add_done_callback(_on_done)
    return out


class GradStream(Work):
    """Handle of a streamed allreduce (``Manager.allreduce_streamed``).

    ``ready(i)`` says whether bucket ``i`` has reduced and landed, so a
    gradient-accumulation loop can watch buckets land while it computes;
    ``wait()`` returns the reduced pytree (zeros after a swallowed
    failure), not a bool as ``Work.wait`` does. ``get_future()`` is the
    same aggregate."""

    def __init__(self, bucket_futures: List[Future[Any]], aggregate: Future[Any]) -> None:
        self._bucket_futures = list(bucket_futures)
        self._aggregate = aggregate

    def __len__(self) -> int:
        return len(self._bucket_futures)

    @property
    def num_buckets(self) -> int:
        return len(self._bucket_futures)

    def ready(self, i: int) -> bool:
        """True once bucket ``i`` has reduced, unpacked and landed. A
        failed bucket stays False: results are reachable only through the
        aggregate, so a failed stream never leaks part of a reduction."""
        fut = self._bucket_futures[i]
        return fut.done() and fut.exception() is None

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until every bucket lands; returns the reduced pytree."""
        return self._aggregate.wait(timeout)

    def get_future(self) -> Future[Any]:
        return self._aggregate
