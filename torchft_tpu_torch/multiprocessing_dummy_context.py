"""A thread-backed stand-in for a ``multiprocessing`` context.

Counterpart of ``torchft_tpu/multiprocessing_dummy_context.py``: the part of
the context API that ``process_group.ProcessGroupBaby`` uses (``Process``
and ``Pipe``), backed by a thread and in-process queues. A Baby process
group made with ``DummyContext()`` runs its "child" in a thread of the
caller's process: no spawn, no pickling, fast tests; the ``spawn``
context is what isolates the process group for real.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional, Tuple

__all__ = ["DummyContext", "dummy_context"]

_CLOSED = object()


class _DummyConnection:
    """One end of an in-process duplex pipe (the ``Connection`` calls the
    Baby process group makes)."""

    def __init__(self, rx: "queue.Queue[Any]", tx: "queue.Queue[Any]") -> None:
        self._rx = rx
        self._tx = tx
        self.closed = False

    def send(self, obj: Any) -> None:
        if self.closed:
            raise OSError("handle is closed")
        self._tx.put(obj)

    def recv(self) -> Any:
        item = self._rx.get()
        if item is _CLOSED:
            self.closed = True
            raise EOFError("pipe closed")
        return item

    def poll(self, timeout: Optional[float] = None) -> bool:
        # as Connection.poll: None blocks until something arrives, 0 probes
        try:
            if timeout is None:
                item = self._rx.get()
            else:
                item = self._rx.get(block=timeout > 0, timeout=timeout or None)
        except queue.Empty:
            return False
        # a peek: the item goes back in front for the recv that follows
        self._rx.queue.appendleft(item)  # type: ignore[attr-defined]
        return True

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._tx.put(_CLOSED)


def _pipe(duplex: bool = True) -> Tuple[_DummyConnection, _DummyConnection]:
    a2b: "queue.Queue[Any]" = queue.Queue()
    b2a: "queue.Queue[Any]" = queue.Queue()
    return _DummyConnection(b2a, a2b), _DummyConnection(a2b, b2a)


class _DummyProcess:
    """A ``threading.Thread`` with the calls of ``multiprocessing.Process``
    that the Baby process group makes."""

    def __init__(
        self,
        target: Callable[..., None],
        args: Tuple[Any, ...] = (),
        daemon: bool = True,
        name: Optional[str] = None,
    ) -> None:
        self._target = target
        self._args = args
        self.daemon = daemon
        self.exitcode: Optional[int] = None
        self._thread = threading.Thread(target=self._run, daemon=daemon,
                                        name=name or "baby_dummy")
        self.pid: Optional[int] = None

    def _run(self) -> None:
        try:
            self._target(*self._args)
            self.exitcode = 0
        except SystemExit as e:
            self.exitcode = int(e.code or 0)
        except BaseException:  # noqa: BLE001 - a child's death, as a process's
            self.exitcode = 1
        finally:
            # as a real child's exit closes its ends of the pipes: the
            # parent's recv sees EOFError
            for a in self._args:
                if isinstance(a, _DummyConnection):
                    a.close()

    def start(self) -> None:
        self._thread.start()
        self.pid = self._thread.ident

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    # a thread cannot be killed: the Baby process group closes the pipes,
    # which ends the worker's loop, and reaches the inner process group's
    # abort through its abort cell
    def terminate(self) -> None:
        pass

    def kill(self) -> None:
        pass


class DummyContext:
    """Thread-backed stand-in for ``multiprocessing.get_context("spawn")``."""

    def Process(self, *args: Any, **kwargs: Any) -> _DummyProcess:
        return _DummyProcess(*args, **kwargs)

    def Pipe(self, duplex: bool = True) -> Tuple[_DummyConnection, _DummyConnection]:
        return _pipe(duplex)


def dummy_context() -> DummyContext:
    return DummyContext()
