"""Pipe plumbing of the subprocess-isolated (Baby) process groups.

Counterpart of ``torchft_tpu/multiprocessing.py``: ``_MonitoredPipe`` wraps
a ``multiprocessing`` ``Connection`` (or the thread-backed pipe of
``multiprocessing_dummy_context``) with a receive timeout, and raises an
exception that crossed the pipe instead of returning it.
``process_group.ProcessGroupBaby`` talks to its child through two of them.

Over a real ``Connection`` an object crosses as a pickle (protocol 5) whose
large contiguous buffers (numpy arrays) go out of band: written straight
from their memory to the pipe's descriptor and read straight into fresh
memory on the other side, so a heal's leaves pay no pickling copy and no
reassembly. The pipes ask for 1 MiB of kernel buffer (the unprivileged
ceiling). An in-process pipe (``multiprocessing_dummy_context``) carries
the object itself.
"""

from __future__ import annotations

import multiprocessing.connection
import os
import pickle
import threading
from datetime import timedelta
from typing import Any, List, Optional, Union

__all__ = ["_MonitoredPipe"]

# F_SETPIPE_SZ (linux/fcntl.h); the fcntl module names it from Python 3.10
_F_SETPIPE_SZ = 1031
_PIPE_BYTES = 1 << 20


def _write_all(fd: int, view: memoryview) -> None:
    while view.nbytes:
        view = view[os.write(fd, view):]


def _read_into(fd: int, view: memoryview) -> None:
    while view.nbytes:
        n = os.readv(fd, [view])
        if n == 0:
            raise EOFError("pipe closed mid-message")
        view = view[n:]


class _MonitoredPipe:
    """A ``Connection`` (send / recv / poll / close) with a receive timeout
    and exceptions passed through. Sends are serialized by a lock."""

    def __init__(self, conn: Any) -> None:
        self._conn = conn
        self._lock = threading.Lock()
        # a real pipe's descriptor: out-of-band buffers ride it raw
        self._fd: Optional[int] = (
            conn.fileno() if isinstance(conn, multiprocessing.connection.Connection) else None)
        if self._fd is not None:
            try:
                import fcntl

                fcntl.fcntl(self._fd, _F_SETPIPE_SZ, _PIPE_BYTES)
            except (ImportError, OSError):
                pass  # the default 64 KiB: slower, same bytes

    def send(self, obj: object) -> None:
        with self._lock:
            if self._fd is None:
                self._conn.send(obj)
                return
            buffers: List[pickle.PickleBuffer] = []
            head = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
            views = [b.raw() for b in buffers]
            self._conn.send_bytes(pickle.dumps(([v.nbytes for v in views], head)))
            for v in views:
                _write_all(self._fd, v)

    def _recv_obj(self) -> object:
        if self._fd is None:
            return self._conn.recv()
        sizes, head = pickle.loads(self._conn.recv_bytes())
        buffers = []
        for n in sizes:
            buf = bytearray(n)
            _read_into(self._fd, memoryview(buf))
            buffers.append(buf)
        return pickle.loads(head, buffers=buffers)

    def recv(self, timeout: Union[float, timedelta, None]) -> object:
        """One object; ``TimeoutError`` if none arrives within ``timeout``
        seconds (None: wait), and an ``Exception`` instance received is
        raised. One thread receives from a pipe at a time."""
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        if not self._conn.poll(timeout):
            raise TimeoutError(f"pipe recv timed out after {timeout}s")
        item = self._recv_obj()
        if isinstance(item, Exception):
            raise item
        return item

    def poll(self, timeout: Optional[float] = None) -> bool:
        return self._conn.poll(timeout)

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass

    def closed(self) -> bool:
        return getattr(self._conn, "closed", False)
