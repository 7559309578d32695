"""Timed readers-writer lock.

A copy of ``torchft_tpu/checkpointing/_rwlock.py``: guards live-checkpoint
state reads against concurrent optimizer mutation. Read-preferring:
overlapping and nested read acquisitions succeed even while a writer waits
(checkpoint serving holds the read lock while state-dict callbacks re-enter
it).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Generator

__all__ = ["RWLock"]


class RWLock:
    def __init__(self, timeout: float = -1) -> None:
        """``timeout``: default acquire timeout in seconds (-1 = forever)."""
        self._timeout = timeout
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    # -- read side --------------------------------------------------------
    def r_acquire(self, timeout: float | None = None) -> bool:
        timeout = self._timeout if timeout is None else timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._writer,
                timeout=None if timeout < 0 else timeout,
            )
            if not ok:
                return False
            self._readers += 1
            return True

    def r_release(self) -> None:
        with self._cond:
            assert self._readers > 0, "r_release without matching r_acquire"
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    @contextmanager
    def r_lock(self, timeout: float | None = None) -> Generator[None, None, None]:
        if not self.r_acquire(timeout=timeout):
            raise TimeoutError("timed out acquiring read lock")
        try:
            yield
        finally:
            self.r_release()

    # -- write side -------------------------------------------------------
    def w_acquire(self, timeout: float | None = None) -> bool:
        timeout = self._timeout if timeout is None else timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._writer and self._readers == 0,
                timeout=None if timeout < 0 else timeout,
            )
            if not ok:
                return False
            self._writer = True
            return True

    def w_release(self) -> None:
        with self._cond:
            assert self._writer, "w_release without matching w_acquire"
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def w_lock(self, timeout: float | None = None) -> Generator[None, None, None]:
        if not self.w_acquire(timeout=timeout):
            raise TimeoutError("timed out acquiring write lock")
        try:
            yield
        finally:
            self.w_release()

    # -- introspection ----------------------------------------------------
    def r_locked(self) -> bool:
        with self._cond:
            return self._readers > 0

    def w_locked(self) -> bool:
        with self._cond:
            return self._writer
