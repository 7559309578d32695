"""Timeout engine for blocking contexts and deferred deadlines.

Counterpart of ``torchft_tpu/futures.py:214-248``: a background asyncio
loop arms timers for ``context_timeout`` (calls e.g. ``pg.abort`` when a
block overruns) and ``arm_deadline`` (a bare timer with a cancel function);
a watchdog thread hard-exits the process if the timer loop itself wedges
(``TORCHFT_WATCHDOG_TIMEOUT_SEC``). The reference's ``future_timeout`` is
``Manager.wrap_future(..., arm_timeout=True)`` in the port, on
``arm_deadline``: the device plane's allreduces take their deadline at
submission, the host plane's arm it when staging begins, as the
reference's.
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
from contextlib import contextmanager
from datetime import timedelta
from typing import Callable, Generator, Optional

from torchft_tpu_torch import knobs

WATCHDOG_TIMEOUT_SEC = float(knobs.env_raw("TORCHFT_WATCHDOG_TIMEOUT_SEC", 30.0))

__all__ = ["context_timeout", "arm_deadline"]


def _to_seconds(timeout: "float | timedelta") -> float:
    if isinstance(timeout, timedelta):
        return timeout.total_seconds()
    return float(timeout)


def _arm_on_loop(
    loop: asyncio.AbstractEventLoop, delay: float, fn: Callable[[], None]
) -> Callable[[], None]:
    """Schedule ``fn`` to run after ``delay`` on ``loop``; return a
    thread-safe cancel function.

    Lock-free by construction: the ``call_later`` handle is only ever touched
    on the loop thread. The ``dead`` flag is the synchronous kill switch —
    ``_cancel`` flips it on the caller's thread (a GIL-atomic store), and the
    fire wrapper re-checks it at invocation time, so once ``_cancel`` returns
    a not-yet-started ``fn`` can no longer run even if the loop is backed up
    and processes the deadline before the revoke. The only residual race is
    ``fn`` already mid-execution at cancel time, which no timer design can
    close from outside.
    """
    slot: "list[Optional[asyncio.TimerHandle]]" = [None]
    dead = False

    def _fire() -> None:
        if not dead:
            fn()

    def _install() -> None:
        if not dead:
            slot[0] = loop.call_later(delay, _fire)

    loop.call_soon_threadsafe(_install)

    def _cancel() -> None:
        nonlocal dead
        dead = True

        def _revoke() -> None:
            if slot[0] is not None:
                slot[0].cancel()
                slot[0] = None

        try:
            loop.call_soon_threadsafe(_revoke)
        except RuntimeError:
            pass  # loop already shut down; nothing left to fire

    return _cancel


class _TimeoutManager:
    """Singleton owning the timer event loop + watchdog."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # Per-generation shutdown signal: a restart after shutdown() creates a
        # fresh Event, so a lingering watchdog from the previous generation
        # only ever observes its own.
        self._shutdown_evt: Optional[threading.Event] = None

    def _maybe_start(self) -> asyncio.AbstractEventLoop:
        with self._lock:
            if self._loop is None:
                loop = asyncio.new_event_loop()
                thread = threading.Thread(
                    target=loop.run_forever, daemon=True, name="torchft_timeout_loop"
                )
                thread.start()
                self._loop = loop
                shutdown_evt = threading.Event()
                self._shutdown_evt = shutdown_evt
                threading.Thread(
                    target=self._watchdog_loop,
                    args=(loop, shutdown_evt),
                    daemon=True,
                    name="torchft_watchdog",
                ).start()
            return self._loop

    def _watchdog_loop(
        self, loop: asyncio.AbstractEventLoop, shutdown_evt: threading.Event
    ) -> None:
        # Periodically schedule a no-op on the event loop; if it fails to run
        # within the watchdog budget the loop is wedged (a timer callback is
        # stuck, likely inside an abort) — kill the process rather than hang
        # training forever. Matches reference torchft/futures.py:102-125.
        ticked = threading.Event()
        while not shutdown_evt.is_set():
            ticked.clear()
            try:
                loop.call_soon_threadsafe(ticked.set)
            except RuntimeError:
                return  # loop closed
            if not ticked.wait(WATCHDOG_TIMEOUT_SEC):
                if shutdown_evt.is_set():
                    return
                print(
                    "torchft_tpu_torch watchdog: timeout event loop is stuck for "
                    f"{WATCHDOG_TIMEOUT_SEC}s, exiting process",
                    file=sys.stderr,
                    flush=True,
                )
                os._exit(1)
            # Tick at half the watchdog budget; wakes immediately on shutdown.
            shutdown_evt.wait(WATCHDOG_TIMEOUT_SEC / 2)

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown_evt is not None:
                self._shutdown_evt.set()
                self._shutdown_evt = None
            if self._loop is not None:
                loop = self._loop
                self._loop = None
                loop.call_soon_threadsafe(loop.stop)

    # -- public ops -------------------------------------------------------
    def arm(self, callback: Callable[[], None], timeout: float) -> Callable[[], None]:
        return _arm_on_loop(self._maybe_start(), timeout, callback)

    def context_timeout(
        self, callback: Callable[[], None], timeout: float
    ) -> "Generator[None, None, None]":
        @contextmanager
        def _ctx() -> Generator[None, None, None]:
            cancel = self.arm(callback, timeout)
            try:
                yield
            finally:
                cancel()

        return _ctx()


_TIMEOUT_MANAGER = _TimeoutManager()


def context_timeout(
    callback: Callable[[], None], timeout: "float | timedelta"
) -> "Generator[None, None, None]":
    """Context manager calling ``callback`` if the block overruns ``timeout``.

    Used to arm abort watchdogs around blocking collectives, mirroring the
    reference's abort-based timeout recovery (torchft/process_group.py:739-763).
    """
    return _TIMEOUT_MANAGER.context_timeout(callback, _to_seconds(timeout))


def arm_deadline(
    callback: Callable[[], None], timeout: "float | timedelta"
) -> Callable[[], None]:
    """Arm ``callback`` to fire after ``timeout``; returns a cancel function.

    The bare-timer primitive behind ``context_timeout``, for ops whose
    completion signal is a future resolving rather than a ``with`` block
    exiting — cancel from the future's done-callback so the deadline covers
    the full async span, not just the dispatching frame.
    """
    return _TIMEOUT_MANAGER.arm(callback, _to_seconds(timeout))
