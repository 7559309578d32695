"""Retry policy: jittered exponential backoff under a deadline budget.

Counterpart of ``torchft_tpu/retry.py`` (``RetryPolicy`` ``:59``,
``from_env`` ``:114``, ``retry_call`` ``:143``), copied so the port
imports nothing of the JAX package. The control plane's RPCs
(``coordination._RawClient``), the HTTP heal's same-source chunk retries
(``checkpointing/http_transport.py``) and the compressed ring's re-route
loop (``process_group._ring_allreduce_compressed``) run under it.

- ``RetryPolicy``: attempts, base backoff, backoff ceiling and jitter
  fraction, resolvable from the ``TORCHFT_RETRY_*`` environment variables
  (env > argument > default);
- ``retry_call(fn, ...)``: run ``fn`` under the policy within a wall-clock
  budget; ``fn`` receives the remaining budget as its timeout;
- ``max_attempts <= 1`` keeps exact single-attempt semantics: one call, no
  sleep, the original exception.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type

from torchft_tpu_torch import knobs

RETRY_MAX_ATTEMPTS_ENV = "TORCHFT_RETRY_MAX_ATTEMPTS"
RETRY_BASE_S_ENV = "TORCHFT_RETRY_BASE_S"
RETRY_MAX_BACKOFF_S_ENV = "TORCHFT_RETRY_MAX_BACKOFF_S"
RETRY_JITTER_ENV = "TORCHFT_RETRY_JITTER"

_DEFAULT_MAX_ATTEMPTS = 3
_DEFAULT_BASE_S = 0.05
_DEFAULT_MAX_BACKOFF_S = 1.0
_DEFAULT_JITTER = 0.5


class RetryBudgetExhausted(TimeoutError):
    """Deadline budget ran out before an attempt succeeded.

    Carries ``last_exception`` (the failure of the final attempt) and
    ``attempts`` for observability; subclasses TimeoutError so existing
    timeout handling paths treat it like the deadline expiry it is.
    """

    def __init__(
        self, message: str, attempts: int, last_exception: Optional[BaseException]
    ) -> None:
        super().__init__(message)
        self.attempts = attempts
        self.last_exception = last_exception


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff under a deadline budget.

    ``max_attempts``: total attempts (1 = no retry). ``base_s``: backoff
    before the 2nd attempt; doubles each retry up to ``max_backoff_s``.
    ``jitter``: fraction of the backoff drawn uniformly at random and
    *subtracted*, i.e. sleep in ``[backoff*(1-jitter), backoff]`` — jitter
    only ever shortens the wait, so ``max_backoff_s`` stays a hard ceiling
    and a fleet of retriers decorrelates without stretching deadlines.
    """

    max_attempts: int = _DEFAULT_MAX_ATTEMPTS
    base_s: float = _DEFAULT_BASE_S
    max_backoff_s: float = _DEFAULT_MAX_BACKOFF_S
    jitter: float = _DEFAULT_JITTER

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff durations must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    @property
    def enabled(self) -> bool:
        return self.max_attempts > 1

    def backoff_s(
        self,
        attempt: int,
        rng: Optional[random.Random] = None,
        full: bool = False,
    ) -> float:
        """Sleep before attempt ``attempt`` (attempts are 1-based; the first
        retry — attempt 2 — backs off ``~base_s``).

        ``full=True`` switches to FULL jitter — uniform in ``[0, ceiling]``
        (AWS-style) instead of the bounded ``[ceiling*(1-jitter), ceiling]``
        band. Used for reconnect-after-connection-loss: when a restarted
        server drops every client at the same instant, their retry clocks
        are perfectly synchronized, and the bounded band (at the default
        jitter=0.5 it never sleeps below half the ceiling) re-packs the
        herd into the top half of every backoff window. Full jitter spreads
        reconnects across the whole window, so the server sees a trickle
        instead of a stampede."""
        if attempt <= 1:
            return 0.0
        ceiling = min(self.base_s * (2.0 ** (attempt - 2)), self.max_backoff_s)
        draw = (rng or random).random()
        if full:
            return ceiling * draw
        return ceiling * (1.0 - self.jitter * draw)

    @classmethod
    def from_env(
        cls,
        max_attempts: Optional[int] = None,
        base_s: Optional[float] = None,
        max_backoff_s: Optional[float] = None,
        jitter: Optional[float] = None,
    ) -> "RetryPolicy":
        """Resolve env > explicit argument > default, matching the repo's
        other ``TORCHFT_*`` knobs (env wins so operators can tune a deployed
        binary without code changes)."""

        def _pick(env: str, arg: Any, default: Any, cast: Callable[[str], Any]) -> Any:
            raw = knobs.env_raw(env)
            if raw is not None and raw != "":
                return cast(raw)
            return default if arg is None else arg

        return cls(
            max_attempts=_pick(
                RETRY_MAX_ATTEMPTS_ENV, max_attempts, _DEFAULT_MAX_ATTEMPTS, int
            ),
            base_s=_pick(RETRY_BASE_S_ENV, base_s, _DEFAULT_BASE_S, float),
            max_backoff_s=_pick(
                RETRY_MAX_BACKOFF_S_ENV, max_backoff_s, _DEFAULT_MAX_BACKOFF_S, float
            ),
            jitter=_pick(RETRY_JITTER_ENV, jitter, _DEFAULT_JITTER, float),
        )


def retry_call(
    fn: Callable[[float], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    timeout: float,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    full_jitter_on: Tuple[Type[BaseException], ...] = (),
    on_attempt: Optional[Callable[[int, Optional[BaseException]], None]] = None,
    rng: Optional[random.Random] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call ``fn(remaining_budget_s)`` under ``policy`` within ``timeout``.

    ``timeout`` is a hard wall-clock budget across ALL attempts and backoffs;
    each attempt receives the remaining budget so the caller's deadline is
    never overshot. ``on_attempt(attempt, prior_exception)`` fires before
    every attempt (prior_exception is None on the first), letting callers
    count retries without owning the loop. Non-``retryable`` exceptions
    propagate immediately. ``full_jitter_on`` selects exception classes
    whose retries back off with FULL jitter (uniform ``[0, ceiling]``) —
    connection-loss classes, where a server restart synchronizes every
    client's retry clock and the default bounded jitter would re-pack the
    reconnect herd (see :meth:`RetryPolicy.backoff_s`). When the budget or
    attempts run out, :class:`RetryBudgetExhausted` is raised from the last
    failure — except in the single-attempt case, where the original
    exception propagates unchanged (zero-retry config must be bit-compatible
    with no retry layer at all).
    """
    if policy is None:
        policy = RetryPolicy.from_env()
    deadline = clock() + timeout
    last_exc: Optional[BaseException] = None
    attempt = 0
    while attempt < policy.max_attempts:
        attempt += 1
        if attempt > 1:
            full = bool(full_jitter_on) and isinstance(last_exc, full_jitter_on)
            pause = policy.backoff_s(attempt, rng, full=full)
            remaining = deadline - clock()
            if remaining <= 0:
                break
            if pause > 0:
                sleep(min(pause, remaining))
        remaining = deadline - clock()
        if remaining <= 0 and attempt > 1:
            break
        if on_attempt is not None:
            on_attempt(attempt, last_exc)
        try:
            # First attempt always gets the full budget even if the hook ate
            # a moment; later attempts get whatever is genuinely left.
            return fn(max(remaining, 0.001) if attempt > 1 else timeout)
        except retryable as e:  # noqa: PERF203 - retry loop by design
            last_exc = e
            if policy.max_attempts == 1:
                raise
            continue
    assert last_exc is not None
    if policy.max_attempts == 1:
        raise last_exc
    raise RetryBudgetExhausted(
        f"retry budget exhausted after {attempt} attempt(s) "
        f"within {timeout:.3f}s: {last_exc!r}",
        attempts=attempt,
        last_exception=last_exc,
    ) from last_exc
