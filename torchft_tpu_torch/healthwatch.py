"""Healthwatch, trimmed to what the redundancy plane reads.

Counterpart of ``torchft_tpu/healthwatch.py``'s ``HealthState`` (``:226``),
``_STATE_NAMES`` (``:258``) and ``spare_eligible`` (``:292``): the shard
directory gates a hot spare's promotion on the lighthouse's health state
of that spare. The lighthouse's native health ledger (``native/
healthwatch.cc``) runs at its defaults (observe mode). The rest of the
reference module (the ledger's Python mirror, straggler scoring, the
serving drain policy and ``HealthConfig``) belongs to the healthwatch
slice, listed in ROADMAP.md.
"""

from __future__ import annotations

from enum import IntEnum

__all__ = ["HealthState", "spare_eligible"]


class HealthState(IntEnum):
    OK = 0
    WARN = 1
    EJECTED = 2
    PROBATION = 3
    # after the others: the codes 0..3 are pinned by the native ledger
    DEGRADED = 4


_STATE_NAMES = {
    "ok": HealthState.OK,
    "warn": HealthState.WARN,
    "ejected": HealthState.EJECTED,
    "probation": HealthState.PROBATION,
    "degraded": HealthState.DEGRADED,
}


def spare_eligible(state: "HealthState | int | str") -> bool:
    """True when a hot spare in ``state`` may be promoted into the quorum:
    only a clean OK (a sick spare would trade a dead member for a
    straggler). Takes the native ``/health`` state string, the enum or its
    code; a spare the ledger never saw reports "ok"; an unknown state
    string is not eligible."""
    if isinstance(state, str):
        parsed = _STATE_NAMES.get(state.strip().lower())
        if parsed is None:
            return False
        state = parsed
    try:
        state = HealthState(int(state))
    except (ValueError, TypeError):
        return False
    return state == HealthState.OK
