"""Environment knobs: the port's copy of the reference's typed readers
(``torchft_tpu/knobs.py:334-346``). An unset or empty variable gives the
default; a boolean is false for "0", "false", "no" or "off" (any case) and
true for any other value. The reference's knob registry and its policy
overrides are not ported."""

from __future__ import annotations

import os

__all__ = ["env_bool", "env_int"]


def env_int(name: str, default: int = 0) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return int(raw)


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")
