"""fleetlint: repo-native static invariant analysis for the port.

Counterpart of ``torchft_tpu/analysis``.
``python -m torchft_tpu_torch.analysis [--ci] [--baseline PATH]`` runs five
AST-based checkers over the whole of ``torchft_tpu_torch/``:

- **env-contract** — every ``TORCHFT_*`` env read must be registered in
  the central knob registry (``torchft_tpu_torch/knobs.py``), named in
  the README's knob table (``README.md#knobs``), and doctor-covered;
  registered-but-unread knobs are dead.
- **counter-contract** — every key emitted into ``Manager.timings()`` /
  the manager ``/metrics`` exporter must be declared in
  ``analysis/contracts.py`` and documented in the README's
  ``### Counters`` (``README.md#counters``).
- **lock-discipline** — attributes written inside a thread target and
  accessed from other methods must be lock-guarded everywhere or listed
  in the class's ``_atomic_attrs`` allowlist.
- **blocking-calls** — socket/HTTP calls in commit-path modules must ride
  ``retry_call`` or carry an explicit timeout.
- **stale-guard** — handlers consuming ``(epoch, seq)``-stamped messages
  must compare monotonicity before applying state.

Findings are compared against a committed baseline
(``analysis/baseline.json``): accepted findings are explicit, each with a
written justification (an entry without one fails the run), and new code
is held to zero new findings. The runtime companion,
``analysis/lockgraph.py``, instruments ``threading.Lock``/``RLock`` in
test mode and fails on acquisition-order cycles.

See the README's ``### fleetlint``.
"""

from torchft_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    load_baseline,
    run_all,
)
from torchft_tpu_torch.analysis import lockgraph  # noqa: F401

CHECKER_NAMES = (
    "env-contract",
    "counter-contract",
    "lock-discipline",
    "blocking-calls",
    "stale-guard",
)
