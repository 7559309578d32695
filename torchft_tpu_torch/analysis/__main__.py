"""fleetlint CLI: ``python -m torchft_tpu_torch.analysis [--ci] [--baseline P]``.

Counterpart of ``python -m torchft_tpu.analysis``, with the same flags, exit
codes and summary line. One rule is the port's own: a baseline entry whose
justification is empty fails the run (``--update`` writes new entries
with an empty one, to be filled in by hand).

Modes:

- default: print every finding (including baselined ones, marked) and a
  summary; exit 0 unless there are findings absent from the baseline.
- ``--ci``: same gate, terse output — meant for the workflow step and
  pre-commit hooks. Stale baseline entries (accepted findings that no
  longer fire) are warnings in both modes so the baseline shrinks over
  time instead of fossilizing.
- ``--update``: rewrite the baseline to the current findings, keeping
  existing justifications for fingerprints that survive.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from torchft_tpu_torch.analysis import CHECKER_NAMES
from torchft_tpu_torch.analysis.core import (
    DEFAULT_BASELINE,
    diff_baseline,
    load_baseline,
    run_all,
    save_baseline,
    unjustified,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.analysis",
        description="fleetlint: repo-native invariant analyzer",
    )
    parser.add_argument(
        "--ci",
        action="store_true",
        help="terse output; exit nonzero on findings beyond the baseline",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=DEFAULT_BASELINE,
        help=f"baseline file (default: {DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--update",
        action="store_true",
        help="rewrite the baseline to the current findings",
    )
    parser.add_argument(
        "--checker",
        action="append",
        choices=CHECKER_NAMES,
        help="run only the named checker (repeatable; default: all)",
    )
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    findings = run_all(checkers=args.checker)
    elapsed = time.monotonic() - t0
    baseline = load_baseline(args.baseline)
    new, stale = diff_baseline(findings, baseline)

    if args.update:
        kept = {
            fp: why
            for fp, why in baseline.items()
            if fp in {f.fingerprint for f in findings}
        }
        path = save_baseline(findings, args.baseline, justifications=kept)
        print(
            f"fleetlint: baseline rewritten with {len(findings)} "
            f"finding(s) -> {path}"
        )
        for fp in unjustified(load_baseline(path)):
            print(f"fleetlint: write a justification for {fp}")
        return 0

    if not args.ci:
        for f in findings:
            mark = "" if f.fingerprint not in baseline else " [baselined]"
            print(f.render() + mark)
    else:
        for f in new:
            print(f.render())
    for fp in stale:
        print(
            f"fleetlint: WARNING stale baseline entry (no longer fires): "
            f"{fp}"
        )
    bare = unjustified(baseline)
    for fp in bare:
        print(f"fleetlint: baseline entry without a justification: {fp}")
    print(
        f"fleetlint: {len(findings)} finding(s), {len(new)} new, "
        f"{len(baseline)} baselined ({len(stale)} stale) "
        f"[{len(args.checker or CHECKER_NAMES)} checkers, "
        f"{elapsed:.2f}s]"
    )
    if new or bare:
        print(
            "fleetlint: FAIL — fix the findings above or (for accepted "
            "pre-existing debt) add them to the baseline via --update "
            "and write each one's justification",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
