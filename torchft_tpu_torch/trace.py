"""The tracing plane's command line (counterpart of
``torchft_tpu/trace.py``).

Merge replicas' span dumps (``SpanRecorder.dump``, ``Manager.dump_trace``,
or the trainer's ``--trace-dir``) into one skew-corrected Chrome trace, to
open in Perfetto or chrome://tracing (a process row a replica, labelled
with its clock skew against the lighthouse; a thread row a span category;
every stamp on the lighthouse's clock)::

    python -m torchft_tpu_torch.trace merge fleet.json dump_r0.json dump_r1.json ...

Fold a lighthouse's recorded history (``--history``; plain or gzipped
JSONL) into its summary::

    python -m torchft_tpu_torch.trace history lighthouse_history.jsonl
"""

from __future__ import annotations

import json
import sys
from typing import List

from torchft_tpu_torch.tracing import history_fold, load_history, merge_traces

__all__ = ["main"]


def _usage() -> int:
    sys.stderr.write(
        "usage: python -m torchft_tpu_torch.trace merge OUT.json DUMP.json [DUMP.json ...]\n"
        "       python -m torchft_tpu_torch.trace history HISTORY.jsonl\n"
    )
    return 2


def main(argv: List[str]) -> int:
    if not argv:
        return _usage()
    cmd, args = argv[0], argv[1:]
    if cmd == "merge":
        if len(args) < 2:
            return _usage()
        out_path, dump_paths = args[0], args[1:]
        dumps = []
        for p in dump_paths:
            with open(p) as f:
                dumps.append(json.load(f))
        with open(out_path, "w") as f:
            json.dump(merge_traces(dumps), f)
        n_spans = sum(len(d.get("spans", [])) for d in dumps)
        print(f"merged {len(dumps)} replica dumps / {n_spans} spans -> {out_path}")
        return 0
    if cmd == "history":
        if len(args) != 1:
            return _usage()
        print(json.dumps(history_fold(load_history(args[0])), indent=2, sort_keys=True))
        return 0
    return _usage()


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
