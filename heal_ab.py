"""Time bench_1b's per-step DDP run with a crash and a PGTransport heal on two
checkouts of the port on one card, in turns.

    python3 heal_ab.py --trees OLD NEW [--out FILE]

OLD and NEW are directories that hold a ``torchft_tpu_torch`` package and
the ``native/`` sources it builds its control plane from (a checkout of this
repository, or ``git archive <commit> torchft_tpu_torch native`` unpacked).
One process runs per turn, in the order OLD, NEW, NEW, OLD, so that a drift
of the card's clocks or of the host's load over the call falls on both. Each
process puts its tree first on ``sys.path`` and runs the tree's own
``run_replicas`` as ``chip_smoke.py``'s PG-heal phase does: bench_1b at full
width and depth, two replica threads, batch 1, seq 2048, fp8 allreduce, 5
steps, replica 1 crashing at step 2 and healing its 6.45 GB of parameters
and AdamW state over PGTransport. It reports:

- the heal: ``heal_send_s`` (replica 0), ``heal_recv_s``, ``heal_chunks``
  and ``heal_mb_per_s`` (replica 1), from each Manager's ``timings()``;
- ``step_ms``: the median of the steady steps (committed, 2 participants,
  no heal, past step 0) by the trainer's own clock, with its split into
  quorum + forward + backward and the allreduce;
- the run's seconds and peak device memory.

Each turn prints one JSON line; the last line holds, per tree, the median of
its turns and every turn's heal seconds. Needs one CUDA card (``--device
cpu --config debug --seq-len 16`` runs the same turns on the CPU, for a
check of the script); exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER = ("old", "new", "new", "old")
STEADY = ("step_ms", "compute_ms", "allreduce_ms")


def measure(tree: str, config: str, seq_len: int, device_name: str) -> dict:
    """One turn's numbers for the port in ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torchft_tpu_torch.train import TrainConfig, run_replicas

    device = torch.device(device_name)
    cfg = TrainConfig(config=config, steps=5, batch_size=1, seq_len=seq_len, quantize=True,
                      fail_at=2, transport="pg")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = run_replicas(cfg, device)
    seconds = time.perf_counter() - t0
    if results[1]["restarts"] != 1 or results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"replica 1 did not crash and heal: {results[1]['metrics']}")
    sent, got = results[0]["timings"], results[1]["timings"]
    steady = [e for r in results for e in r["log"]
              if e["committed"] and e["participants"] == 2 and not e["healed"] and e["step"] > 0]
    return {
        "train_py": os.path.relpath(sys.modules["torchft_tpu_torch.train"].__file__, HERE),
        "heal_send_s": sent["heal_send_s"],
        "heal_recv_s": got["heal_recv_s"],
        "heal_chunks": got["heal_chunks"],
        "heal_mb_per_s": got["heal_mb_per_s"],
        "steady_steps": len(steady),
        **{k: statistics.median(e[k] for e in steady) if steady else float("nan")
           for k in STEADY},
        "seconds": seconds,
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
                     else float("nan")),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--config", default="bench_1b")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--measure", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write every turn and the summary here as JSON")
    a = ap.parse_args()
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("heal_ab: CUDA is not available", file=sys.stderr)
        return 2
    if a.measure:
        print(json.dumps(measure(a.measure, a.config, a.seq_len, a.device)), flush=True)
        return 0
    if not a.trees:
        ap.error("--trees OLD NEW is required")
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"
    print(f"gpu: {smi}; config {a.config}, seq {a.seq_len}", flush=True)
    trees = dict(zip(("old", "new"), a.trees))
    turns = []
    for label in ORDER:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", trees[label],
                            "--config", a.config, "--seq-len", str(a.seq_len),
                            "--device", a.device], capture_output=True, text=True, timeout=600)
        sys.stderr.write(r.stderr[-4000:])
        if r.returncode != 0:
            raise RuntimeError(f"turn {label} ({trees[label]}) failed with exit code {r.returncode}")
        turn = {"tree": label, "path": trees[label], **json.loads(r.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)

    summary = {"gpu": smi}
    for label in ("old", "new"):
        rows = [t for t in turns if t["tree"] == label]
        summary[label] = {
            **{k: statistics.median(t[k] for t in rows)
               for k in ("heal_send_s", "heal_recv_s", "heal_mb_per_s", *STEADY, "peak_gib")},
            "heal_recv_s_turns": [t["heal_recv_s"] for t in rows],
            "step_ms_turns": [t["step_ms"] for t in rows],
        }
    summary["new_over_old_heal_recv_s"] = summary["new"]["heal_recv_s"] / summary["old"]["heal_recv_s"]
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
