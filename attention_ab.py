"""Time the attention kernels of two checkouts of the port on one card, in turns.

    python3 attention_ab.py --trees OLD NEW [--out FILE]

OLD and NEW are directories that hold a ``torchft_tpu_torch`` package (a
checkout of this repository, or ``git archive <commit> torchft_tpu_torch``
unpacked). One process runs per turn, in the order OLD, NEW, NEW, OLD, so
that a drift of the card's clocks over the call falls on both. Each process
puts its tree first on ``sys.path``, builds that tree's ``attention.cu`` and
measures, at the bench_1b attention shape (B 1, S 2048, Hq 16, Hkv 8, hd 128,
bf16):

- each kernel of K1 (splash) and K2 (flash), forward, dq and dK/dV, two
  ways: ``ms``, its device time (``device_ms`` of ``chip_smoke.py``: 20
  launches queued behind a spin of the card, so the host's cost to launch
  them is not counted), and ``call_ms``, one call through its wrapper by
  CUDA events around it (``timed_ms``), the host's cost included;
- one replica's bench_1b forward + backward at full width and depth through
  the kernels (``attention="auto"``, per-layer remat, as the trainer runs
  it): ``step_ms``, the median of 5 steps by CUDA events, and, from one step
  under ``torch.profiler``, the device time of the attention kernels and of
  all kernels.

Each turn prints one JSON line; the last line holds, per tree, the median of
its turns. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER = ("old", "new", "new", "old")
SHAPE = (1, 2048, 16, 8, 128)  # B, S, Hq, Hkv, hd of bench_1b


def measure(tree: str) -> dict:
    """One turn's numbers for the port in ``tree``."""
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import device_ms, timed_ms

    sys.path.insert(0, os.path.abspath(tree))
    from torch.profiler import ProfilerActivity, profile
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.ops import attention as ta

    device = torch.device("cuda", 0)
    B, S, hq, hkv, hd = SHAPE
    g = torch.Generator(device=device).manual_seed(S + 10 * hq + hkv + hd + B)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=device).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    out = {"attention_py": os.path.relpath(ta.__file__, HERE), "kernels": {}}
    for impl in ("splash", "flash"):
        qi, sm = (q * ta.splash_scale(hd, q.dtype), 1.0) if impl == "splash" else (q, 1.0 / math.sqrt(hd))
        o, lse = ta.attention_fwd(qi, k, v, sm, impl)
        do = (2 * o.float()).to(torch.bfloat16)
        delta = ta.attention_delta(o, do)
        args = (qi, k, v, lse, delta, do, sm)
        for kernel, fn in (("fwd", lambda: ta.attention_fwd(qi, k, v, sm, impl)),
                           ("dq", lambda: ta.attention_dq(*args, impl)),
                           ("dkv", lambda: ta.attention_dkv(*args, impl))):
            out["kernels"][f"{impl}_{kernel}"] = {"ms": device_ms(fn, 20), "call_ms": timed_ms(fn, 20)}

    cfg = CONFIGS["bench_1b"]
    model = Llama(cfg, device=device, remat=True)
    model.init_weights(torch.Generator(device=device).manual_seed(13))
    toks = torch.randint(0, cfg.vocab_size, (1, S + 1),
                         generator=torch.Generator(device=device).manual_seed(14), device=device)

    def step() -> None:
        model.zero_grad(set_to_none=True)
        model.loss(toks[:, :-1], toks[:, 1:]).backward()

    for layer in model.layers:
        layer.attention = "auto"
    out["step_ms"] = timed_ms(step, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    out["attention_device_ms"] = sum(e.self_device_time_total for e in events
                                     if "attention_" in e.key) / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--measure", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write every turn and the summary here as JSON")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_ab: CUDA is not available", file=sys.stderr)
        return 2
    if a.measure:
        print(json.dumps(measure(a.measure)), flush=True)
        return 0
    if not a.trees:
        ap.error("--trees OLD NEW is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    trees = dict(zip(("old", "new"), a.trees))
    turns = []
    for label in ORDER:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", trees[label]],
                           capture_output=True, text=True, timeout=900)
        sys.stderr.write(r.stderr[-4000:])
        if r.returncode != 0:
            raise RuntimeError(f"turn {label} ({trees[label]}) failed with exit code {r.returncode}")
        turn = {"tree": label, "path": trees[label], **json.loads(r.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)

    def med(rows, get):
        return statistics.median(get(t) for t in rows)

    summary = {"gpu": smi}
    for label in ("old", "new"):
        rows = [t for t in turns if t["tree"] == label]
        summary[label] = {
            "kernels": {key: {m: med(rows, lambda t: t["kernels"][key][m]) for m in ("ms", "call_ms")}
                        for key in rows[0]["kernels"]},
            **{m: med(rows, lambda t: t[m]) for m in ("step_ms", "busy_ms", "attention_device_ms")},
            "step_ms_turns": [t["step_ms"] for t in rows],
        }
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
