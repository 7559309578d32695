"""Trace one bench_1b training step of the port under each remat mode on one card.

    python3 remat_trace.py [--modes none,dots,attn,full] [--out FILE]

One replica of the port's Llama at bench_1b's full width and depth (bf16,
batch 1, seq 2048, K1 through the ``torchft_tpu_torch::attention_*`` ops),
forward + backward of ``Llama.loss``, the model's ``remat`` set to each mode
in turn. Per mode, after a warm-up step:

- ``step_ms``: the median of 3 steps by CUDA events (``chip_smoke.timed_ms``);
- one step under ``torch.profiler`` (CPU and CUDA activities):
  ``wall_ms``, the host's time from the step's start to the card's last
  kernel end (the step synchronizes); ``busy_ms``, the union of the CUDA
  kernels' and copies' intervals; ``idle_share`` = 1 - busy / wall;
  ``aten_ops``, the ``aten::`` operators the host dispatched (every level
  of the dispatcher, so the count reads as a volume, not a number of
  kernels); ``kernels``, the CUDA kernels launched; ``host_ms_per_op``,
  (wall - busy) / aten_ops, the host's time per operator that the card
  waited for.

If the profiler records no CUDA event, the device numbers are null and
say "not measured". Prints one JSON object and writes it to ``--out``
(``chiprun_out/remat_trace.json`` by default). Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def trace_mode(model, toks, mode: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import timed_ms

    model.remat = mode

    def step() -> None:
        model.zero_grad(set_to_none=True)
        model.loss(toks[:, :-1], toks[:, 1:]).backward()

    step()
    torch.cuda.synchronize()
    step_ms = timed_ms(step, 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    aten = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
    out = {"mode": mode, "step_ms": step_ms, "host_ms": host_ms, "aten_ops": len(aten)}
    if not device:
        out.update(wall_ms=None, busy_ms=None, idle_share=None, kernels=0,
                   host_ms_per_op=None, note="not measured: the profiler recorded no CUDA event")
        return out
    cpu_start = min(e.time_range.start for e in events if e.device_type == DeviceType.CPU)
    wall = (max(e.time_range.end for e in device) - cpu_start) / 1e3
    busy = _union_ms([(e.time_range.start, e.time_range.end) for e in device])
    out.update(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall, kernels=len(device),
               host_ms_per_op=(wall - busy) / max(len(aten), 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", default="none,dots,attn,full")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "remat_trace.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("remat_trace.py needs a CUDA card", file=sys.stderr)
        return 2
    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    device = torch.device("cuda", 0)
    cfg = CONFIGS["bench_1b"]
    model = Llama(cfg, device=device, remat="none")
    model.init_weights(torch.Generator(device=device).manual_seed(21))
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), device=device,
                         generator=torch.Generator(device=device).manual_seed(22))
    rows = [trace_mode(model, toks, m) for m in args.modes.split(",")]
    for r in rows:
        print(f"remat {r['mode']}: step {r['step_ms']:.1f} ms (median of 3), profiled step wall "
              f"{r['wall_ms']} ms, device busy {r['busy_ms']} ms, idle share {r['idle_share']}, "
              f"aten ops {r['aten_ops']}, kernels {r['kernels']}, host ms per op "
              f"{r['host_ms_per_op']}", flush=True)
    result = {"card": smi, "torch": torch.__version__, "config": "bench_1b B 1 S 2048 bf16",
              "median_of": 3, "rows": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
