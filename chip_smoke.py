"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``torchft_tpu_torch/ops/csrc`` and
   times the build.
2. Holds each kernel against its plain PyTorch version on the card, bit for
   bit, from a single element up to the full bench_1b gradient count, and
   times kernel, plain version and the device-memory bound at that size;
   quantize is also timed at the reduced-chunk shape the two-replica
   allreduce gives its second launch.
3. Checks the fp8-quantized allreduce on CUDA tensors against the same
   allreduce on CPU tensors (the plain versions), bit for bit.
4. Trains Llama bench_1b at full width and depth as two fault-tolerant
   replica groups (threads on one card) with an in-process lighthouse, the
   fp8-quantized managed allreduce and a scripted crash of replica 1 at
   step 3 that restarts and heals over HTTP. It checks finite losses, the
   discarded step, the heal, bitwise-equal replicas, and that both kernels
   launched on this run.

Any failed check raises, so the exit code is non-zero. The last line of
stdout is ``{"ok": true, "device": {...}}``; the line before it is the
kernel table as JSON. Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet peak
ROW = 512


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ, NaN payloads aside (a NaN equals a NaN)."""
    if a.dtype in (torch.float8_e4m3fn, torch.uint8):
        return int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
    differ = a.view(torch.int32) != b.view(torch.int32)
    return int((differ & ~(torch.isnan(a) & torch.isnan(b))).sum())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


def make_input(kind: str, n: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(1234 + n)
    x = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    if kind == "zero_rows":
        x.view(-1, ROW)[::2] = 0.0
    elif kind == "wide_range":
        # magnitudes spread log-uniformly over 1e-8..1e8 within each row
        u = torch.rand(n, generator=g, device=device)
        x = x.sign() * torch.exp(math.log(1e-8) + u * (math.log(1e8) - math.log(1e-8)))
    elif kind == "non_finite":
        rows = x.view(-1, ROW)
        rows[0, 3] = float("inf")
        rows[1, 5] = float("-inf")
        rows[2, 7] = float("nan")
        rows[3, 0] = 1e5
        rows[3, 9] = float("nan")
    return x


def chunk_elems(n: int, world: int) -> int:
    """Elements of one rank's reduced chunk in the quantized allreduce of
    ``n`` values over ``world`` ranks (``collectives.py``'s partition)."""
    per_rank = -(-n // world)
    return max(1, -(-per_rank // ROW)) * ROW


def check_kernels(device: torch.device, full_n: int, world: int):
    from torchft_tpu_torch.ops import quantization as q

    cases = [
        ("single", 1), ("ragged", 511), ("ragged", ROW * 256 + 7),
        ("zero_rows", ROW * 64), ("wide_range", ROW * 1024 + 3),
        ("non_finite", ROW * 8), ("bench_1b_grads", full_n),
    ]
    stats = {"quantize": {"mismatch": 0, "err": 0.0}, "dequantize": {"mismatch": 0, "err": 0.0}}
    timing = {}
    for kind, n in cases:
        x = make_input(kind, n, device)
        qk, sk, nk = q.fused_quantize_fp8(x)
        qp, sp, np_ = q.quantize_fp8_plain(x)
        torch.cuda.synchronize()
        if nk != np_ or qk.shape != qp.shape or sk.shape != sp.shape:
            raise RuntimeError(f"quantize shapes differ for {kind} n={n}")
        mq = bits_differ(qk, qp) + bits_differ(sk, sp)
        deq_k = q.fused_dequantize_fp8(qk, sk, nk)
        deq_p = q.dequantize_fp8_plain(qk, sk, nk)
        torch.cuda.synchronize()
        md = bits_differ(deq_k, deq_p)
        # quantize error: the two versions' codes decoded the same way
        eq = max_abs_err(q.dequantize_fp8_plain(qk, sk, nk), q.dequantize_fp8_plain(qp, sp, np_))
        ed = max_abs_err(deq_k, deq_p)
        stats["quantize"]["mismatch"] += mq
        stats["dequantize"]["mismatch"] += md
        stats["quantize"]["err"] = max(stats["quantize"]["err"], eq)
        stats["dequantize"]["err"] = max(stats["dequantize"]["err"], ed)
        log(f"kernel check {kind:>14} n={n:>10}: quantize mismatches={mq} "
            f"dequantize mismatches={md}")
        if kind == "bench_1b_grads":
            rows = qk.shape[0]
            chunk = x[:chunk_elems(n, world)]
            timing["quantize"] = {
                "ms": timed_ms(lambda: q.fused_quantize_fp8(x), 10),
                "plain_ms": timed_ms(lambda: q.quantize_fp8_plain(x), 3),
                "bytes": 4 * n + rows * ROW + 4 * rows,
                "chunk_n": chunk.numel(),
                "chunk_ms": timed_ms(lambda: q.fused_quantize_fp8(chunk), 10),
            }
            del chunk
            timing["dequantize"] = {
                "ms": timed_ms(lambda: q.fused_dequantize_fp8(qk, sk, nk), 10),
                "plain_ms": timed_ms(lambda: q.dequantize_fp8_plain(qk, sk, nk), 3),
                "bytes": rows * ROW + 4 * rows + 4 * n,
            }
        del x, qk, sk, qp, sp, deq_k, deq_p
        torch.cuda.empty_cache()
    for name, s in stats.items():
        if s["mismatch"]:
            raise RuntimeError(f"{name} kernel disagrees with its plain version "
                               f"in {s['mismatch']} elements")
    return stats, timing


def check_allreduce(device: torch.device) -> None:
    """Quantized allreduce of CUDA tensors (the kernels) against the same
    call on CPU tensors (the plain versions): bitwise equal."""
    from torchft_tpu_torch.collectives import allreduce_quantized
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupHost, ReduceOp

    rng = np.random.RandomState(7)
    inputs = [[rng.randn(37, 129).astype(np.float32), rng.randn(1000).astype(np.float32)]
              for _ in range(2)]
    store = KvStoreServer("127.0.0.1:0")
    try:
        for dev in (device, torch.device("cpu")):
            out = [None, None]

            def rank(r: int, dev=dev, out=out, prefix=str(dev)) -> None:
                pg = ProcessGroupHost(timeout=60)
                pg.configure(f"127.0.0.1:{store.port}/{prefix}", r, 2)
                try:
                    leaves = [torch.from_numpy(a).to(dev) for a in inputs[r]]
                    res = allreduce_quantized(leaves, ReduceOp.AVG, pg).get_future().wait(60)
                    out[r] = [t.cpu() for t in res]
                finally:
                    pg.shutdown()

            threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            if any(o is None for o in out):
                raise RuntimeError(f"quantized allreduce on {dev} did not finish")
            if dev.type == "cuda":
                cuda_out = out
            else:
                cpu_out = out
    finally:
        store.shutdown()
    for r in range(2):
        for a, b in zip(cuda_out[r], cpu_out[r]):
            if bits_differ(a, b):
                raise RuntimeError("quantized allreduce: CUDA and CPU results differ")
    log("quantized allreduce: CUDA kernels == CPU plain versions, bitwise (world 2, AVG)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchft_tpu_torch.models.llama import CONFIGS
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.ops._build import build
    from torchft_tpu_torch.train import REPLICAS, TrainConfig, run_replicas

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build("fp8_rowwise.cu")
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    cfg = TrainConfig(config="bench_1b", steps=6, batch_size=1, seq_len=2048,
                      quantize=True, fail_at=3)
    n_params = CONFIGS[cfg.config].num_params()
    stats, timing = check_kernels(device, n_params, world=REPLICAS)
    log(f"quantize at the reduced-chunk shape (n={timing['quantize']['chunk_n']}): "
        f"{timing['quantize']['chunk_ms']:.3f} ms; at the full gradient: "
        f"{timing['quantize']['ms']:.3f} ms, dequantize {timing['dequantize']['ms']:.3f} ms")
    check_allreduce(device)

    q.reset_launches()
    t0 = time.perf_counter()
    results = run_replicas(cfg, device, on_step=lambda e: log(
        f"step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
        f"participants={e['participants']} committed={e['committed']} "
        f"healed={e['healed']} step_ms={e['step_ms']:.1f} "
        f"compute_ms={e['compute_ms']:.1f} allreduce_ms={e['allreduce_ms']:.1f} "
        f"tokens_per_s={e['tokens_per_s']:.1f}"))
    launches = dict(q.LAUNCHES)
    log(f"training: {time.perf_counter() - t0:.1f} s, launches {launches}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # steady: both replicas contributing, no heal served or received (step
    # 0 carries the init_sync heal)
    steady = [e for r in results for e in r["log"]
              if e["committed"] and e["participants"] == 2 and not e["healed"]
              and e["step"] > 0]
    if steady:
        med = {k: statistics.median(e[k] for e in steady)
               for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")}
        log("steady steps (2 participants, median of "
            f"{len(steady)}): step {med['step_ms']:.1f} ms = quorum+fwd+bwd "
            f"{med['compute_ms']:.1f} ms + allreduce {med['allreduce_ms']:.1f} ms + "
            f"commit+optimizer {med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
            f"{med['tokens_per_s']:.1f} tokens/s per replica")
    losses = [e["loss"] for r in results for e in r["log"]]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if any(r["step"] != cfg.steps for r in results):
        raise RuntimeError(f"replicas stopped at steps {[r['step'] for r in results]}")
    if results[1]["restarts"] != 1 or results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"replica 1 did not crash and heal: {results[1]['metrics']}")
    if results[0]["metrics"]["commit_failures"] < 1:
        raise RuntimeError(f"no step was discarded: {results[0]['metrics']}")
    p0, p1 = results[0]["params"], results[1]["params"]
    unequal = [k for k in p0 if not torch.equal(p0[k].view(torch.int16), p1[k].view(torch.int16))]
    if unequal:
        raise RuntimeError(f"replicas differ in {unequal[:5]}")
    log(f"replicas bitwise equal over {len(p0)} tensors; heal after the crash: "
        f"replica 0 staged its state in "
        f"{results[0]['timings'].get('heal_send_s', float('nan')):.2f} s, replica 1 "
        f"received it in {results[1]['timings'].get('heal_recv_s', float('nan')):.2f} s")
    for kernel, count in launches.items():
        if count == 0:
            raise RuntimeError(f"{kernel} never launched on the training path")

    kernels = []
    for key, kname, line in (
        ("quantize", "quantize_fp8_rowwise", 279),
        ("dequantize", "dequantize_fp8_rowwise", 316),
    ):
        t = timing[key]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "torchft_tpu_torch/ops/csrc/fp8_rowwise.cu",
            "replaces": f"torchft_tpu/ops/quantization.py:{line}",
            "launches": launches[kname],
            "max_abs_err": stats[key]["err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
