"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``torchft_tpu_torch/ops/csrc`` (one
   nvcc per source, started together), times the build, and prints per
   kernel what ptxas reported (registers, stack, spills, wgmma serialized)
   and its HGMMA (wgmma) and UTMALDG (TMA load) SASS instructions. The
   attention forward and dK/dV kernels must have both at every head dim
   and no spill at head dim 128.
2. Holds each fp8 kernel against its plain PyTorch version on the card, bit
   for bit, from a single element up to the full bench_1b gradient count,
   and times kernel, plain version and the device-memory bound at that
   size; quantize is also timed at the reduced-chunk shape the two-replica
   allreduce gives its second launch.
3. Checks the fp8-quantized allreduce on CUDA tensors against the same
   allreduce on CPU tensors (the plain versions), bit for bit.
4. Holds the attention kernels (forward, dq, dkv) of K1 (splash) and K2
   (flash) against their plain versions at the bench_1b shapes (GQA 16/8,
   also with K/V as strided views of one fused tensor, and 16/16 for K2),
   at S 384 (an odd number of tiles) and at head dims 64 and 256 with
   batch 2: each kernel output's max abs error against an f32 evaluation
   of the same bf16 inputs must be at most twice the plain bf16 version's,
   and lse within 1e-3. Times each kernel, its plain version and torch's
   scaled_dot_product_attention (the yardstick only) at the bench_1b GQA
   shape beside the tensor-core bound, by device time (``device_ms``), and
   the kernels and SDPA alone at the llama3_8b attention shape.
5. Drives K2's path: a 2-layer bench_1b-width Llama with
   ``attention="flash"``, forward and backward, its loss compared with
   ``attention="xla"``, and K2's kernels counted on that run. Then times
   one replica's full bench_1b forward + backward through the
   materialized attention and through the kernels, in turns.
6. Trains Llama bench_1b at full width and depth as two fault-tolerant
   replica groups (threads on one card) with an in-process lighthouse, the
   fp8-quantized managed allreduce and a scripted crash of replica 1 at
   step 3 that restarts and heals over HTTP. It checks finite losses, the
   discarded step, the heal, bitwise-equal replicas, that attention
   dispatched to splash, and that the fp8 kernels and K1's three kernels
   launched on this run.

Any failed check raises, so the exit code is non-zero. The last line of
stdout is ``{"ok": true, "device": {...}}``; the line before the card's
name and power limit is the kernel table as JSON. In it every ``ms``,
``plain_ms`` and ``library_ms`` is device time by ``device_ms``, and
``call_ms`` is one call through the kernel's wrapper by CUDA events around
it, the host's time to launch included. Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet peak
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
ROW = 512


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events
    around each run: the device time plus whatever the host adds."""
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


def device_ms(fn, launches: int, reps: int = 3) -> float:
    """Device milliseconds of one ``fn``: the median over ``reps`` of CUDA
    events around ``launches`` back-to-back runs, divided by their count.
    Each group is queued behind a ~20 ms spin of the card, so the host's
    own time to launch them (the Python wrapper, tile maps, ctypes) is not
    counted as long as it stays under the spin."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(40_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
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


# SASS instructions counted per kernel: Hopper's tensor-core product
# (wgmma) and its TMA tile load
SASS_OPS = ("HGMMA", "UTMALDG")


def _demangle(names):
    """``attention_fwd_kernel<128, true>`` for each mangled kernel name."""
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n) for n in out]


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the one Triton bundles."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(cand):
        return cand
    if shutil.which("cuobjdump"):
        return shutil.which("cuobjdump")
    import triton

    return os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")


def kernel_build_report(sources) -> dict:
    """Per kernel of the built libraries: what ptxas reported (registers,
    stack and spill bytes, wgmma serialized for want of registers) and the
    count of each of ``SASS_OPS`` in its SASS (cuobjdump). Logs a line per
    kernel."""
    from torchft_tpu_torch.ops._build import build, build_log

    report = {}
    for source in sources:
        mangled, current = {}, None
        for line in build_log(source).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = mangled.setdefault(m.group(1), {"serialized": False})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and current is not None:
                current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                current["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                current["static_smem"] = int(sm.group(1)) if sm else 0
            if "C7512" in line:
                for name, entry in mangled.items():
                    if name in line:
                        entry["serialized"] = True
        sass = subprocess.run([_cuobjdump(), "-sass", build(source)], capture_output=True,
                              text=True, check=True).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            elif current is not None:
                for op in SASS_OPS:
                    current[op] += op in line
        for name, short in zip(mangled, _demangle(list(mangled))):
            report[short] = {**mangled[name], **counts.get(name, dict.fromkeys(SASS_OPS, 0))}
    for name, r in report.items():
        log(f"ptxas {name}: {r.get('registers')} registers, {r.get('static_smem')} bytes static smem, "
            f"{r.get('stack')} bytes stack, spill stores {r.get('spill_stores')} loads "
            f"{r.get('spill_loads')} bytes{', wgmma serialized' if r['serialized'] else ''}; "
            + ", ".join(f"{op} {r[op]}" for op in SASS_OPS))
    return report


# the kernel instance each path runs at the bench_1b head dim
ATTN_INSTANCE = {"fwd": "attention_fwd_kernel<128, {split}>", "dq": "attention_dq_kernel<128>",
                 "dkv": "attention_dkv_kernel<128>"}


def sass_counts(entry: dict) -> dict:
    return {op.lower(): entry[op] for op in SASS_OPS}


def check_hopper_kernels(report: dict) -> None:
    """The forward and dK/dV kernels run on wgmma fed by TMA at every head
    dim, and do not spill at the bench_1b head dim 128."""
    for name, r in report.items():
        if not name.startswith(("attention_fwd_kernel", "attention_dkv_kernel")):
            continue
        if not all(r[op] for op in SASS_OPS):
            raise RuntimeError(f"{name} has no {'/'.join(op for op in SASS_OPS if not r[op])} "
                               "instruction in its SASS")
        if name.startswith(("attention_fwd_kernel<128", "attention_dkv_kernel<128")) and (
                r["spill_stores"] or r["spill_loads"]):
            raise RuntimeError(f"{name} spills registers: {r}")


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
                "ms": device_ms(lambda: q.fused_quantize_fp8(x), 10),
                "call_ms": timed_ms(lambda: q.fused_quantize_fp8(x), 10),
                "plain_ms": device_ms(lambda: q.quantize_fp8_plain(x), 3),
                "bytes": 4 * n + rows * ROW + 4 * rows,
                "chunk_n": chunk.numel(),
                "chunk_ms": device_ms(lambda: q.fused_quantize_fp8(chunk), 10),
            }
            del chunk
            timing["dequantize"] = {
                "ms": device_ms(lambda: q.fused_dequantize_fp8(qk, sk, nk), 10),
                "call_ms": timed_ms(lambda: q.fused_dequantize_fp8(qk, sk, nk), 10),
                "plain_ms": device_ms(lambda: q.dequantize_fp8_plain(qk, sk, nk), 3),
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


# attention shapes: (label, B, S, Hq, Hkv, hd, paths, K/V as strided views
# of one fused [B, S, 2 Hkv, hd] tensor); bench_1b first, and its GQA shape
# is the one timed
BOTH = ("splash", "flash")
ATTN_SHAPES = (
    ("bench_1b", 1, 2048, 16, 8, 128, BOTH, False),
    ("bench_1b_fused_kv", 1, 2048, 16, 8, 128, BOTH, True),
    ("bench_1b_mha", 1, 2048, 16, 16, 128, ("flash",), False),
    ("s384", 1, 384, 16, 8, 128, BOTH, False),  # an odd number of 128-row tiles
    ("hd64_b2", 2, 256, 4, 2, 64, BOTH, False),
    ("hd256_b2", 2, 256, 4, 2, 256, BOTH, False),
)
# timed only (the plain versions would materialize ~8.6 GB f32 scores per
# tensor): the attention of the repo's llama3_8b config
LLAMA3_8B_ATTN = (1, 8192, 32, 8, 128)
# K1 (splash_attention_tpu) and K2 (flash_attention_tpu) in the reference
ATTN_REPLACES = {"splash": 144, "flash": 55}
# matmuls of causal size each kernel does (2 * B * Hq * hd flops per
# (query, key) pair each): fwd Q K^T, P V; dq Q K^T, dO V^T, dS K; dkv
# K Q^T, P^T dO, V dO^T, dS^T Q
ATTN_MATMULS = {"fwd": 2, "dq": 3, "dkv": 4}


def attention_bound_ms(kernel: str, B: int, S: int, hq: int, hkv: int, hd: int):
    """(ms, "operations" | "bytes"): the larger of the kernel's causal
    tensor-core flops over the bf16 peak and its bytes (inputs read once,
    outputs written once) over the memory rate."""
    pairs = B * hq * S * (S + 1) // 2
    flops = ATTN_MATMULS[kernel] * 2 * hd * pairs
    q_bytes, kv_bytes, stat_bytes = 2 * B * S * hq * hd, 2 * B * S * hkv * hd, 4 * B * hq * S
    nbytes = {
        "fwd": q_bytes + 2 * kv_bytes + q_bytes + stat_bytes,
        "dq": 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + q_bytes,
        "dkv": 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + 2 * kv_bytes,
    }[kernel]
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(device: torch.device):
    """Each attention kernel against its plain version; returns per-path
    stats (max abs error against the plain version, worst error ratio
    against the f32 evaluation) and the bench_1b GQA timings."""
    from torchft_tpu_torch.ops import attention as ta

    stats = {impl: {k: {"err": 0.0, "ratio": 0.0} for k in ATTN_MATMULS}
             for impl in ("splash", "flash")}
    timing = {}
    for label, B, S, hq, hkv, hd, paths, fused in ATTN_SHAPES:
        g = torch.Generator(device=device).manual_seed(S + 10 * hq + hkv + hd + B)
        q = torch.randn(B, S, hq, hd, generator=g, device=device).to(torch.bfloat16)
        if fused:
            kv = torch.randn(B, S, 2 * hkv, hd, generator=g, device=device).to(torch.bfloat16)
            k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        else:
            k, v = (torch.randn(B, S, hkv, hd, generator=g, device=device).to(torch.bfloat16)
                    for _ in range(2))
        for impl in paths:
            if impl == "splash":
                qi, sm = q * ta.splash_scale(hd, q.dtype), 1.0
            else:
                qi, sm = q, 1.0 / math.sqrt(hd)
            f32 = [x.float() for x in (qi, k, v)]
            o_k, lse_k = ta.attention_fwd(qi, k, v, sm, impl)
            o_p, lse_p = ta.attention_fwd_plain(qi, k, v, sm, impl == "splash")
            o_32, lse_32 = ta.attention_fwd_plain(*f32, sm, True)
            # the gradient of sum(out.float() ** 2)
            do = (2 * o_p.float()).to(torch.bfloat16)
            delta = ta.attention_delta(o_p, do)
            args = (qi, k, v, lse_p, delta, do, sm)
            args_32 = (*f32, lse_32, ta.attention_delta(o_32, do.float()), do.float(), sm)
            dq_k = ta.attention_dq(*args, impl)
            dk_k, dv_k = ta.attention_dkv(*args, impl)
            dq_p = ta.attention_dq_plain(*args)
            dk_p, dv_p = ta.attention_dkv_plain(*args)
            dq_32 = ta.attention_dq_plain(*args_32)
            dk_32, dv_32 = ta.attention_dkv_plain(*args_32)
            torch.cuda.synchronize()
            lse_err = max_abs_err(lse_k, lse_32)
            if not lse_err <= 1e-3:
                raise RuntimeError(f"{impl} lse at {label}: max abs error {lse_err} > 1e-3")
            for kernel, outs in (("fwd", [(o_k, o_p, o_32)]),
                                 ("dq", [(dq_k, dq_p, dq_32)]),
                                 ("dkv", [(dk_k, dk_p, dk_32), (dv_k, dv_p, dv_32)])):
                for got, plain, ref in outs:
                    if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
                        raise RuntimeError(f"{impl}_{kernel} at {label}: bad shape or non-finite")
                    e_k, e_p = max_abs_err(got.float(), ref), max_abs_err(plain.float(), ref)
                    ratio = e_k / e_p if e_p > 0 else (0.0 if e_k == 0 else math.inf)
                    st = stats[impl][kernel]
                    st["err"] = max(st["err"], max_abs_err(got.float(), plain.float()))
                    st["ratio"] = max(st["ratio"], ratio)
                    log(f"attention {impl}_{kernel} {label} B={B} S={S} Hq={hq} Hkv={hkv} "
                        f"hd={hd}: kernel err {e_k:.3e}, plain bf16 err {e_p:.3e} (vs f32), "
                        f"kernel-plain {max_abs_err(got.float(), plain.float()):.3e}")
                    if not e_k <= 2 * e_p:
                        raise RuntimeError(
                            f"{impl}_{kernel} at {label}: error {e_k} against f32 exceeds "
                            f"twice the plain bf16 version's {e_p}")
            if label == "bench_1b":
                fns = {
                    "fwd": (lambda: ta.attention_fwd(qi, k, v, sm, impl),
                            lambda: ta.attention_fwd_plain(qi, k, v, sm, impl == "splash")),
                    "dq": (lambda: ta.attention_dq(*args, impl),
                           lambda: ta.attention_dq_plain(*args)),
                    "dkv": (lambda: ta.attention_dkv(*args, impl),
                            lambda: ta.attention_dkv_plain(*args)),
                }
                sdpa_fwd, sdpa_bwd = sdpa_ms(qi, k, v, do, sm)
                for kernel, (fn, plain_fn) in fns.items():
                    bound, by = attention_bound_ms(kernel, B, S, hq, hkv, hd)
                    r = timing[f"{impl}_{kernel}"] = {
                        "ms": device_ms(fn, 20), "call_ms": timed_ms(fn, 20),
                        "plain_ms": device_ms(plain_fn, 3), "bound_ms": bound, "bound_by": by,
                        # SDPA's backward computes dq, dk and dv in one call
                        "library_ms": sdpa_fwd if kernel == "fwd" else sdpa_bwd,
                    }
                    log(f"attention {impl}_{kernel} bench_1b timing: kernel {r['ms']:.4f} ms "
                        f"(one call with its host time {r['call_ms']:.4f} ms), plain "
                        f"{r['plain_ms']:.3f} ms, sdpa {'fwd' if kernel == 'fwd' else 'bwd'} "
                        f"{r['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
            del o_k, o_p, o_32, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p, dq_32, dk_32, dv_32
            torch.cuda.empty_cache()
    for impl, kernels in stats.items():
        for kernel, st in kernels.items():
            log(f"attention {impl}_{kernel}: max abs error vs plain {st['err']:.3e}, "
                f"worst error ratio vs plain (against f32) {st['ratio']:.3f}")
    time_llama3_8b_attention(device)
    return stats, timing


def sdpa_ms(q, k, v, do, sm: float):
    """Device ms of torch's scaled_dot_product_attention forward and of its
    backward (dq, dk and dv in one call) on the same [B, S, H, hd] inputs:
    the yardstick, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=sm, enable_gqa=True), 20)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=sm, enable_gqa=True)
    do_t = do.transpose(1, 2)
    bwd = device_ms(lambda: torch.autograd.grad(out, leaves, do_t, retain_graph=True), 20)
    return fwd, bwd


def time_llama3_8b_attention(device: torch.device) -> dict:
    """Times K1's and K2's forward, dq and dkv at the llama3_8b attention
    shape beside SDPA (no reference there: the plain versions would need
    tens of GB)."""
    from torchft_tpu_torch.ops import attention as ta

    B, S, hq, hkv, hd = LLAMA3_8B_ATTN
    g = torch.Generator(device=device).manual_seed(8)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=device).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    sm = 1.0 / math.sqrt(hd)
    o, lse = ta.attention_fwd(q, k, v, sm, "flash")
    do = torch.randn_like(o)
    delta = ta.attention_delta(o, do)
    out = {}
    for impl in ("splash", "flash"):
        for kernel, fn in (
            ("fwd", lambda: ta.attention_fwd(q, k, v, sm, impl)),
            ("dq", lambda: ta.attention_dq(q, k, v, lse, delta, do, sm, impl)),
            ("dkv", lambda: ta.attention_dkv(q, k, v, lse, delta, do, sm, impl)),
        ):
            bound, _ = attention_bound_ms(kernel, B, S, hq, hkv, hd)
            ms = device_ms(fn, 5)
            out[f"{impl}_{kernel}"] = {"ms": ms, "bound_ms": bound}
    out["sdpa_fwd"], out["sdpa_bwd"] = sdpa_ms(q, k, v, do, sm)
    log(f"attention at llama3_8b (B={B} S={S} Hq={hq} Hkv={hkv} hd={hd}), device ms: " + ", ".join(
        f"{key} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, {r['bound_ms'] / r['ms']:.1%})"
        for key, r in out.items() if isinstance(r, dict))
        + f"; sdpa fwd {out['sdpa_fwd']:.4f}, bwd {out['sdpa_bwd']:.4f}")
    return out


def check_flash_model(device: torch.device) -> dict:
    """K2's path: a 2-layer bench_1b-width Llama through attention="flash",
    forward and backward, against attention="xla"; K2's launches counted
    on that run only."""
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.ops import attention as ta

    cfg = dataclasses.replace(CONFIGS["bench_1b"], n_layers=2)
    model = Llama(cfg, device=device, attention="flash")
    model.init_weights(torch.Generator(device=device).manual_seed(11))
    g = torch.Generator(device=device).manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=g, device=device)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    ta.reset_launches()
    loss = model.loss(inputs, targets)
    loss.backward()
    torch.cuda.synchronize()
    launches = {k: n for k, n in ta.LAUNCHES.items() if k.startswith("flash_")}
    dispatch = ta.LAST_DISPATCH
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    for layer in model.layers:
        layer.attention = "xla"
    with torch.no_grad():
        ref = model.loss(inputs, targets)
    diff = abs(loss.item() - ref.item())
    log(f"K2 model path (2-layer bench_1b, attention=flash): loss {loss.item():.5f}, "
        f"xla {ref.item():.5f}, |diff| {diff:.2e}, launches {launches}")
    if dispatch != "flash" or not grads_finite:
        raise RuntimeError(f"flash model path: dispatch {dispatch}, finite grads {grads_finite}")
    # bf16 activations round at other places on the two paths (as the
    # port's bf16 Llama against the reference's, tests/test_torch_llama.py)
    if not diff <= 2e-2 * abs(ref.item()):
        raise RuntimeError(f"flash model loss {loss.item()} differs from xla {ref.item()}")
    for kernel, count in launches.items():
        if count == 0:
            raise RuntimeError(f"{kernel} never launched on the flash model path")
    del model
    torch.cuda.empty_cache()
    return launches


def time_model_fwd_bwd(device: torch.device) -> dict:
    """One replica's bench_1b forward + backward at full width and depth
    (batch 1, seq 2048, per-layer remat, as the trainer runs it) through
    the materialized attention ("xla") and the kernels ("auto" -> splash),
    in turns xla, auto, auto, xla; each turn the median of 5 steps by CUDA
    events after a warm-up step. Then one step of each under
    torch.profiler: device busy time, the attention kernels' share and the
    kernel count. Also each path's peak device memory."""
    from torch.profiler import ProfilerActivity, profile
    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    cfg = CONFIGS["bench_1b"]
    model = Llama(cfg, device=device, remat=True)
    model.init_weights(torch.Generator(device=device).manual_seed(13))
    g = torch.Generator(device=device).manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=g, device=device)

    def step(impl: str) -> None:
        for layer in model.layers:
            layer.attention = impl
        model.zero_grad(set_to_none=True)
        model.loss(toks[:, :-1], toks[:, 1:]).backward()

    out = {impl: {"ms": [], "peak_gib": 0.0} for impl in ("xla", "auto")}
    for impl in ("xla", "auto", "auto", "xla"):
        torch.cuda.reset_peak_memory_stats()
        out[impl]["ms"].append(timed_ms(lambda: step(impl), 5))
        out[impl]["peak_gib"] = max(out[impl]["peak_gib"],
                                    torch.cuda.max_memory_allocated() / 2**30)
    for impl, r in out.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(impl)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        r["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        r["attention_ms"] = sum(e.self_device_time_total for e in events
                                if "attention_" in e.key) / 1e3
        r["kernels"] = sum(e.count for e in events if e.self_device_time_total > 0)
        log(f"one replica bench_1b forward+backward, attention={impl}: "
            f"turns {[round(t, 1) for t in r['ms']]} ms, peak {r['peak_gib']:.2f} GiB; "
            f"profiled step: wall {wall:.1f} ms, device busy {r['busy_ms']:.1f} ms "
            f"({r['kernels']} kernels), attention kernels {r['attention_ms']:.1f} ms")
    del model
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchft_tpu_torch.models.llama import CONFIGS
    from torchft_tpu_torch.ops import attention as ta
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
    sources = ("fp8_rowwise.cu", "attention.cu")
    # one nvcc per source, started together; a failed build raises here
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build, sources))
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, {len(sources)} sources "
        "in parallel)")
    build_report = kernel_build_report(sources)
    check_hopper_kernels(build_report)

    cfg = TrainConfig(config="bench_1b", steps=6, batch_size=1, seq_len=2048,
                      quantize=True, fail_at=3)
    n_params = CONFIGS[cfg.config].num_params()
    stats, timing = check_kernels(device, n_params, world=REPLICAS)
    log(f"quantize at the reduced-chunk shape (n={timing['quantize']['chunk_n']}): "
        f"{timing['quantize']['chunk_ms']:.3f} ms; at the full gradient: "
        f"{timing['quantize']['ms']:.3f} ms, dequantize {timing['dequantize']['ms']:.3f} ms "
        f"(device ms; one call with its host time: quantize {timing['quantize']['call_ms']:.3f} ms, "
        f"dequantize {timing['dequantize']['call_ms']:.3f} ms)")
    check_allreduce(device)
    attn_stats, attn_timing = check_attention(device)
    flash_launches = check_flash_model(device)
    time_model_fwd_bwd(device)

    q.reset_launches()
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = run_replicas(cfg, device, on_step=lambda e: log(
        f"step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
        f"participants={e['participants']} committed={e['committed']} "
        f"healed={e['healed']} attention={e['attention']} step_ms={e['step_ms']:.1f} "
        f"compute_ms={e['compute_ms']:.1f} allreduce_ms={e['allreduce_ms']:.1f} "
        f"tokens_per_s={e['tokens_per_s']:.1f}"))
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    dispatch = {e["attention"] for r in results for e in r["log"]}
    log(f"training: {time.perf_counter() - t0:.1f} s, attention {sorted(dispatch)}, "
        f"launches {launches}, "
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
    if dispatch != {"splash"}:
        raise RuntimeError(f"training attention dispatched to {dispatch}, not splash")
    on_path = ("quantize_fp8_rowwise", "dequantize_fp8_rowwise",
               "splash_fwd", "splash_dq", "splash_dkv")
    for kernel in on_path:
        if launches[kernel] == 0:
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
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            **sass_counts(build_report[f"{kname}_kernel"]),
        })
    for impl in ("splash", "flash"):
        for kernel in ATTN_MATMULS:
            key = f"{impl}_{kernel}"
            kernels.append({
                "name": f"attention_{kernel}_kernel ({impl})",
                "route": "cuda",
                "source": "torchft_tpu_torch/ops/csrc/attention.cu",
                "replaces": f"torchft_tpu/ops/attention.py:{ATTN_REPLACES[impl]}",
                # K2 runs on its own path (check_flash_model), K1 in training
                "launches": flash_launches[key] if impl == "flash" else launches[key],
                "max_abs_err": attn_stats[impl][kernel]["err"],
                **attn_timing[key],
                # the head-dim-128 instance that bench_1b runs
                **sass_counts(build_report[ATTN_INSTANCE[kernel].format(
                    split=str(impl == "splash").lower())]),
            })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
