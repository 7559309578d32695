"""Environment diagnostic of the port: ``python -m torchft_tpu_torch.doctor``.

Counterpart of ``torchft_tpu/doctor.py``: one command an operator runs on
a fresh host, or in a wedged job's postmortem, to learn whether the
machine can run a replica group of the port now. One line a check, in the
reference's order and format::

    ok   native         built (.../libtorchft_tpu_torch-....so)
    ok   accelerator    cuda: NVIDIA H100 80GB HBM3 (1 device)
    ...

and exit 0 if and only if no check fails. The checks:

- ``native``: the control-plane library builds and loads;
- ``accelerator``: a subprocess initializes CUDA, so a wedged driver reports
  as hung instead of hanging the doctor; with no card it warns "cpu only";
- ``virtual-mesh``: a CPU ``DeviceMesh`` of two gloo ranks (the mesh the
  HSDP tests run on), in subprocesses, shards and reduces;
- ``lighthouse``: a loopback quorum round-trip; ``aggregator``: the
  ``TORCHFT_LIGHTHOUSE_AGGREGATOR`` wiring and a beat through an
  aggregator (``aggregator.check_aggregator``);
- ``retry-env``, ``health-env``, ``compress-env``, ``serve-env``,
  ``redundancy-env``, ``trace-env``: each plane's knobs parse and agree
  with one another; ``policy-env``: the policy plane's mode and numbers
  parse, and its spec loads and folds a synthetic churn burst into a
  frame; ``tuning-env``: every knob whose registry entry names it parses
  as its type (``knobs.REGISTRY``); ``fleetlint``: fleetlint's env
  contract over the package, in process, against the port's committed
  baseline (``torchft_tpu_torch.analysis``);
- ``health-http`` and ``metrics-http``: loopback scrapes of the
  lighthouse's ``/health`` and both ``/metrics`` exporters;
- ``heal``: a loopback HTTP heal in place with one connection dropped
  mid-transfer (it must resume); ``serving``: a registry, a publisher and
  a worker on the host, two versions pulled bitwise; ``redundancy``: a
  k=2 m=1 erasure round trip through one corrupt shard.

Every knob is read through ``knobs``. The reference's ``degrade-env``
comes with the degrade plane (``ROADMAP.md``, item 6).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, List, Tuple

from torchft_tpu_torch import knobs

# (status, detail); status: True ok, False fail, None warn
Result = Tuple["bool | None", str]


def check_native() -> Result:
    try:
        from torchft_tpu_torch.coordination import ensure_native_built

        return True, f"built ({ensure_native_built()})"
    except Exception as e:  # noqa: BLE001
        return False, f"native build/load failed: {e}"


_PROBE = (
    "import json, torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "if n:\n"
    "    torch.zeros(1, device='cuda')\n"
    "print(json.dumps({'count': n, 'name': torch.cuda.get_device_name(0) if n else ''}))\n"
)


def probe_cuda(timeout_s: float = 60.0) -> Tuple[str, str]:
    """``(status, detail)`` of a subprocess that initializes CUDA: "hung",
    "crash", "cpu" or "cuda". A wedged driver hangs its initialization
    forever; the subprocess takes the hang instead of the caller."""
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return "hung", f"CUDA init hung >{timeout_s:.0f}s"
    if out.returncode != 0:
        return "crash", (out.stderr.strip().splitlines() or ["no output"])[-1][-200:]
    info = json.loads(out.stdout.strip().splitlines()[-1])
    if not info["count"]:
        return "cpu", "no CUDA device"
    return "cuda", f"cuda: {info['name']} ({info['count']} device{'s' if info['count'] > 1 else ''})"


def check_accelerator(timeout_s: float = 60.0) -> Result:
    status, detail = probe_cuda(timeout_s)
    if status == "hung":
        return False, f"{detail} — wedged driver? (CPU-only work still runs with device='cpu')"
    if status == "crash":
        return False, f"CUDA init crashed: {detail}"
    if status == "cpu":
        return None, "cpu only (no accelerator — fine for a dev box)"
    return True, detail


_MESH_RANK = (
    "import sys, torch, torch.distributed as dist\n"
    "from torch.distributed.tensor import Shard, distribute_tensor\n"
    "from torchft_tpu_torch.parallel.mesh import make_hsdp_mesh\n"
    "rank, port = int(sys.argv[1]), int(sys.argv[2])\n"
    "dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', rank=rank,\n"
    "                        world_size=2)\n"
    "mesh = make_hsdp_mesh(fsdp=2, device_type='cpu')\n"
    "x = distribute_tensor(torch.arange(8.0), mesh['fsdp'], [Shard(0)])\n"
    "assert x.to_local().numel() == 4\n"
    "assert float(x.full_tensor().sum()) == 28.0\n"
    "dist.destroy_process_group()\n"
    "print('ok')\n"
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_virtual_mesh(timeout_s: float = 120.0) -> Result:
    """The CPU mesh of the HSDP tests: two gloo ranks, one process each."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH", "")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_RANK, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    deadline = time.monotonic() + timeout_s
    try:
        outs = [p.communicate(timeout=max(0.1, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        return False, f"virtual mesh hung >{timeout_s:.0f}s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            return False, f"virtual mesh failed: {err.strip()[-200:]}"
    return True, "2-rank gloo CPU mesh shards + reduces"


def check_lighthouse_roundtrip() -> Result:
    try:
        from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

        lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500,
                              quorum_tick_ms=20, heartbeat_timeout_ms=2000)
        try:
            client = LighthouseClient(f"127.0.0.1:{lh.port}", connect_timeout=5.0)
            client.heartbeat("doctor", timeout=5.0)
            q = client.quorum(replica_id="doctor", timeout=10.0)
            ok = any(m.replica_id == "doctor" for m in q.participants)
            return (True, f"quorum_id={q.quorum_id} formed") if ok else (
                False, "quorum formed without this replica")
        finally:
            lh.shutdown()
    except Exception as e:  # noqa: BLE001
        return False, f"lighthouse round-trip failed: {e}"


def check_aggregator() -> Result:
    from torchft_tpu_torch.aggregator import check_aggregator as check

    return check()


def _quorum_timeout_s() -> float:
    return float(knobs.env_raw("TORCHFT_QUORUM_TIMEOUT_SEC",
                               knobs.env_raw("TORCHFT_TIMEOUT_SEC", "60.0")))


def check_retry_env() -> Result:
    """``TORCHFT_RETRY_*`` parse, and the worst case of retry sleeps stays
    under the quorum timeout: a backoff that can out-sleep the quorum
    window turns a control-plane blip into a failed quorum."""
    try:
        from torchft_tpu_torch.retry import RetryPolicy

        policy = RetryPolicy.from_env()
    except ValueError as e:
        return False, f"TORCHFT_RETRY_* env invalid: {e}"
    quorum_timeout_s = _quorum_timeout_s()
    # every sleep at the ceiling, jitter drawing nothing
    worst_sleep_s = sum(policy.backoff_s(attempt) for attempt in range(2, policy.max_attempts + 1))
    detail = (f"attempts={policy.max_attempts} base={policy.base_s}s "
              f"ceiling={policy.max_backoff_s}s jitter={policy.jitter} "
              f"(worst sleep {worst_sleep_s:.2f}s vs quorum {quorum_timeout_s:.0f}s)")
    if policy.max_backoff_s >= quorum_timeout_s:
        return False, (f"backoff ceiling {policy.max_backoff_s}s >= quorum timeout "
                       f"{quorum_timeout_s}s — one retry sleep can eat the whole quorum window; "
                       "lower TORCHFT_RETRY_MAX_BACKOFF_S")
    if worst_sleep_s >= quorum_timeout_s:
        return None, (f"worst-case retry sleep {worst_sleep_s:.2f}s >= quorum timeout "
                      f"{quorum_timeout_s}s — retries may burn the quorum window sleeping; lower "
                      "TORCHFT_RETRY_MAX_ATTEMPTS or the backoff knobs")
    if not policy.enabled:
        return None, f"retries disabled (max_attempts=1); {detail}"
    return True, detail


def check_health_env() -> Result:
    """``TORCHFT_HEALTH_*`` validate (eject above warn), and the probation
    window outlasts the heartbeat interval: readmission needs probe beats
    inside it."""
    try:
        from torchft_tpu_torch.healthwatch import HealthConfig

        config = HealthConfig.from_env()
    except ValueError as e:
        return False, f"TORCHFT_HEALTH_* env invalid: {e}"
    detail = (f"mode={config.mode} warn_z={config.warn_z} eject_z={config.eject_z} "
              f"eject_steps={config.eject_steps} probation_ms={config.probation_ms}")
    if config.mode == "off":
        return None, f"healthwatch disabled; {detail}"
    heartbeat_ms = float(knobs.env_raw("TORCHFT_HEARTBEAT_INTERVAL_MS", "100"))
    if config.probation_ms <= heartbeat_ms:
        return False, (f"TORCHFT_HEALTH_PROBATION_MS={config.probation_ms} <= heartbeat interval "
                       f"{heartbeat_ms:.0f}ms — the probation window closes before a single "
                       "probe heartbeat lands; raise it")
    if config.probation_ms < heartbeat_ms * config.probe_ok:
        return None, (f"probation_ms={config.probation_ms} < heartbeat interval × probe_ok "
                      f"({heartbeat_ms:.0f}×{config.probe_ok}) — readmission may need several "
                      "windows; consider raising it")
    return True, detail


def check_compress_env() -> Result:
    """``TORCHFT_COMPRESS`` names a codec (the Manager's own resolver), and
    compression on with streaming off is a warning: the codec rides the
    streamed pipeline."""
    try:
        from torchft_tpu_torch.ops.quantization import resolve_compress_mode

        mode = resolve_compress_mode()
    except ValueError as e:
        return False, f"TORCHFT_COMPRESS invalid: {e}; unset it or pick one of off/fp8/int8"
    if mode == "off":
        return True, "compression off (default wire, bit-identical path)"
    stream_raw = (knobs.env_raw("TORCHFT_STREAM_BUCKETS") or "").strip().lower()
    if stream_raw in ("0", "false", "no", "off"):
        return None, (f"TORCHFT_COMPRESS={mode} but TORCHFT_STREAM_BUCKETS={stream_raw!r} "
                      "disables the streaming pipeline compression rides — buckets will ship "
                      "uncompressed; re-enable streaming or unset TORCHFT_COMPRESS")
    return True, f"compression {mode} (rowwise codec, error feedback on)"


def check_health_endpoint() -> Result:
    """A lighthouse's ``/health`` serves the beat it just took."""
    try:
        import urllib.request

        from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

        lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500,
                              quorum_tick_ms=20, heartbeat_timeout_ms=2000,
                              health={"mode": "observe"})
        try:
            client = LighthouseClient(f"127.0.0.1:{lh.port}", connect_timeout=5.0)
            client.heartbeat("doctor", timeout=5.0,
                             telemetry={"step": 1, "step_s": 0.1, "wire_s": 0.01})
            with urllib.request.urlopen(f"http://127.0.0.1:{lh.port}/health",
                                        timeout=5.0) as resp:
                payload = json.loads(resp.read().decode())
        finally:
            lh.shutdown()
        if "doctor" not in payload.get("replicas", {}):
            return False, f"/health missing the beating replica: {payload}"
        return True, (f"/health serves mode={payload.get('mode')} "
                      f"({len(payload.get('replicas', {}))} replica tracked)")
    except Exception as e:  # noqa: BLE001
        return False, f"/health probe failed: {e}"


def check_heal_roundtrip() -> Result:
    """A loopback heal through ``HTTPTransport``, received in place, with
    chunk 1's serve dropped mid-transfer once: the receiver must resume
    from its last verified byte."""
    try:
        import torch

        from torchft_tpu_torch.checkpointing import HTTPTransport
        from torchft_tpu_torch.retry import RetryPolicy

        state = {"user": {"w": torch.arange(256, dtype=torch.float32)},
                 "torchft": {"step": 3, "batches_committed": 6}}
        template = {"user": {"w": torch.zeros(256, dtype=torch.float32)},
                    "torchft": {"step": 0, "batches_committed": 0}}
        # loopback, not DNS: the check is of the transport
        send = HTTPTransport(timeout=10.0, num_chunks=2, hostname="127.0.0.1")
        # its own policy: the re-fetch must happen even where the
        # environment turns retries off (retry-env's finding)
        recv = HTTPTransport(timeout=10.0, state_dict_template=lambda: template,
                             retry_policy=RetryPolicy(max_attempts=3, base_s=0.01, jitter=0.0))
        events: list = []
        try:
            send.send_checkpoint([1], 3, state, 10.0)
            send.inject_chunk_fault(1, "die", times=1)
            got = recv.recv_checkpoint_multi(
                [("loopback", send.metadata)], 3, 10.0,
                on_event=lambda kind, **f: events.append((kind, f)))
        finally:
            send.shutdown()
            recv.shutdown()
        if got["user"]["w"] is not template["user"]["w"]:
            return False, "heal received but not in place (template unused)"
        if not torch.equal(got["user"]["w"], state["user"]["w"]):
            return False, "heal payload mismatch"
        resumed = [f for kind, f in events
                   if kind == "heal_retry" and f.get("resume_offset", 0) > 0]
        if not resumed:
            return False, ("mid-transfer drop never produced a ranged resume "
                           f"(events: {[k for k, _ in events]})")
        return True, ("http heal round-trip in place; ranged re-fetch resumed at byte "
                      f"{resumed[0]['resume_offset']}")
    except Exception as e:  # noqa: BLE001
        return False, f"heal round-trip failed: {e}"


def check_trace_env() -> Result:
    """``TORCHFT_TRACE_*`` validated strictly (``TraceConfig.from_env``
    falls back to defaults on garbage, which is why the doctor flags it),
    and the dump directory takes a write."""
    from torchft_tpu_torch.tracing import (
        TRACE_BUFFER_ENV,
        TRACE_DIR_ENV,
        TRACE_ENV,
        TRACE_SAMPLE_ENV,
        TraceConfig,
    )

    raw_buffer = knobs.env_raw(TRACE_BUFFER_ENV, "")
    if raw_buffer:
        try:
            buf = int(raw_buffer)
        except ValueError:
            return False, (f"{TRACE_BUFFER_ENV}={raw_buffer!r} is not an integer — the Manager "
                           "silently falls back to the default ring size")
        if buf < 16:
            return None, (f"{TRACE_BUFFER_ENV}={buf} below the floor of 16 — clamped; a ring "
                          "that small drops most of a step's spans")
    raw_sample = knobs.env_raw(TRACE_SAMPLE_ENV, "")
    if raw_sample:
        try:
            sample = float(raw_sample)
        except ValueError:
            return False, (f"{TRACE_SAMPLE_ENV}={raw_sample!r} is not a float — the Manager "
                           "silently falls back to sampling every step")
        if not 0.0 <= sample <= 1.0:
            return None, f"{TRACE_SAMPLE_ENV}={sample} outside [0, 1] — clamped"
    cfg = TraceConfig.from_env()
    if cfg.dump_dir:
        try:
            os.makedirs(cfg.dump_dir, exist_ok=True)
            probe = os.path.join(cfg.dump_dir, ".doctor_probe")
            with open(probe, "w") as f:
                f.write("ok")
            os.remove(probe)
        except OSError as e:
            return False, (f"{TRACE_DIR_ENV}={cfg.dump_dir!r} not writable ({e}) — postmortem "
                           "trace auto-dumps will be lost")
    detail = (f"enabled={cfg.enabled} buffer={cfg.buffer} sample={cfg.sample} "
              f"dump_dir={cfg.dump_dir or '(flight-recorder fallback)'}")
    if not cfg.enabled:
        return None, f"tracing disabled ({TRACE_ENV}); {detail}"
    return True, detail


def _parse_prometheus(text: str) -> "dict[str, float]":
    """Series name (labels folded in) -> value; raises on a malformed
    line, which is the probe's point."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        series[name] = float(value)
    return series


def check_metrics_endpoints() -> Result:
    """Both ``/metrics`` exporters, the lighthouse's and the Manager's,
    answer a scrape that parses as Prometheus text with their signature
    series."""
    try:
        import urllib.request

        from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
        from torchft_tpu_torch.observability import MetricsRegistry, MetricsServer

        lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=500,
                              quorum_tick_ms=20, heartbeat_timeout_ms=2000,
                              health={"mode": "observe"})
        try:
            client = LighthouseClient(f"127.0.0.1:{lh.port}", connect_timeout=5.0)
            client.heartbeat("doctor", timeout=5.0,
                             telemetry={"step": 1, "step_s": 0.1, "wire_s": 0.01})
            with urllib.request.urlopen(f"http://127.0.0.1:{lh.port}/metrics",
                                        timeout=5.0) as resp:
                lh_series = _parse_prometheus(resp.read().decode())
        finally:
            lh.shutdown()
        if "torchft_lighthouse_fleet_size" not in lh_series:
            return False, ("lighthouse /metrics parsed but is missing "
                           f"torchft_lighthouse_fleet_size: {sorted(lh_series)[:5]}...")
        registry = MetricsRegistry()
        registry.gauge_set("torchft_doctor_probe", 1.0, "Doctor loopback.")
        server = MetricsServer(registry, port=0)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics",
                                        timeout=5.0) as resp:
                mgr_series = _parse_prometheus(resp.read().decode())
        finally:
            server.shutdown()
        if mgr_series.get("torchft_doctor_probe") != 1.0:
            return False, f"manager-side /metrics lost the probe gauge: {mgr_series}"
        return True, (f"lighthouse /metrics ({len(lh_series)} series) + manager /metrics both "
                      "parse as Prometheus text")
    except Exception as e:  # noqa: BLE001
        return False, f"/metrics probe failed: {e}"


def check_serve_env() -> Result:
    """``TORCHFT_SERVE_*`` parse into a valid ``ServeConfig`` (the plane's
    own validation); a registry named but unreachable is a warning."""
    try:
        from torchft_tpu_torch.serving import ServeConfig

        cfg = ServeConfig.from_env()
    except ValueError as e:
        return False, f"TORCHFT_SERVE_* invalid: {e}"
    if not cfg.registry:
        return True, (f"serving plane unconfigured (compress={cfg.compress}, "
                      f"max_lag={cfg.max_lag}, drain_on={cfg.drain_on}); set "
                      "TORCHFT_SERVE_REGISTRY to enable")
    import urllib.request

    try:
        with urllib.request.urlopen(f"{cfg.registry.rstrip('/')}/serve/sources",
                                    timeout=3.0) as r:
            listing = json.loads(r.read().decode())
    except Exception as e:  # noqa: BLE001 - unreachable is a warning
        return None, (f"TORCHFT_SERVE_REGISTRY={cfg.registry} unreachable ({e!r}); workers will "
                      "retry, but check the lighthouse --serve-registry flag / the registry "
                      "process")
    return True, (f"registry at {cfg.registry}: {len(listing.get('sources', []))} source(s), "
                  f"latest={listing.get('latest')}, epoch={listing.get('epoch')}")


def check_serving_roundtrip() -> Result:
    """A registry, one publisher and one worker on the host: two versions
    published, the worker lands on the newest (a full pull, then an fp8
    delta) bitwise equal to the publisher's reference."""
    import torch

    from torchft_tpu_torch.serving import (
        ServeConfig,
        ServeWorker,
        SnapshotPublisher,
        SnapshotRegistry,
    )

    registry = SnapshotRegistry()
    cfg = ServeConfig(registry=registry.url, max_lag=4, compress="fp8", poll_s=0.02,
                      timeout_s=10.0)
    publisher = SnapshotPublisher("doctor_replica", config=cfg, registry_url=registry.url)
    # the plane's wire, on the host: the card has a check of its own
    worker = ServeWorker(registry.url, config=cfg, name="doctor_worker", device="cpu")
    try:
        gen = torch.Generator().manual_seed(7)
        params = {"w": torch.randn(4096, generator=gen)}
        publisher.publish(1, 0, params)
        if not worker.wait_version((1, 0), timeout=10.0):
            return False, f"worker never reached (1, 0): counters={worker.counters}"
        params["w"] = params["w"] + 0.01
        publisher.publish(1, 1, params)
        if not worker.wait_version((1, 1), timeout=10.0):
            return False, (f"worker stuck at {worker.version} (want (1, 1)): "
                           f"counters={worker.counters}")
        if not torch.equal(worker.params_flat(), publisher.ref_flat()):
            return False, ("worker params != publisher reference after pull — the bitwise "
                           "delta/full invariant broke")
        c = worker.counters
        return True, (f"worker converged to (1, 1): {c['full_pulls_total']} full + "
                      f"{c['delta_pulls_total']} delta pull(s), {c['delta_bytes_total']}B delta "
                      f"vs {c['full_bytes_total']}B full")
    finally:
        worker.shutdown()
        publisher.shutdown()
        registry.shutdown()


def check_redundancy_env() -> Result:
    """``TORCHFT_REDUNDANCY_*`` parse into a valid ``RedundancyConfig``;
    with the plane on, the shard directory answers with enough live
    non-spare peers for k+m holders (too few is a warning: placement
    wraps)."""
    try:
        from torchft_tpu_torch.redundancy import DirectoryClient, RedundancyConfig

        cfg = RedundancyConfig.from_env()
    except ValueError as e:
        return False, f"TORCHFT_REDUNDANCY_* invalid: {e}"
    if cfg.k == 0:
        return True, ("redundancy plane off (k=0 — peer heal only); set "
                      "TORCHFT_REDUNDANCY_K/_M/_DIRECTORY to enable erasure staging")
    if not cfg.directory:
        return None, (f"TORCHFT_REDUNDANCY_K={cfg.k} but no TORCHFT_REDUNDANCY_DIRECTORY — "
                      "staging stays off; point it at the lighthouse's /redundancy endpoint")
    try:
        peers = DirectoryClient(cfg.directory, timeout=3.0).peers()
    except Exception as e:  # noqa: BLE001 - unreachable is a warning
        return None, (f"TORCHFT_REDUNDANCY_DIRECTORY={cfg.directory} unreachable ({e!r}); "
                      "stagers retry, but check the lighthouse --redundancy-directory flag / "
                      "the directory process")
    live = [p for p in peers if not p.get("spare")]
    if len(live) < cfg.k + cfg.m:
        return None, (f"k+m={cfg.k + cfg.m} but only {len(live)} live non-spare peer(s) "
                      "registered — placement wraps holders; distinct-peer durability degraded "
                      "until the fleet grows")
    return True, (f"k={cfg.k} m={cfg.m} interval={cfg.interval}, directory at {cfg.directory}: "
                  f"{len(live)} live peer(s), {len(peers) - len(live)} spare(s)")


def check_redundancy_roundtrip() -> Result:
    """Encode a state as k=2 data + m=1 parity shards on three stores,
    store one data shard corrupted, and reconstruct: crc32 must catch the
    corruption and the parity shard repair it, bitwise."""
    import torch

    from torchft_tpu_torch.checkpointing.erasure import encode_shards, shard_crc
    from torchft_tpu_torch.redundancy import (
        DirectoryClient,
        ShardDirectory,
        ShardStore,
        pack_state_blob,
        put_shard,
        reconstruct_state,
    )

    k, m = 2, 1
    directory = ShardDirectory()
    client = DirectoryClient(directory.url, timeout=5.0)
    stores = [ShardStore(f"doctor_holder_{i}") for i in range(k + m)]
    try:
        state = {"w": torch.randn(65536, generator=torch.Generator().manual_seed(11))}
        blob = pack_state_blob(state)
        shards = encode_shards(blob, k, m)
        epoch = client.register("doctor_red", "doctor", stores[0].url)
        entries = []
        for idx, body in enumerate(shards):
            body = bytes(body)
            # shard 0 stored corrupt, announced with its true crc: its GET
            # must fail verification, not decode garbage
            stored = (bytes([body[0] ^ 0xFF]) + body[1:]) if idx == 0 else body
            put_shard(stores[idx].url, "doctor_red", 1, idx, stored, timeout=5.0)
            entries.append({"idx": idx, "holder": stores[idx].replica_id,
                            "url": stores[idx].url, "crc": shard_crc(body)})
        code, resp = client.announce({
            "replica_id": "doctor_red", "epoch": epoch, "seq": 1, "step": 1,
            "k": k, "m": m, "data_len": len(blob), "shards": entries,
        })
        if code != 200:
            return False, f"directory rejected announce: {resp}"
        _, got, stats = reconstruct_state(directory.url, owner="doctor_red", timeout=30.0)
        if stats.get("shards_corrupt", 0) < 1:
            return False, ("corrupted shard was not detected — crc32 verification on the shard "
                           f"GET path regressed (stats={stats})")
        if not torch.equal(torch.as_tensor(got["w"]), state["w"]):
            return False, ("reconstructed state != original — GF(256) parity repair broke the "
                           "bitwise round-trip")
        return True, (f"k={k}+m={m} reconstruct repaired 1 corrupt shard bitwise "
                      f"({stats['shards_ok']} ok / {stats['shards_corrupt']} corrupt, "
                      f"{stats['mb_per_s']:.0f} MB/s loopback)")
    finally:
        for s in stores:
            s.shutdown()
        directory.shutdown()


def churn_burst(n: int, period_s: float, replicas: int = 4) -> List[dict]:
    """A synthetic history: ``n`` cycles, one every ``period_s`` seconds, of
    replica ``i % replicas`` leaving the quorum and the full set back half a
    period later (the reference's test helper ``churn_burst``, which the
    port does not import)."""
    full = [f"replica_{r}" for r in range(replicas)]
    events = [{"ts_ms": 0, "seq": 0, "kind": "quorum", "participants": list(full)}]
    period_ms = int(period_s * 1000.0)
    for i in range(n):
        t = (i + 1) * period_ms
        down = [p for p in full if p != full[i % replicas]]
        events.append({"ts_ms": t, "seq": 2 * i + 1, "kind": "quorum", "participants": down})
        events.append({"ts_ms": t + period_ms // 2, "seq": 2 * i + 2, "kind": "quorum",
                       "participants": list(full)})
    return events


def check_policy_env() -> Result:
    """``TORCHFT_POLICY*``: the mode is one of ``POLICY_MODES``, the numeric
    knobs parse, the spec (builtin or ``TORCHFT_POLICY_SPEC``'s file) loads
    and validates, and an observe-mode engine folds a synthetic churn burst
    into a well-formed frame, the fold and evaluate a lighthouse runs, so a
    bad spec fails here and not at the fleet's start (reference
    ``doctor.py:853-905``)."""
    from torchft_tpu_torch.policy import POLICY_MODES, PolicyEngine, PolicySpec

    mode = (knobs.env_raw("TORCHFT_POLICY") or "").strip() or "off"
    if mode not in POLICY_MODES:
        return False, f"TORCHFT_POLICY={mode!r} invalid: pick one of {'/'.join(POLICY_MODES)}"
    try:
        knobs.env_float("TORCHFT_POLICY_INTERVAL_S", 5.0)
        window_s = knobs.env_float("TORCHFT_POLICY_WINDOW_S", 300.0)
        knobs.env_int("TORCHFT_POLICY_RING", 4096)
        knobs.env_int("TORCHFT_SYNC_EVERY", 0)
    except ValueError as e:
        return False, f"TORCHFT_POLICY_* numeric knob invalid: {e}"
    spec_src = (knobs.env_raw("TORCHFT_POLICY_SPEC") or "").strip() or "builtin"
    try:
        spec = PolicySpec.load(spec_src)
    except (ValueError, OSError, KeyError) as e:
        return False, f"policy spec {spec_src!r} failed to load: {e}"
    try:
        engine = PolicyEngine(spec, mode="observe", window_s=window_s)
        engine.feed(churn_burst(8, period_s=5.0))
        frame = engine.evaluate()
        if "policy_seq" not in frame:
            raise ValueError(f"malformed frame: {frame!r}")
    except Exception as e:  # noqa: BLE001 - the probe's failure is the finding
        return False, f"observe probe failed on spec {spec_src!r}: {e}"
    if mode == "off":
        return True, (f"policy off (byte-identical path); spec {spec_src!r} validates "
                      f"({len(spec.rules)} rule(s)) and probes clean")
    return True, (f"policy {mode}: spec {spec_src!r} ({len(spec.rules)} rule(s)) probed clean, "
                  f"frame seq={frame['policy_seq']}")


def check_tuning_env() -> Result:
    """Every knob whose registry entry names this check parses as its
    declared type (JSON knobs decode to objects, enums name a member):
    the rollout typo (``TORCHFT_BUCKET_CAP_MB=32mb``) fails here instead of
    falling back silently."""
    checked = 0
    n_set = 0
    problems: List[str] = []
    for name, knob in sorted(knobs.all_knobs().items()):
        if knob.doctor != "tuning-env":
            continue
        raw = knobs.env_raw(name)
        checked += 1
        if raw is None or raw.strip() == "":
            continue
        n_set += 1
        try:
            if knob.type == "int":
                int(raw)
            elif knob.type == "float":
                float(raw)
            elif knob.type == "bool":
                if raw.strip().lower() not in ("0", "1", "true", "false", "yes", "no", "on", "off"):
                    raise ValueError(f"not a boolean: {raw!r}")
            elif knob.type.startswith("enum("):
                members = knob.type[5:-1].split("|")
                if raw not in members:
                    raise ValueError(f"{raw!r} not in {members}")
            elif name.endswith("_JSON"):
                if not isinstance(json.loads(raw), dict):
                    raise ValueError("must decode to a JSON object")
        except ValueError as e:
            problems.append(f"{name}={raw!r} ({e})")
    if problems:
        return False, "; ".join(problems)
    return True, f"{checked} tuning knob(s) registered, {n_set} set, all parse"


def check_fleetlint() -> Result:
    """In-process fleetlint env-contract run: every TORCHFT_* read in the
    package is registered, in the README's knob table and doctored, and
    nothing is found beyond the committed baseline
    (``torchft_tpu_torch/analysis/baseline.json``). The five-checker run is
    ``python -m torchft_tpu_torch.analysis --ci``; the env contract is the
    part that drifts with the operator-facing surface, so the doctor checks
    it again on any host. Stale baseline entries warn."""
    from torchft_tpu_torch.analysis import core

    findings = core.run_all(checkers=["env-contract"])
    baseline = core.load_baseline()
    new, stale = core.diff_baseline(findings, baseline)
    if new:
        head = "; ".join(f"{f.rule}:{f.key}" for f in new[:5])
        more = f" (+{len(new) - 5} more)" if len(new) > 5 else ""
        return False, (f"{len(new)} env-contract finding(s) beyond baseline: {head}{more} "
                       "— run python -m torchft_tpu_torch.analysis")
    detail = f"{len(findings)} finding(s), all baselined" if findings else "env contract clean"
    if stale:
        return None, f"{detail}; {len(stale)} stale baseline entr(y/ies)"
    return True, detail


CHECKS: List[Tuple[str, Callable[[], Result]]] = [
    ("native", check_native),
    ("accelerator", check_accelerator),
    ("virtual-mesh", check_virtual_mesh),
    ("lighthouse", check_lighthouse_roundtrip),
    ("aggregator", check_aggregator),
    ("retry-env", check_retry_env),
    ("health-env", check_health_env),
    ("compress-env", check_compress_env),
    ("serve-env", check_serve_env),
    ("redundancy-env", check_redundancy_env),
    ("trace-env", check_trace_env),
    ("policy-env", check_policy_env),
    ("tuning-env", check_tuning_env),
    ("fleetlint", check_fleetlint),
    ("health-http", check_health_endpoint),
    ("metrics-http", check_metrics_endpoints),
    ("heal", check_heal_roundtrip),
    ("serving", check_serving_roundtrip),
    ("redundancy", check_redundancy_roundtrip),
]


def run_check(fn: Callable[[], Result]) -> Result:
    """A check's result; a check that raises fails."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - a crashing check is a failure
        return False, f"check crashed: {e}"


def main() -> None:
    failed = False
    for name, fn in CHECKS:
        status, detail = run_check(fn)
        tag = {True: "ok  ", None: "warn", False: "FAIL"}[status]
        print(f"{tag} {name:<14} {detail}", flush=True)
        failed |= status is False
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
