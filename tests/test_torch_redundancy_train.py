"""The trainer's side of the redundancy plane (``torchft_tpu_torch/train.py``):
the shard fault kinds against the reference's ``EventInjector``, the CLI
flags, and two scripted heals on the debug Llama, three replica threads,
k 2 m 1, retain 1:

* a torn pull of a data shard (``kill_shard_source``, once): the
  rejoiner's pull resumes from its last byte and the reconstruct still
  heals (through parity: the crashed replica held the other data shard);
* a parity shard served corrupt on every serve (``corrupt_shard``): with
  a data shard gone too, fewer than k shards survive, so the reconstruct
  fails, counts ``reconstruct_failures`` and the heal falls back to the
  HTTP pull, as the reference's Manager does (``manager.py:1365-1380``).

Either way the replicas end bitwise equal with no error.
"""

from __future__ import annotations

import pytest
import torch

from torchft_tpu._test.event_injector import EventInjector
from torchft_tpu_torch import train
from torchft_tpu_torch.train import Fault, TrainConfig, _FaultScript, run_replicas


@pytest.fixture(autouse=True)
def _no_plane_env(monkeypatch):
    for env in ("TORCHFT_REDUNDANCY_K", "TORCHFT_REDUNDANCY_M", "TORCHFT_REDUNDANCY_DIRECTORY"):
        monkeypatch.delenv(env, raising=False)


EVENTS = [("shard_get", {"owner": f"replica_{o}:abc", "idx": i, "holder": "h"})
          for o in (0, 1) for i in (0, 1, 2)] * 3 + [("shard_put", {"owner": "replica_0:abc",
                                                                   "idx": 0, "holder": "h"})]


@pytest.mark.parametrize("fault,arm", [
    (Fault(0, 0, "corrupt_shard", shard=1, times=2), lambda ei: ei.corrupt_shard("replica_0", 1, 2)),
    (Fault(1, 0, "corrupt_shard", owner=0, shard=2, times=-1),
     lambda ei: ei.corrupt_shard("replica_0", 2, -1)),
    (Fault(0, 0, "kill_shard_source", owner=1, times=1),
     lambda ei: ei.kill_shard_source("replica_1", None, 1)),
    (Fault(0, 0, "kill_shard_source", shard=0, times=-1),
     lambda ei: ei.kill_shard_source("replica_0", 0)),
])
def test_shard_faults_serve_as_the_reference_event_injector(fault, arm):
    """The same serves get the same verdicts from the trainer's fault
    script and from the reference's EventInjector."""
    script = _FaultScript((fault,))
    script.check(fault.replica, 0, "start", transport=None)
    injector = EventInjector()
    arm(injector)
    try:
        ours = [script._shard_hook(event, info) for event, info in EVENTS]
        theirs = [injector._redundancy_fault_hook(event, info) for event, info in EVENTS]
    finally:
        script.close()
        injector.clear_redundancy_faults()
    assert ours == theirs and any(v is not None for v in ours)


def test_cli_takes_the_plane_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(train, "run_replicas", lambda cfg, device, on_step: seen.setdefault(
        "cfg", cfg) and [])
    train.main(["--config", "debug", "--redundancy", "2,1", "--redundancy-interval", "2",
                "--redundancy-retain", "1", "--spares", "1", "--replicas", "3"])
    cfg = seen["cfg"]
    assert (cfg.redundancy, cfg.redundancy_interval, cfg.redundancy_retain, cfg.spares,
            cfg.replicas) == ((2, 1), 2, 1, 1, 3)
    with pytest.raises(SystemExit):
        train.main(["--config", "debug", "--redundancy", "two"])
    with pytest.raises(ValueError, match="redundancy"):
        run_replicas(TrainConfig(config="debug", spares=1), "cpu")


@pytest.mark.parametrize("shard_fault,healed_by_reconstruct", [
    (Fault(0, 3, "kill_shard_source", owner=0, shard=0, times=1), True),
    (Fault(0, 3, "corrupt_shard", owner=0, shard=2, times=-1), False),
], ids=["torn_pull_resumes", "corrupt_parity_falls_back"])
def test_trainer_heal_through_shard_faults(shard_fault, healed_by_reconstruct):
    # replica 0's generation is the one the rejoin picks (the first live
    # owner by id); replica 1 holds its data shard 0 and its parity,
    # replica 2 (crashing) its data shard 1
    cfg = TrainConfig(config="debug", seq_len=16, steps=5, replicas=3, redundancy=(2, 1),
                      redundancy_retain=1, http_timeout=4.0,
                      faults=(shard_fault, Fault(2, 3, "crash")))
    results = run_replicas(cfg, "cpu")
    assert all(r["step"] == cfg.steps and r["metrics"]["errors"] == 0 for r in results)
    for r in results[1:]:
        for name, p in results[0]["params"].items():
            assert torch.equal(p, r["params"][name]), name
    rejoined = results[2]
    assert rejoined["restarts"] == 1 and rejoined["metrics"]["heals"] >= 1
    last = rejoined["last_incarnation"]
    if healed_by_reconstruct:
        assert (last["reconstructs"], last["reconstruct_failures"]) == (1, 0)
        assert rejoined["redundancy"]["reconstruct_shards_ok"] == 2
    else:
        assert (last["reconstructs"], last["reconstruct_failures"]) == (0, 1)
        assert rejoined["timings"]["shard_corrupt"] >= 1
