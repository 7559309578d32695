"""The step at which a straggler is readmitted, in the JAX package and in
the port, under the same health knobs.

Runs each package's fleet scenario (``TestFleetIntegration``'s
``_run_fleet`` of ``tests/test_healthwatch.py`` and
``tests/test_torch_healthwatch.py``: three replica threads, replica 2
reporting 10x its step time until ejected) ``--runs`` times with the
trainer's health knobs of
``test_trainer_slow_replica_is_ejected_readmitted_and_heals``
(``min_samples`` 3, ``eject_steps`` 2, ``probation_ms`` 1000,
``probe_ok`` 2) and prints, per run, one JSON line:

- ``eject_step``: the peers' step when the lighthouse first excluded the
  straggler;
- ``rejoin_step``: the step of the straggler's heal on readmission (the
  first vote of a quorum that healed it after its ejection);
- ``seen_step``: the first of its votes whose ``timings()`` counted the
  readmission, and ``votes_late``, how many of its votes came before it.

Run from the repo root: ``JAX_PLATFORMS=cpu python tests/readmission_steps.py
--runs 5``.
"""

import argparse
import json
import os
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from torchft_tpu.utils import force_virtual_cpu_devices  # noqa: E402

force_virtual_cpu_devices(8)

KNOBS = {"min_samples": 3, "eject_steps": 2, "probation_ms": 1000, "probe_ok": 2}


def run_once(pkg: str) -> dict:
    if pkg == "jax":
        import test_healthwatch as mod
        from torchft_tpu.manager import Manager
    else:
        import test_torch_healthwatch as mod
        from torchft_tpu_torch.manager import Manager
    straggler = 2
    votes = []
    lock = threading.Lock()
    orig = Manager.should_commit

    def should_commit(self, *args, **kwargs):
        ok = orig(self, *args, **kwargs)
        if self._replica_id.startswith(f"hw_{straggler}:"):
            t = self.timings()
            with lock:
                votes.append((self.current_step(), ok, t["ejections"], t["readmissions"],
                              self.last_quorum_healed()))
        return ok

    observed = {}

    def on_tick(client, dilation, step_log):
        try:
            payload = client.health(timeout=2.0)
        except Exception:  # noqa: BLE001 - the poll races the teardown
            return
        if payload.get("excluded") and "eject_step" not in observed:
            observed["eject_step"] = max(len(step_log[0]), len(step_log[1]))
            if hasattr(dilation, "clear_slow_replica"):
                dilation.clear_slow_replica(straggler)
            else:
                dilation.clear(straggler)

    Manager.should_commit = should_commit
    try:
        mod._run_fleet(dict(mod.HEALTH_OPTS, **KNOBS), target=25, straggler=straggler,
                       on_tick=on_tick)
    finally:
        Manager.should_commit = orig
    # its heal on readmission: the first healed vote after its ejection
    # reached its timings (the init-sync heal of step 0 comes before)
    first_out = next((i for i, v in enumerate(votes) if v[2] >= 1.0), len(votes))
    rejoin = next((i for i in range(first_out, len(votes)) if votes[i][4]), None)
    seen = next((i for i in range(first_out, len(votes)) if votes[i][3] >= 1.0), None)
    return {
        "package": pkg,
        "eject_step": observed.get("eject_step"),
        "rejoin_step": votes[rejoin][0] if rejoin is not None else None,
        "seen_step": votes[seen][0] if seen is not None else None,
        "votes_late": (seen - rejoin) if None not in (seen, rejoin) else None,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    for _ in range(args.runs):
        for pkg in ("jax", "torch"):
            print(json.dumps(run_once(pkg)), flush=True)


if __name__ == "__main__":
    main()
