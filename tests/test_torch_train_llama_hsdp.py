"""The counterpart of ``examples/train_llama_hsdp.py`` against the
reference, on the CPU.

A fault-free run: one replica group of ``fsdp 2 x tp 2`` rank processes
(gloo; this file run as a script, one process a rank) trains the debug
config 3 steps from the reference's ``llama_init`` weights on the
reference's batches (``np.random.RandomState(replica_id)``), and its losses
and final gathered parameters equal the reference's jitted ``grad_step`` /
``update_step`` (``optax.adamw(lr, weight_decay=0.1)``) on the same mesh
of conftest's virtual CPU devices, within rtol 1e-4 / atol 1e-5. The
learning rate is the example's default, 3e-4: AdamW moves a weight whose
gradient is near its eps by up to lr on any rounding of that gradient, so
at 3e-3 one weight of 8,192 ends 1.3e-5 from the reference's.

The demo: ``--demo --device cpu`` starts the lighthouse CLI and two groups
of ``fsdp 2`` rank processes, SIGKILLs every rank of group 1 after its
step-2 line and restarts it; it exits 0 only when every rank of the group
healed (over HTTP, or over PG into its live shards) and the groups'
digests of the gathered model (under ``--diloco``: each rank's fragment
state) agree.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
STEPS, B, S, LR = 3, 2, 16, 3e-4


def _worker(tmp: str) -> None:
    """One rank: the example's train() from the payload's init."""
    from torchft_tpu_torch.examples import train_llama_hsdp as ex

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(tmp, "payload.pt"))
    args = ex.parse_args(payload["argv"])
    out = ex.train(args, init_state=payload["init"], keep_params=True)
    torch.save(out, os.path.join(tmp, f"out_{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_parallel import ATOL, REPO, RTOL, spawn_world  # noqa: E402

from torchft_tpu.models import llama as jl  # noqa: E402
from torchft_tpu.parallel import mesh as jmesh  # noqa: E402
from torchft_tpu.parallel.ring_attention import make_ring_attention_fn  # noqa: E402
from torchft_tpu_torch import convert  # noqa: E402
from torchft_tpu_torch.coordination import LighthouseServer  # noqa: E402


def _reference(params, layout, opt=None, seeds=(0,), steps=STEPS):
    """The reference example's DDP step (``:74-90``, ``:239-257``) without
    the Manager, for one group a seed: each draws its batches from
    ``np.random.RandomState(seed)`` and the allreduce averages the groups'
    gradients (one group: the identity). ``opt`` is AdamW's ``(count, mu,
    nu)`` to start from (a restored state), else its init. Returns each
    group's losses and the final parameters."""
    cfg = jl.CONFIGS["debug"]
    mesh = jmesh.make_hsdp_mesh(dp=1, **layout)
    params = jmesh.shard_params(params, mesh, jmesh.llama_param_specs(cfg))
    fn = make_ring_attention_fn(mesh)
    tok_sharding = jmesh.batch_sharding(mesh)
    tx = optax.adamw(LR, weight_decay=0.1)
    opt_state = tx.init(params)
    if opt is not None:
        count, mu, nu = opt
        adam = opt_state[0]._replace(count=jnp.asarray(count, opt_state[0].count.dtype),
                                     mu=jax.tree_util.tree_map(jnp.asarray, mu),
                                     nu=jax.tree_util.tree_map(jnp.asarray, nu))
        opt_state = (adam, *opt_state[1:])

    @jax.jit
    def grad_step(params, tokens, targets):
        return jax.value_and_grad(jl.llama_loss)(params, tokens, targets, cfg,
                                                 attention_fn=fn, remat="full")

    @jax.jit
    def update_step(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    rngs = [np.random.RandomState(seed) for seed in seeds]
    losses = [[] for _ in seeds]
    for _ in range(steps):
        every = []
        for g, rng in enumerate(rngs):
            batch = jax.device_put(jnp.asarray(rng.randint(0, cfg.vocab_size, size=(B, S))),
                                   tok_sharding)
            loss, grads = grad_step(params, batch, batch)
            losses[g].append(float(loss))
            every.append(grads)
        grads = jax.tree_util.tree_map(lambda *gs: sum(gs) / len(gs), *every)
        params, opt_state = update_step(params, opt_state, grads)
    return losses, jax.tree_util.tree_map(np.asarray, params)


def test_fault_free_run_matches_the_reference(tmp_path):
    layout = dict(fsdp=2, tp=2)
    init = jax.tree_util.tree_map(
        np.asarray, jl.llama_init(jax.random.PRNGKey(0), jl.CONFIGS["debug"]))
    lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                                  quorum_tick_ms=20, heartbeat_timeout_ms=5000)
    try:
        outs = spawn_world(HERE, 4, {
            "argv": ["--config", "debug", "--steps", str(STEPS), "--batch-size", str(B),
                     "--seq-len", str(S), "--lr", str(LR), "--fsdp", "2", "--tp", "2",
                     "--device", "cpu", "--lighthouse", f"127.0.0.1:{lighthouse.port}"],
            "init": convert.llama_params_from_jax(init),
        }, tmp_path)
    finally:
        lighthouse.shutdown()
    (ref_losses,), ref_params = _reference(init, layout)
    for out in outs:
        assert out["step"] == STEPS and out["metrics"]["commits"] == STEPS
        assert out["storage_kept"]
        np.testing.assert_allclose(out["losses"], ref_losses, rtol=RTOL, atol=ATOL)
    ref = convert.llama_params_from_jax(ref_params)
    got = outs[0]["params"]
    assert sorted(got) == sorted(ref)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert len({out["group_sha256"] for out in outs if out["group_sha256"]}) == 1


@pytest.mark.parametrize("extra", [
    pytest.param(["--transport", "http"], id="http"),
    pytest.param(["--transport", "pg"], id="pg"),
    pytest.param(["--transport", "pg", "--diloco", "--quantize", "--sync-every", "4",
                  "--steps", "12"], id="pg_diloco"),
])
def test_demo_kills_a_group_and_it_heals_rank_by_rank(extra):
    """Under DiLoCo (inner steps counted, one of two fragments synced every
    2 inner steps) the demo holds each rank's fragment state equal across
    the groups instead of the whole model."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    # at a lower priority, as spawn_world's ranks
    out = subprocess.run(
        ["nice", "-n", "19", sys.executable, "-m", "torchft_tpu_torch.examples.train_llama_hsdp",
         "--demo",
         "--device", "cpu", "--config", "debug", "--steps", "6", "--batch-size", "2",
         "--seq-len", "16", "--kill-at-step", "2", "--timeout", "30", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    log = out.stdout + out.stderr
    assert out.returncode == 0, log[-6000:]
    assert "--- killing every rank of replica 1 ---" in log
    assert "heal of every rank of replica 1: True" in log
    # the restarted group joined mid-run: its first step line is at the
    # kill's step or later (DiLoCo's outer step may not have moved yet)
    restarted = log.split("--- restarting replica 1 ---", 1)[1]
    first = next(line for line in restarted.splitlines()
                 if line.startswith("replica 1 rank 0: [replica 1 rank 0] step="))
    assert int(first.split("step=", 1)[1].split()[0]) >= 2
    if "pg" in extra:
        dones = [line for line in restarted.splitlines() if "[replica 1 rank" in line
                 and "] done: " in line]
        assert len(dones) == 2 and all('"storage_kept": true' in d for d in dones)


def _local_state(ckpt_dir: str, group: int, step: int, ranks: int = 2):
    """A group's durable step: every rank's local shards, joined into full
    tensors along the dimension each is sharded on (the model's
    ``param_specs``); and the Manager's state."""
    from torchft_tpu_torch.checkpointing import DurableCheckpointer
    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    shapes = {n: p.shape for n, p in Llama(CONFIGS["debug"], device="meta").named_parameters()}
    parts = [DurableCheckpointer(os.path.join(ckpt_dir, f"replica_{group}"), group_rank=r,
                                 group_world_size=ranks).restore(step=step) for r in range(ranks)]
    users = [p[0]["default"] for p in parts]

    def join(name, shards):
        dims = [i for i, (a, b) in enumerate(zip(shards[0].shape, shapes[name])) if a != b]
        return torch.cat(shards, dim=dims[0]) if dims else shards[0]

    full = {n: join(n, [u["params"][n] for u in users]) for n in users[0]["params"]}
    moments = {k: {n: join(n, [u["opt_state"][n][k] for u in users]) for n in full}
               for k in ("exp_avg", "exp_avg_sq")}
    count = {float(u["opt_state"][n]["step"]) for u in users for n in full}
    return full, moments, count, parts[0][1]


def _to_jax_tree(full):
    """The port's state dict -> the reference's stacked Llama tree."""
    tree, layers = {}, {}
    for name, t in full.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            layers.setdefault(leaf, {})[int(i)] = t.numpy()
        else:
            tree[name] = t.numpy()
    tree["layers"] = {leaf: np.stack([by[i] for i in sorted(by)]) for leaf, by in layers.items()}
    return tree


def test_whole_job_outage_under_the_launcher_resumes_from_the_landed_step(tmp_path):
    """``--outage-demo``: the lighthouse CLI, the aggregator's CLI, the
    launcher over two groups of ``fsdp 2`` ranks with durable checkpoints
    every 3 steps; the punisher kills group 1 after its step-1 line (it
    heals in place over PG), then every group once both landed step 3 (a
    whole-job outage: the launcher restarts both and each rank restores the
    newest step it landed, with its digest), and the aggregator dies after the
    first commit that follows. The demo's gates pass; the resumed run's
    losses and its final parameters equal the reference's jitted steps from
    the restored state on the batches each restarted group draws, within
    rtol 1e-4 / atol 1e-5."""
    ckpt = str(tmp_path / "ckpt")
    steps, every = 9, 3
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        ["nice", "-n", "19", sys.executable, "-m", "torchft_tpu_torch.examples.train_llama_hsdp",
         "--outage-demo", "--device", "cpu", "--config", "debug", "--steps", str(steps),
         "--batch-size", str(B), "--seq-len", str(S), "--lr", str(LR), "--kill-at-step", "1",
         "--transport", "pg", "--ckpt-dir", ckpt, "--ckpt-every", str(every),
         "--timeout", "30"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    log = out.stdout + out.stderr
    assert out.returncode == 0, log[-8000:]
    summary = json.loads(log.split("outage demo summary: ", 1)[1].splitlines()[0])
    assert summary["failures"] == [] and summary["restarts"] == {"0": 1, "1": 2}
    # each rank restored the newest step it landed before the outage (step
    # 3, or 6 when step 3 landed late and step 6's save followed it)
    restored = {rec["step"] for rec in summary["restored"].values()}
    assert len(restored) == 1 and restored <= {"3", "6"}, summary["restored"]
    for key, rec in summary["restored"].items():
        assert (rec["step"], rec["sha256"]) == (summary["landed"][key]["step"],
                                                summary["landed"][key]["sha256"])
    assert len(summary["group_sha256"]) == 1
    at = int(restored.pop())

    # the restored state: both groups saved the same step
    states = [_local_state(ckpt, g, at) for g in (0, 1)]
    for name, t in states[0][0].items():
        assert torch.equal(t, states[1][0][name]), name
    full, moments, count, manager_sd = states[0]
    assert count == {float(at)} and manager_sd["step"] == at
    (l0, l1), ref_params = _reference(
        _to_jax_tree(full), dict(fsdp=2),
        opt=(at, _to_jax_tree(moments["exp_avg"]), _to_jax_tree(moments["exp_avg_sq"])),
        seeds=(0, 1), steps=steps - at)
    for g, ref_losses in ((0, l0), (1, l1)):
        got = summary["done"][f"{g}/0"]["losses"]
        np.testing.assert_allclose(got, ref_losses, rtol=RTOL, atol=ATOL)
    final, _, _, final_sd = _local_state(ckpt, 0, steps)
    assert final_sd["step"] == steps
    ref = convert.llama_params_from_jax(ref_params)
    assert sorted(final) == sorted(ref)
    for name, p in final.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
