"""The port's HSDP plane (``torchft_tpu_torch.parallel``) against the JAX
package's, on the CPU.

The reference runs in this process on conftest's 8 virtual CPU devices: a
single-controller mesh, ``jax.value_and_grad(llama_loss)`` under it with
the ring or Ulysses ``attention_fn``. The port runs the same layout as a
world of rank processes over gloo (this file run as a script, one process
a rank, on a rendezvous store of its own bound to port 0): FSDP2 and tensor
parallelism by ``apply_hsdp``, the sequence split by ``shard_batch``. The
weights are the reference's ``llama_init`` through
``convert.llama_params_from_jax`` and the tokens the same numpy draws. At
the debug config (f32) the loss and the gathered full gradients agree
within rtol 1e-4 / atol 1e-5, the bar of ``tests/test_torch_llama.py``.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-4, 1e-5
WORLD_TIMEOUT_S = 120.0
HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def spawn_world(script: str, world: int, payload: dict, tmp_path) -> list:
    """Run ``script`` (a test file in its worker mode) as ``world`` rank
    processes, torchrun's variables set, on a rendezvous store bound to
    port 0; each reads ``payload`` and writes its result, which this
    returns in rank order. A world that outlives ``WORLD_TIMEOUT_S`` is
    killed and fails the test. The ranks run at a lower priority (``nice``),
    so the timing-sensitive tests of parallel workers keep their CPU."""
    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    tmp = str(tmp_path)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
               WORLD_SIZE=str(world), TORCHELASTIC_USE_AGENT_STORE="True", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(["nice", "-n", "19", sys.executable, script, tmp], cwd=REPO,
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return [torch.load(os.path.join(tmp, f"out_{r}.pt")) for r in range(world)]


def _worker(tmp: str) -> None:
    """One rank: the port's loss and gathered full gradients under the
    payload's layout and attention."""
    import torch.distributed as dist

    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.parallel import (
        apply_hsdp,
        make_hsdp_mesh,
        make_ring_attention_fn,
        make_ulysses_attention_fn,
        shard_batch,
        ulysses_attention,
    )
    from torchft_tpu_torch.parallel.mesh import group_mean

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(tmp, "payload.pt"))
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    mesh = make_hsdp_mesh(device_type="cpu", **payload["layout"])
    fn = (make_ulysses_attention_fn if payload["attention"] == "ulysses"
          else make_ring_attention_fn)(mesh)
    model = Llama(CONFIGS["debug"], device="cpu", attention_fn=fn, remat=True)
    model.load_state_dict(payload["init"])
    apply_hsdp(model, mesh)
    tokens, offset = shard_batch(payload["tokens"], mesh)
    targets, _ = shard_batch(payload["targets"], mesh)
    loss = model.loss(tokens, targets, offset=offset)
    loss.backward()
    out = {"loss": float(group_mean(loss.detach())),
           "grads": {n: p.grad.full_tensor() for n, p in model.named_parameters()}}
    if payload["attention"] == "ulysses":
        # 3 query heads, 1 KV head: sp 2 divides neither
        q, kv = torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 1, 8)
        try:
            ulysses_attention(q, kv, kv, None, mesh["sp"].get_group())
        except ValueError as e:
            out["ulysses_error"] = str(e)
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torchft_tpu.models import llama as jl  # noqa: E402
from torchft_tpu.parallel import mesh as jmesh  # noqa: E402
from torchft_tpu.parallel.ring_attention import make_ring_attention_fn as j_ring  # noqa: E402
from torchft_tpu.parallel.ulysses import make_ulysses_attention_fn as j_ulysses  # noqa: E402
from torchft_tpu.parallel.ulysses import ulysses_attention as j_ulysses_attention  # noqa: E402
from torchft_tpu_torch import convert  # noqa: E402
from torchft_tpu_torch.models import llama as tl  # noqa: E402
from torchft_tpu_torch.parallel import mesh as tmesh  # noqa: E402

B, S = 2, 16


def _inputs():
    cfg = jl.CONFIGS["debug"]
    params = jax.tree_util.tree_map(np.asarray, jl.llama_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, params, tokens, targets


def _reference(layout: dict, attention: str):
    """The reference's loss and gradients under its own mesh of the same
    layout, in the port's per-layer names."""
    cfg, params, tokens, targets = _inputs()
    mesh = jmesh.make_hsdp_mesh(dp=1, **layout)
    sharded = jmesh.shard_params(params, mesh, jmesh.llama_param_specs(cfg))
    fn = (j_ulysses if attention == "ulysses" else j_ring)(mesh)
    tok_sharding = jmesh.batch_sharding(mesh)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t, y: jl.llama_loss(p, t, y, cfg, attention_fn=fn, remat="full")))
    loss, grads = grad_fn(sharded, jax.device_put(jnp.asarray(tokens), tok_sharding),
                          jax.device_put(jnp.asarray(targets), tok_sharding))
    host = jax.tree_util.tree_map(np.asarray, grads)
    return float(loss), {k: v.numpy() for k, v in convert.llama_params_from_jax(host).items()}


LAYOUTS = [
    pytest.param(dict(fsdp=2, tp=2), "ring", id="fsdp2_tp2_ring"),
    pytest.param(dict(sp=2), "ring", id="sp2_ring"),
    pytest.param(dict(sp=2), "ulysses", id="sp2_ulysses"),
    pytest.param(dict(fsdp=2, sp=2), "ring", id="fsdp2_sp2_ring"),
]


@pytest.mark.parametrize("layout,attention", LAYOUTS)
def test_sharded_loss_and_grads_match_the_reference(layout, attention, tmp_path):
    """Loss and gathered full gradients of the port's sharded Llama equal
    the reference's under the same mesh. With ``sp`` FSDP's reduce-scatter
    over the flattened ``(fsdp, sp)`` dims sums the sequence shards'
    gradients; ring attention's KV rotation carries theirs back."""
    _, params, tokens, targets = _inputs()
    world = int(np.prod(list(layout.values())))
    outs = spawn_world(HERE, world, {
        "layout": layout, "attention": attention,
        "init": convert.llama_params_from_jax(params),
        "tokens": torch.from_numpy(tokens).long(), "targets": torch.from_numpy(targets).long(),
    }, tmp_path)
    ref_loss, ref_grads = _reference(layout, attention)
    for out in outs:
        np.testing.assert_allclose(out["loss"], ref_loss, rtol=RTOL, atol=ATOL)
    grads = outs[0]["grads"]
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for out in outs[1:]:
        for name, g in out["grads"].items():
            assert torch.equal(g, grads[name]), name
    if attention == "ulysses":
        # the reference's message, raised where the reference raises it
        q, kv = jnp.zeros((1, 4, 3, 8)), jnp.zeros((1, 4, 1, 8))
        with pytest.raises(ValueError) as ref_err:
            jax.vmap(lambda a, b, c: j_ulysses_attention(a, b, c, None),
                     axis_name="sp", axis_size=2)(
                jnp.stack([q, q]), jnp.stack([kv, kv]), jnp.stack([kv, kv]))
        assert all(out["ulysses_error"] == str(ref_err.value) for out in outs)


@pytest.mark.parametrize("offset", [0, 8])
def test_rope_with_an_offset_matches_the_reference(offset):
    """A sequence shard at ``offset`` rotates by its global positions."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 4, 16).astype(np.float32)
    positions = np.broadcast_to(np.arange(offset, offset + 8), (2, 8))
    ref = np.asarray(jl._rope(jnp.asarray(x), 10000.0, jnp.asarray(positions)))
    got = tl._rope(torch.from_numpy(x), 10000.0, torch.arange(offset, offset + 8))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    got_b = tl._rope(torch.from_numpy(x), 10000.0, torch.from_numpy(positions.copy()))
    assert torch.equal(got_b, got)


def test_a_shard_at_its_offset_computes_its_slice_of_the_whole_sequence():
    """Without attention across shards (an attention_fn that passes v
    through), the layer is position-wise: the shard's output at offset 8
    is the whole sequence's output there, RoPE included."""
    cfg = jl.CONFIGS["debug"]
    params = jax.tree_util.tree_map(np.asarray, jl.llama_init(jax.random.PRNGKey(1), cfg))
    def passthrough(q, k, v, cfg):
        return v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)

    model = tl.Llama(tl.CONFIGS["debug"], device="cpu", attention_fn=passthrough)
    model.load_state_dict(convert.llama_params_from_jax(params))
    tokens = torch.from_numpy(np.random.RandomState(4).randint(0, 256, (1, 16))).long()
    with torch.no_grad():
        whole = model(tokens)
        tail = model(tokens[:, 8:], offset=8)
    torch.testing.assert_close(tail, whole[:, 8:], rtol=RTOL, atol=ATOL)


def test_an_attention_fn_replaces_the_default_as_the_reference():
    """``Llama(attention_fn=...)`` runs the given attention in every layer,
    as ``llama_loss(attention_fn=...)`` does: the reference's plain
    attention passed as a function gives the reference's loss."""
    cfg, params, tokens, targets = _inputs()
    calls = []

    def fn(q, k, v, c):
        calls.append(q.shape)
        from torchft_tpu_torch.ops.attention import causal_attention

        return causal_attention(q, k, v, c, impl="xla")

    model = tl.Llama(tl.CONFIGS["debug"], device="cpu", attention_fn=fn)
    model.load_state_dict(convert.llama_params_from_jax(params))
    loss = model.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    ref = jl.llama_loss(params, jnp.asarray(tokens), jnp.asarray(targets), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=RTOL, atol=ATOL)
    assert len(calls) == cfg.n_layers and calls[0] == (B, S, cfg.n_heads, cfg.head_dim)


def test_param_specs_are_the_reference_table():
    """Per parameter, the mesh axis each dim of the port's per-layer
    ``[in, out]`` weight is sharded over is the reference's for the same
    dims of its stacked ``[L, in, out]`` array."""
    from torch.distributed.tensor import Shard

    ref = jmesh.llama_param_specs(jl.CONFIGS["debug"])
    got = tmesh.llama_param_specs(tl.CONFIGS["debug"])

    def axes(spec: dict, ndim: int) -> list:
        out = [None] * ndim
        for axis, placement in spec.items():
            if isinstance(placement, Shard):
                out[placement.dim] = axis
        return out

    for name in ("embed", "final_norm", "lm_head"):
        assert axes(got[name], len(ref[name])) == list(ref[name])
    assert sorted(got["layers"]) == sorted(ref["layers"])
    for name, spec in ref["layers"].items():
        assert [None] + axes(got["layers"][name], len(spec) - 1) == list(spec), name


def test_shard_batch_keeps_each_ranks_slice_and_offset():
    """Rows over fsdp, the sequence over sp, as ``batch_sharding``."""

    class FakeMesh:
        def __init__(self, sizes, ranks):
            self.sizes, self.ranks = sizes, ranks

        def __getitem__(self, axis):
            size = self.sizes[axis]
            return type("Axis", (), {"size": lambda self: size})()

        def get_local_rank(self, axis):
            return self.ranks[axis]

    tokens = torch.arange(4 * 8).reshape(4, 8)
    for i in range(2):
        for j in range(2):
            got, offset = tmesh.shard_batch(tokens, FakeMesh({"fsdp": 2, "sp": 2},
                                                             {"fsdp": i, "sp": j}))
            assert torch.equal(got, tokens[2 * i:2 * i + 2, 4 * j:4 * j + 4]) and offset == 4 * j
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(tokens[:3], FakeMesh({"fsdp": 2, "sp": 1}, {"fsdp": 0, "sp": 0}))
