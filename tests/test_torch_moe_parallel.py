"""Expert parallelism of the port's MoE against the JAX package's, on the CPU.

As ``tests/test_torch_parallel.py``: the reference runs in this process on
conftest's 8 virtual CPU devices (``moe_loss`` jitted under its mesh, the
parameters placed by ``moe_param_specs``, the batch over ``(dp, fsdp)``),
the port as a world of gloo rank processes (this file run as a script)
sharded by ``apply_hsdp``. The capacity factor makes experts overflow, so
the drops must be the global batch's: with ``fsdp 2`` each rank routes its
half of the batch by every rank's choices. The loss and the gathered full
gradients (experts gathered over ``ep``) agree with the reference's on its
mesh and with the unsharded reference within rtol 1e-4 / atol 1e-5.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-4, 1e-5
HERE = os.path.abspath(__file__)
# overflows every layer's experts at the test's batch
CAPACITY_FACTOR = 0.5
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def _worker(tmp: str) -> None:
    """One rank: the port's loss, dropped share and gathered full
    gradients under the payload's layout."""
    import torch.distributed as dist

    from torchft_tpu_torch.models.moe import MOE_CONFIGS, MoE
    from torchft_tpu_torch.parallel import apply_hsdp, make_hsdp_mesh, shard_batch
    from torchft_tpu_torch.parallel.mesh import group_mean

    torch.set_num_threads(1)
    payload = torch.load(os.path.join(tmp, "payload.pt"))
    dist.init_process_group("gloo", init_method="env://")
    mesh = make_hsdp_mesh(device_type="cpu", **payload["layout"])
    cfg = dataclasses.replace(MOE_CONFIGS["debug"], capacity_factor=CAPACITY_FACTOR)
    model = MoE(cfg, device="cpu")
    model.load_state_dict(payload["init"])
    apply_hsdp(model, mesh)
    tokens, offset = shard_batch(payload["tokens"], mesh)
    targets, _ = shard_batch(payload["targets"], mesh)
    loss = model.loss(tokens, targets, offset=offset)
    loss.backward()
    ep = mesh["ep"]
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
        if ep.size() > 1 and name.rsplit(".", 1)[-1] in EXPERT_WEIGHTS:
            parts = [torch.empty_like(g) for _ in range(ep.size())]
            dist.all_gather(parts, g.contiguous(), group=ep.get_group())
            g = torch.cat(parts)
        grads[name] = g
    out = {"loss": float(group_mean(loss.detach())), "grads": grads,
           "dropped": float(model.last_dropped)}
    torch.save(out, os.path.join(tmp, f"out_{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ----------------------------------------------------------------- the tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from torchft_tpu.models import moe as jm  # noqa: E402
from torchft_tpu.parallel import mesh as jmesh  # noqa: E402
from torchft_tpu_torch import convert  # noqa: E402

B, S = 2, 16


def _inputs():
    cfg = dataclasses.replace(jm.MOE_CONFIGS["debug"], capacity_factor=CAPACITY_FACTOR)
    params = jax.tree_util.tree_map(np.asarray, jm.moe_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, params, tokens, targets


def _reference(layout: dict):
    """The reference's loss and gradients under its own mesh of ``layout``
    and unsharded, in the port's per-layer names."""
    cfg, params, tokens, targets = _inputs()
    grad_fn = jax.value_and_grad(lambda p, t, y: jm.moe_loss(p, t, y, cfg))
    out = []
    for mesh_layout in (layout, None):
        if mesh_layout is None:
            loss, grads = grad_fn(params, jnp.asarray(tokens), jnp.asarray(targets))
        else:
            mesh = jmesh.make_hsdp_mesh(dp=1, **mesh_layout)
            sharded = jmesh.shard_params(params, mesh, jm.moe_param_specs(cfg))
            tok = NamedSharding(mesh, P(("dp", "fsdp"), None))
            loss, grads = jax.jit(grad_fn)(sharded, jax.device_put(jnp.asarray(tokens), tok),
                                           jax.device_put(jnp.asarray(targets), tok))
        host = jax.tree_util.tree_map(np.asarray, grads)
        out.append((float(loss), {k: v.numpy()
                                  for k, v in convert.moe_params_from_jax(host).items()}))
    return out


LAYOUTS = [
    pytest.param(dict(ep=2), id="ep2"),
    pytest.param(dict(ep=2, tp=2), id="ep2_tp2"),
    pytest.param(dict(fsdp=2, ep=2), id="fsdp2_ep2"),
    # the reference's test_ep_matches_unsharded layout
    pytest.param(dict(ep=4, tp=2), id="ep4_tp2"),
]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_expert_parallel_loss_and_grads_match_the_reference(layout, tmp_path):
    from test_torch_parallel import spawn_world

    _, params, tokens, targets = _inputs()
    world = int(np.prod(list(layout.values())))
    outs = spawn_world(HERE, world, {
        "layout": layout, "init": convert.moe_params_from_jax(params),
        "tokens": torch.from_numpy(tokens).long(), "targets": torch.from_numpy(targets).long(),
    }, tmp_path)
    for ref_loss, ref_grads in _reference(layout):
        for out in outs:
            np.testing.assert_allclose(out["loss"], ref_loss, rtol=RTOL, atol=ATOL)
        grads = outs[0]["grads"]
        assert sorted(grads) == sorted(ref_grads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref_grads[name], rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    for out in outs:
        assert out["dropped"] > 0, "the experts must overflow"
        for name, g in out["grads"].items():
            assert torch.equal(g, outs[0]["grads"][name]), name


def test_moe_param_specs_are_the_reference_table():
    """Per parameter, the mesh axis each dim of the port's per-layer weight
    is sharded over is the reference's for the same dims of its stacked
    ``[L, ...]`` array."""
    from torch.distributed.tensor import Shard

    from torchft_tpu_torch.models.moe import moe_param_specs

    ref = jm.moe_param_specs(jm.MOE_CONFIGS["debug"])
    got = moe_param_specs()

    def axes(spec: dict, ndim: int) -> list:
        out = [None] * ndim
        for axis, placement in spec.items():
            if isinstance(placement, Shard):
                out[placement.dim] = axis
        return out

    for name in ("embed", "final_norm", "lm_head"):
        assert axes(got[name], len(ref[name])) == list(ref[name]), name
    for name, spec in ref["layers"].items():
        assert axes(got["layers"][name], len(spec) - 1) == list(spec)[1:], name
