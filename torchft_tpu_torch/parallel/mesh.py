"""Device mesh and sharding rules: the parallelism inside a replica group.

Counterpart of ``torchft_tpu/parallel/mesh.py``. The reference runs a
replica group as one process over a single-controller XLA SPMD mesh and
lets XLA insert the collectives; PyTorch runs one process per rank, so
here the same axes become a ``DeviceMesh`` over the group's ranks and the
same sharding table becomes DTensor placements, applied the way
torchtitan applies them: tensor-parallel placements first, then FSDP2's
``fully_shard`` per layer and at the root.

- axes, outermost first: ``dp`` (the replicated dim, which the Manager
  carries across replica groups; 1 inside a group), ``fsdp`` (ZeRO-3
  parameter sharding), ``ep`` (MoE experts; dense models never name it),
  ``sp`` (sequence parallelism: ring or Ulysses attention), ``tp``
  (Megatron tensor parallelism);
- parameters: column-parallel projections shard their output dim over
  ``tp``, row-parallel ones their input dim, and the other big dim rides
  ``fsdp``; with ``sp > 1`` FSDP shards over the flattened ``(fsdp, sp)``
  dims (torchtitan's ``dp_shard_cp``), so its reduce-scatter also sums
  the sequence shards' gradients;
- batch: rows over ``fsdp``, sequence over ``sp``; replicated over ``ep``;
- a parameter whose table entry names ``ep`` (the MoE's experts,
  ``models/moe.py:moe_param_specs``) keeps this rank's ``E / ep`` slice of
  its leading dim as a plain local tensor.

Each model carries its table (``param_specs()``) and learns the groups it
computes over (``set_parallel(mesh)``), so this module knows no model
family.

``shrink_mesh`` and ``degrade_axes`` (the degrade plane) are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

__all__ = [
    "AXES",
    "make_hsdp_mesh",
    "llama_param_specs",
    "apply_hsdp",
    "fsdp_mesh",
    "shard_batch",
    "make_train_step",
    "group_mean",
]

AXES = ("dp", "fsdp", "ep", "sp", "tp")


def make_hsdp_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A 5-axis mesh over the default process group's ranks (its world size
    must be the product of the degrees), axes in the reference's order."""
    return init_device_mesh(device_type, (dp, fsdp, ep, sp, tp), mesh_dim_names=AXES)


# per parameter, its placement over each mesh axis that shards it
_COLUMN = {"fsdp": Shard(0), "tp": Shard(1)}
_ROW = {"fsdp": Shard(1), "tp": Shard(0)}
_REPLICATED = {"fsdp": Replicate(), "tp": Replicate()}


def llama_param_specs(cfg: Any = None) -> Dict[str, Any]:
    """The reference's table (``llama_param_specs``) as DTensor placements,
    in the port's per-layer ``[in, out]`` layout: column-parallel
    ``wq``/``wk``/``wv``/``w_gate``/``w_up`` shard their output dim over
    ``tp`` and their input dim over ``fsdp``; row-parallel ``wo``/``w_down``
    the reverse; ``embed`` [V, D] and ``lm_head`` [D, V] shard dim 0 over
    ``fsdp`` and dim 1 over ``tp``; the norms are replicated."""
    del cfg  # the table is the same for every Llama config, as the reference's
    return {
        "embed": _COLUMN,
        "layers": {
            "attn_norm": _REPLICATED,
            "wq": _COLUMN,
            "wk": _COLUMN,
            "wv": _COLUMN,
            "wo": _ROW,
            "ffn_norm": _REPLICATED,
            "w_gate": _COLUMN,
            "w_up": _COLUMN,
            "w_down": _ROW,
        },
        "final_norm": _REPLICATED,
        "lm_head": _COLUMN,
    }


def _spec_of(specs: Dict[str, Any], name: str) -> Dict[str, Placement]:
    """``layers.{i}.wq`` -> the ``layers`` table's ``wq`` entry."""
    parts = name.split(".")
    return specs["layers"][parts[-1]] if parts[0] == "layers" else specs[name]


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh FSDP shards over: ``fsdp``, flattened with ``sp`` when the
    sequence is split."""
    if mesh["sp"].size() == 1:
        return mesh["fsdp"]
    return mesh["fsdp", "sp"]._flatten("fsdp_sp")


def apply_hsdp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard the port's ``Llama`` or ``MoE`` in place by its
    ``param_specs()``: with ``ep > 1`` each ``ep``-split weight keeps this
    rank's slice; with ``tp > 1`` every weight becomes a DTensor over
    ``tp`` and the model's layers join their shards over the tp group;
    ``model.set_parallel(mesh)`` tells the model the rest of its groups;
    then ``fully_shard`` each layer and the root over ``fsdp`` (and
    ``sp``), each weight on its ``fsdp`` dim. Every rank must hold the same
    full weights first. FSDP2 shards every parameter it manages, so the
    norms, replicated in the reference, ride its default ``Shard(0)``:
    where their bytes live changes, not what is computed. ``model.loss``
    runs under FSDP's hooks as ``forward`` does. FSDP's lazy init (which
    may move a padded shard) runs here, so every local shard's storage is
    final before a heal lands in it."""
    specs = model.param_specs()
    names = {}
    tp_mesh, ep_mesh = mesh["tp"], mesh["ep"]
    for name, param in list(model.named_parameters()):
        owner, attr = model, name
        if "." in name:
            path, attr = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        spec = _spec_of(specs, name)
        if ep_mesh.size() > 1 and "ep" in spec:
            mine = param.data.chunk(ep_mesh.size(), dim=0)[ep_mesh.get_local_rank()]
            param = nn.Parameter(mine.clone())
            setattr(owner, attr, param)
        if tp_mesh.size() > 1:
            param = nn.Parameter(distribute_tensor(param.data, tp_mesh, [spec["tp"]]))
            setattr(owner, attr, param)
        names[param] = name
    if tp_mesh.size() > 1:
        model.set_tp_group(tp_mesh.get_group())
    model.set_parallel(mesh)
    dp_mesh = fsdp_mesh(mesh)

    def placement(param: nn.Parameter):
        shard = _spec_of(specs, names[param])["fsdp"]
        return shard if isinstance(shard, Shard) else None

    for layer in model.layers:
        fully_shard(layer, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
    register_fsdp_forward_method(model, "loss")
    sharded = [*model.layers, model]
    for module in sharded:
        module.unshard()
    for module in sharded:
        module.reshard()
    return model


def shard_batch(tokens: torch.Tensor, mesh: DeviceMesh) -> Tuple[torch.Tensor, int]:
    """This rank's slice of the whole ``[B, S]`` batch (rows over ``fsdp``,
    the sequence over ``sp``: the reference's ``batch_sharding``) and its
    sequence offset, RoPE's first position."""
    fsdp, sp = mesh["fsdp"].size(), mesh["sp"].size()
    B, S = tokens.shape
    if B % fsdp or S % sp:
        raise ValueError(f"batch [{B}, {S}] does not split over fsdp={fsdp}, sp={sp}")
    b, s = B // fsdp, S // sp
    i, j = mesh.get_local_rank("fsdp"), mesh.get_local_rank("sp")
    return tokens[i * b:(i + 1) * b, j * s:(j + 1) * s], j * s


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: DeviceMesh) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The HSDP train step of a sharded model (``apply_hsdp``): ``step(tokens,
    targets)`` takes the whole batch, keeps this rank's slice, runs forward
    and backward (FSDP averages the gradients over ``fsdp`` and ``sp``) and
    the optimizer, and returns the loss averaged over the group. The layers
    run under the model's own ``remat`` mode, set where it is built (the
    reference's ``make_train_step(remat=...)`` takes it here instead)."""

    def step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        local_tokens, offset = shard_batch(tokens, mesh)
        local_targets, _ = shard_batch(targets, mesh)
        loss = model.loss(local_tokens, local_targets, offset=offset)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad()
        return group_mean(loss.detach())

    return step


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the default process group (the replica group)."""
    x = x.clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()
