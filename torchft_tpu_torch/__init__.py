"""PyTorch/CUDA port of torchft_tpu: per-step fault tolerance for
data-parallel training on NVIDIA Hopper.

The JAX package ``torchft_tpu`` is the reference; this package mirrors its
module names so a reader can find each counterpart, and imports nothing of
it. What runs today (see ROADMAP.md for what is still to port):

- ``coordination``: ctypes binding to the repo's native C++ control plane
  (lighthouse, manager server, rendezvous store), built from ``native/``;
- ``manager.Manager``: per-step quorum (async, or synchronous with
  ``use_async_quorum=False``) for replica groups of one rank or several
  (``group_rank``, ``group_world_size``, ``store_addr``), the managed
  allreduce (streamed in buckets
  by default, fp8-coded with error feedback when quantized; serial on
  request), two-phase commit and live heal over the ``checkpointing``
  transports (HTTP, or ``PGTransport`` in place);
- ``local_sgd``: ``LocalSGD`` and Streaming ``DiLoCo`` (exported here),
  on the synchronous quorum;
- ``process_group.ProcessGroupHost``: the host wire, with the raw-frame
  ring, the compressed self-healing ring and point-to-point sends;
  ``bucketing`` its buckets; ``ProcessGroupBabyHost`` runs it in a child
  process (``multiprocessing``, ``multiprocessing_dummy_context``);
- ``knobs``: the registry of every ``TORCHFT_*`` variable the port reads,
  with process-local overrides; ``doctor`` (``python -m
  torchft_tpu_torch.doctor``): the host's diagnostic;
- ``ddp``, ``data`` and ``lighthouse`` (the lighthouse CLI);
- ``checkpointing.DurableCheckpointer`` (exported here): durable (tier-2)
  checkpoints on ``torch.distributed.checkpoint``, for a whole-job outage;
- ``launcher`` (the supervising launcher of replica groups),
  ``aggregator`` (the pod aggregator's CLI: the two-level control plane)
  and ``examples.punisher`` (kills replicas through the lighthouse);
- ``collectives.allreduce_quantized`` (the serial path) and the bucket
  codec, with the hand-written CUDA fp8 rowwise kernels in
  ``ops/csrc/fp8_rowwise.cu``;
- ``models.llama``: the Llama-3 family as an ``nn.Module``; ``models.moe``:
  its Mixture-of-Experts variant (GShard top-k routing with capacity,
  expert parallelism over ``ep``); ``models.remat``: the rematerialization
  modes both share ("none", "dots", "attn", "full"), which name the
  attention output by the custom ops of ``ops.attention`` (exported here);
- ``parallel``: the parallelism inside a replica group (the HSDP mesh and
  its sharding by FSDP2 and tensor parallelism, ring and Ulysses
  attention over the sequence);
- ``serving``: the serving plane (a snapshot registry beside the
  lighthouse, publishers of versioned fp8 deltas on the commit path, coded
  on the card, and health-gated inference workers), and
  ``parameter_server``: a prototype parameter server on per-client
  sessions of the host process group;
- ``train``: the fault-tolerant trainer of Llama that ``chip_smoke.py``
  drives, per-step DDP or semi-synchronous DiLoCo (``--diloco``), and
  ``examples.train_ddp`` / ``examples.train_diloco`` /
  ``examples.train_llama_hsdp``: the counterparts of the reference's
  examples, replica groups as processes (HSDP: one process a rank).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# lazy exports, as the reference's package: `import torchft_tpu_torch` (and
# with it every CLI of the package) loads no torch until a name is touched
_EXPORTS = {
    "DiLoCo": "torchft_tpu_torch.local_sgd",
    "DurableCheckpointer": "torchft_tpu_torch.checkpointing.durable",
    "LocalSGD": "torchft_tpu_torch.local_sgd",
    "MoE": "torchft_tpu_torch.models.moe",
    "MoEConfig": "torchft_tpu_torch.models.moe",
    "MOE_CONFIGS": "torchft_tpu_torch.models.moe",
    "remat_wrap": "torchft_tpu_torch.models.remat",
    "ATTN_OUT_NAME": "torchft_tpu_torch.models.remat",
    "REMAT_MODES": "torchft_tpu_torch.models.remat",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'torchft_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
