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
  ``bucketing`` its buckets;
- ``ddp``, ``data`` and ``lighthouse`` (the lighthouse CLI);
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

from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.models.moe import MOE_CONFIGS, MoE, MoEConfig
from torchft_tpu_torch.models.remat import ATTN_OUT_NAME, REMAT_MODES, remat_wrap

__all__ = ["DiLoCo", "LocalSGD", "MoE", "MoEConfig", "MOE_CONFIGS", "remat_wrap", "ATTN_OUT_NAME",
           "REMAT_MODES"]
__version__ = "0.1.0"
