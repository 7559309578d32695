"""PyTorch/CUDA port of torchft_tpu: per-step fault tolerance for
data-parallel training on NVIDIA Hopper.

The JAX package ``torchft_tpu`` is the reference; this package mirrors its
module names so a reader can find each counterpart, and imports nothing of
it. What runs today (see ROADMAP.md for what is still to port):

- ``coordination``: ctypes binding to the repo's native C++ control plane
  (lighthouse, manager server, rendezvous store), built from ``native/``;
- ``manager.Manager``: per-step quorum (async, or synchronous with
  ``use_async_quorum=False``), the managed allreduce (streamed in buckets
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
- ``models.llama``: the Llama-3 family as an ``nn.Module``;
- ``train``: the fault-tolerant trainer of Llama that ``chip_smoke.py``
  drives, per-step DDP or semi-synchronous DiLoCo (``--diloco``), and
  ``examples.train_ddp`` / ``examples.train_diloco``: the counterparts of
  ``examples/train_ddp.py`` and ``examples/train_diloco.py``, replica
  groups as processes.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD

__all__ = ["DiLoCo", "LocalSGD"]
__version__ = "0.1.0"
