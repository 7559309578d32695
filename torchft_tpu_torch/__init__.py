"""PyTorch/CUDA port of torchft_tpu: per-step fault tolerance for
data-parallel training on NVIDIA Hopper.

The JAX package ``torchft_tpu`` is the reference; this package mirrors its
module names so a reader can find each counterpart, and imports nothing of
it. What runs today (see ROADMAP.md for what is still to port):

- ``coordination``: ctypes binding to the repo's native C++ control plane
  (lighthouse, manager server, rendezvous store), built from ``native/``;
- ``manager.Manager``: per-step quorum, the managed allreduce (streamed
  in buckets by default, fp8-coded with error feedback when quantized;
  serial on request), two-phase commit and live heal over the
  ``checkpointing`` transports (HTTP, or ``PGTransport`` in place);
- ``process_group.ProcessGroupHost``: the host wire, with the raw-frame
  ring, the compressed self-healing ring and point-to-point sends;
  ``bucketing`` its buckets;
- ``ddp``, ``data`` and ``lighthouse`` (the lighthouse CLI);
- ``collectives.allreduce_quantized`` (the serial path) and the bucket
  codec, with the hand-written CUDA fp8 rowwise kernels in
  ``ops/csrc/fp8_rowwise.cu``;
- ``models.llama``: the Llama-3 family as an ``nn.Module``;
- ``train``: the fault-tolerant DDP trainer of Llama that ``chip_smoke.py``
  drives, and ``examples.train_ddp``: the counterpart of
  ``examples/train_ddp.py``, replica groups as processes.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
