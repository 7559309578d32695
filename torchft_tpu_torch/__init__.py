"""PyTorch/CUDA port of torchft_tpu: per-step fault tolerance for
data-parallel training on NVIDIA Hopper.

The JAX package ``torchft_tpu`` is the reference; this package mirrors its
module names so a reader can find each counterpart, and imports nothing of
it. What runs today (see ROADMAP.md for what is still to port):

- ``coordination``: ctypes binding to the repo's native C++ control plane
  (lighthouse, manager server, rendezvous store), built from ``native/``;
- ``manager.Manager``: per-step quorum, the serial managed allreduce
  (optionally fp8-quantized), two-phase commit and live HTTP heal;
- ``collectives.allreduce_quantized`` with the hand-written CUDA fp8
  rowwise codec in ``ops/csrc/fp8_rowwise.cu``;
- ``models.llama``: the Llama-3 family as an ``nn.Module``;
- ``train``: the fault-tolerant DDP trainer that ``chip_smoke.py`` drives.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
