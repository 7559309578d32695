"""Example trainers of the port, each run as ``python -m
torchft_tpu_torch.examples.<name>``. Importing this package has no side
effects."""
