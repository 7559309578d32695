"""Cluster launch paths of the port (GKE manifests and slurm scripts) for
the Llama-3-8B FT-HSDP target: counterparts of ``examples/cluster/``."""
