"""Command line of the port: ``python -m pilosa_tpu_torch.cli``."""
