"""Command-line tools of the port, each run as ``python -m
mysticeti_tpu_torch.tools.<name>``."""
