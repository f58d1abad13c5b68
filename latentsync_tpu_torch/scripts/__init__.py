"""Command-line entry points of the port (``python -m latentsync_tpu_torch.scripts.<name>``)."""
