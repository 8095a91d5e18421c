"""Command-line entry points of the port (``python -m wtracker_tpu_torch.workflows.<name>``)."""
