"""Command-line tools of the port (``python -m bluefog_tpu_torch.tools.<name>``)."""
