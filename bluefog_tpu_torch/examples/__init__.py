"""Examples of the port (``python -m bluefog_tpu_torch.examples.<name>``)."""
