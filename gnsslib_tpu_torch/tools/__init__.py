"""Measurement tools of the port (``python -m gnsslib_tpu_torch.tools.<name>``)."""
