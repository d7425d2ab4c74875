"""Command-line tools of the port (``python -m glsdet_tpu_torch.tools.<name>``)."""
