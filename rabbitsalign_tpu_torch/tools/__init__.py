"""Measurement tools of the port that run on the GPU (``python -m
rabbitsalign_tpu_torch.tools.<name>``)."""
