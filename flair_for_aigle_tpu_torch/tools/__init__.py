"""Measurement tools of the PyTorch port (``python -m
flair_for_aigle_tpu_torch.tools.<name>``)."""
