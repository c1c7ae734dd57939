"""Model zoo of the PyTorch port (swin + UPerNet family, mono modality)."""
