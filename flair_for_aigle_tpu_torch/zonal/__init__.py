"""Zonal inference engine of the PyTorch port."""
