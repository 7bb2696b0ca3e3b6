"""Metrics of the PyTorch port."""
