"""Training losses of the PyTorch port."""
