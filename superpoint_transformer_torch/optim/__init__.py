"""Optimizer and learning-rate schedules of the PyTorch port."""
