"""Metrics of the PyTorch port."""
from .weighted_li import WeightedL1Error, WeightedL2Error
