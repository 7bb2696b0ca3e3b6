"""Synthetic data, histograms and the JAX weight bridge."""
