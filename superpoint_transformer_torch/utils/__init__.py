"""Synthetic batches and the JAX weight bridge."""
