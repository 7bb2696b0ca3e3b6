"""PyTorch and CUDA port of superpoint_transformer_tpu (the JAX package
stays the reference). Module layout and names follow the JAX package."""
__version__ = '0.2.0'
