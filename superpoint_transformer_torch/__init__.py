"""PyTorch and CUDA port of superpoint_transformer_tpu (the JAX package
stays the reference). Module layout and names follow the JAX package."""
__version__ = '0.2.0'

from .utils.memory import tune_host_allocator as _tune_host_allocator
_tune_host_allocator()  # opt out with SPT_NO_MALLOC_TUNING=1

from .debug import set_debug, is_debug_enabled
