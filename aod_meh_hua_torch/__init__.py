"""PyTorch/CUDA port of aod_meh_hua_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference the port is held against;
this package imports nothing of it, nor jax.
"""

__version__ = "0.1.0"
