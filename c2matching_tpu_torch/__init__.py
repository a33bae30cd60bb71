"""PyTorch and CUDA port of c2matching_tpu for NVIDIA Hopper (H100).

The JAX package ``c2matching_tpu`` is the reference: every module here has
its counterpart at the same path there, and the tests hold the two against
each other. This package imports torch and numpy, never JAX.
"""
