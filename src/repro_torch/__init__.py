"""PyTorch + CUDA port of the HE^2 CKKS keyswitch path.

A second package beside the JAX reference (``src/repro``): the same
scheme on int64 torch tensors, with the four TPU kernels rewritten by
hand for Hopper (``csrc/``).  It imports nothing of the JAX package.
"""
