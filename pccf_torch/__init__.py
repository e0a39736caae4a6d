"""PyTorch port of pccf for NVIDIA Hopper, held against the JAX package.

The port imports ``torch`` and never ``jax``.  Its hand-written CUDA kernels
live under ``csrc/`` and are built with ``nvcc`` at first use on a CUDA
tensor (:mod:`pccf_torch.kernels._build`); on CPU tensors every kernel
wrapper runs its plain PyTorch version.
"""
