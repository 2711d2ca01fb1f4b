"""PyTorch/CUDA port of the Clairvoyant serving stack.

A second package beside ``repro`` (the JAX reference, which stays as it
is).  It imports ``torch`` and never ``jax``, nor anything of ``repro``.
Its kernels are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` on first use.  Entry points run on the card unless the caller
passes ``device="cpu"``, which takes each kernel's plain PyTorch version.
"""
