"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions,
and the device-dispatching wrappers in ``ops``."""
