"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain-PyTorch
versions (``ref``) and the dispatching wrappers (``ops``)."""
