"""PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100: the serving
path and the sparse-SVM training path so far.  Imports neither JAX nor
any ``repro`` module; the JAX package is the reference the tests hold it
against."""
