"""PyTorch/CUDA port of the serving path of :mod:`repro` for one NVIDIA
H100.  Imports neither JAX nor any ``repro`` module; the JAX package is
the reference the tests hold it against."""
