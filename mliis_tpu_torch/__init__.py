"""PyTorch/CUDA port of `mliis_tpu` for one NVIDIA H100.

The JAX package `mliis_tpu` is the reference this package is held against
(tests/test_torch_*.py). This package imports neither JAX nor anything of
`mliis_tpu`; it keeps its own copies of what it needs.
"""
