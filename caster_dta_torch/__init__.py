"""PyTorch/CUDA port of caster_dta_tpu for one NVIDIA H100.

The JAX package ``caster_dta_tpu`` stays the reference. This package imports
``torch`` and numpy only, never JAX, flax, msgpack, pandas or anything of
``caster_dta_tpu``; it keeps its own copy of what it needs. The Pallas kernels
of the served and trained paths are hand-written CUDA for sm_90a
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/build.py``).
"""
