"""Hand-written Hopper kernels of the port, one package per reference
kernel package: each holds the CUDA sources (``csrc/``), its library's
entry points (``build.py``, built by the shared :mod:`.build`), the wrapper
the program calls and its plain torch version."""
