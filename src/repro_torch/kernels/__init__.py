"""Hand-written Hopper kernels of the port, one package per reference
kernel package: each holds the CUDA sources (``csrc/``), their build and
loader, the wrapper the program calls and its plain torch version."""
