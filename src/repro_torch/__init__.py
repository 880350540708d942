"""repro_torch — the PyTorch / CUDA port of sGrapp butterfly approximation
in streaming graphs, for one NVIDIA H100.

It mirrors ``repro`` (the JAX package, which stays the reference) module for
module and never imports it or JAX.  Entry points take ``device=`` and run on
the card by default; on a host without one they raise unless the caller
asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
