"""repro_torch: the BlockAMC solver in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `repro`, module for module (`core/`, `kernels/`,
`data/`, `serve/`).  It imports `torch` and `numpy`, never `jax` and
nothing of `repro`; the tests hold each module against its JAX
counterpart on the same inputs.  Entry points run on `cuda` unless the
caller passes `device="cpu"`; asking for `cuda` on a host without a card
raises, it never falls back to the CPU.
"""
__version__ = "0.1.0"
